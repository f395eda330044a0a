"""CLI surface tests: train -> transcribe -> evaluate -> featurize in-process
on a tiny corpus (the reference's recipe-script surface, SURVEY.md L6)."""

import json

import numpy as np
import pytest

from jiao_liao_asr import cli
from jiao_liao_asr.data import ManifestRow, write_manifest
from jiao_liao_asr.frontend.audio_io import write_wav
from jiao_liao_asr.utils.config import (
    ExperimentConfig,
    save_config,
)


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    rows = []
    for i in range(4):
        wav = (rng.randn(int(16000 * 1.2)) * 0.1).astype(np.float32)
        p = tmp / f"u{i}.wav"
        write_wav(p, wav, 16000)
        rows.append(ManifestRow(str(p), "你好世界", 1.2, "jiaoliao"))
    write_manifest(rows, tmp / "train.jsonl")
    save_config(ExperimentConfig(), str(tmp / "base.json"))
    return tmp


def _overrides(tmp):
    return [
        f"data.train_manifest={tmp}/train.jsonl",
        "data.batch_size=2",
        "data.bucket_boundaries_seconds=[2.0]",
        "data.min_audio_seconds=0.1",
        "frontend.chunk_seconds=2.0",
        "ctc_model.d_model=64",
        "ctc_model.num_layers=1",
        "ctc_model.num_heads=4",
        "ctc_model.mlp_dim=128",
        "ctc_model.conv_channels=32",
        "train.optimizer.total_steps=4",
        "train.optimizer.warmup_steps=1",
        "train.optimizer.learning_rate=1e-3",
        f"train.checkpoint_dir={tmp}/ckpt",
        "train.checkpoint_every_steps=4",
        "train.log_every_steps=2",
        f"train.metrics_path={tmp}/metrics.jsonl",
    ]


def test_cli_train_transcribe_evaluate_featurize(cli_env, capsys):
    tmp = cli_env
    rc = cli.main(["train", "--config", str(tmp / "base.json"), *_overrides(tmp)])
    assert rc == 0
    assert (tmp / "ckpt" / "final" / "config.json").exists()
    capsys.readouterr()

    rc = cli.main(["transcribe", str(tmp / "u0.wav"), "--checkpoint", str(tmp / "ckpt" / "final")])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(out)
    assert set(rec) == {"audio", "text"} and isinstance(rec["text"], str)

    rc = cli.main([
        "evaluate", "--manifest", str(tmp / "train.jsonl"),
        "--checkpoint", str(tmp / "ckpt" / "final"), "--batch-size", "4",
        "--decode", "beam", "--beam-size", "2",
    ])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= res["cer"] and res["utterances"] == 4

    # --per-utt: one error-analysis row per utterance, corpus CER consistent
    rc = cli.main([
        "evaluate", "--manifest", str(tmp / "train.jsonl"),
        "--checkpoint", str(tmp / "ckpt" / "final"), "--batch-size", "4",
        "--per-utt", str(tmp / "per_utt.jsonl"),
    ])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    per = [json.loads(l) for l in (tmp / "per_utt.jsonl").read_text().splitlines()]
    assert len(per) == 4 and res["per_utt"] == str(tmp / "per_utt.jsonl")
    assert all({"audio", "dialect", "ref", "hyp", "cer", "wer"} <= set(r) for r in per)
    if all(len(r["ref"]) for r in per):
        assert (res["cer"] == 0.0) == all(r["cer"] == 0.0 for r in per)

    rc = cli.main(["featurize", str(tmp / "u0.wav"), "--output", str(tmp / "f.npy")])
    assert rc == 0
    feats = np.load(tmp / "f.npy")
    assert feats.shape[1] == 80

    # --stream: per-hop partial lines then a final {"audio","text"} line,
    # whose text matches the offline greedy transcribe above
    capsys.readouterr()
    rc = cli.main([
        "transcribe", str(tmp / "u0.wav"),
        "--checkpoint", str(tmp / "ckpt" / "final"),
        "--stream", "--stream-window", "2.0", "--stream-hop", "0.32",
        # lookahead > utterance: every frame commits at finish(), whose
        # single full window is bit-exact vs the offline chunk
        "--stream-lookahead", "1.28",
    ])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) >= 2 and "partial" in lines[0]
    assert set(lines[-1]) == {"audio", "text"}
    assert lines[-1]["text"] == rec["text"]

    # --timestamps: per-token spans whose concatenation is the greedy text
    rc = cli.main([
        "transcribe", str(tmp / "u0.wav"),
        "--checkpoint", str(tmp / "ckpt" / "final"), "--timestamps",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["text"] == rec["text"]
    assert all(t["start"] < t["end"] for t in out["tokens"])

    # --caption srt: sidecar file next to the audio, cues carry the text
    rc = cli.main([
        "transcribe", str(tmp / "u0.wav"),
        "--checkpoint", str(tmp / "ckpt" / "final"), "--caption", "srt",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["caption"] == str(tmp / "u0.srt") and out["text"] == rec["text"]
    srt = (tmp / "u0.srt").read_text(encoding="utf-8")
    assert srt.startswith("1\n00:00:0") and "-->" in srt
    assert rec["text"].startswith(srt.splitlines()[2][:1])  # first cue text


def test_cli_evaluate_int8_whisper(cli_env, capsys, tmp_path):
    """evaluate --int8 quantizes the whisper serving tree and reports CER/WER
    through the full int8 decode path (weights + KV caches + logit table)."""
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import WhisperConfig

    tmp = cli_env
    cfg = ExperimentConfig(
        model_family="whisper",
        whisper=WhisperConfig(
            vocab_size=64, d_model=64, encoder_layers=1, decoder_layers=1,
            num_heads=2, mlp_dim=128, max_source_positions=64,
            max_target_positions=16,
        ),
    )
    cfg.frontend.chunk_seconds = 1.28
    params = ModelBundle._init_params(cfg)
    bundle = ModelBundle(
        config=cfg, params=params, tokenizer=CharTokenizer(list("你好世界"))
    )
    ckpt = tmp_path / "wq"
    bundle.save(str(ckpt))
    rc = cli.main([
        "evaluate", "--manifest", str(tmp / "train.jsonl"),
        "--checkpoint", str(ckpt), "--batch-size", "4", "--int8",
    ])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["utterances"] == 4 and res["cer"] >= 0.0
    # --int8 on the CTC family is a clean CLI error, not a traceback
    rc = cli.main([
        "evaluate", "--manifest", str(tmp / "train.jsonl"),
        "--checkpoint", str(tmp / "ckpt" / "final"), "--int8",
    ])
    assert rc == 2


def _tiny_whisper_ckpt(tmp_path):
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import WhisperConfig

    cfg = ExperimentConfig(
        model_family="whisper",
        whisper=WhisperConfig(
            vocab_size=64, d_model=64, encoder_layers=1, decoder_layers=1,
            num_heads=2, mlp_dim=128, max_source_positions=64,
            max_target_positions=16, prompt_ids=(1, 3), eot_id=2,
        ),
    )
    cfg.frontend.chunk_seconds = 1.28
    params = ModelBundle._init_params(cfg)
    bundle = ModelBundle(
        config=cfg, params=params,
        tokenizer=CharTokenizer([chr(0x4E00 + i) for i in range(62)]),
    )
    ckpt = tmp_path / "wsrv"
    bundle.save(str(ckpt))
    return bundle, ckpt


def test_cli_serve(cli_env, capsys, tmp_path, monkeypatch):
    """`serve` streams JSONL results in completion order through the
    continuous-batching engine and matches offline transcribe texts."""
    import io

    tmp = cli_env
    bundle, ckpt = _tiny_whisper_ckpt(tmp_path)
    wavs = [str(tmp / f"u{i}.wav") for i in range(4)]
    ref = dict(zip(wavs, bundle.transcribe(wavs)))

    rc = cli.main([
        "serve", *wavs[:2], "--checkpoint", str(ckpt),
        "--slots", "2", "--steps-per-dispatch", "4",
    ])
    assert rc == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {r["audio"] for r in recs} == set(wavs[:2])

    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(wavs[2:]) + "\n"))
    rc = cli.main([
        "serve", *wavs[:2], "--stdin", "--checkpoint", str(ckpt),
        "--slots", "2", "--steps-per-dispatch", "4",
    ])
    assert rc == 0
    recs = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert {r["audio"] for r in recs} == set(wavs)
    for r in recs:
        assert r["text"] == ref[r["audio"]]
        assert r["latency_s"] >= 0.0

    # --timestamps: results carry token + word spans matching the text
    rc = cli.main([
        "serve", wavs[0], "--checkpoint", str(ckpt),
        "--slots", "2", "--steps-per-dispatch", "4", "--timestamps",
    ])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert "".join(t["token"] for t in rec["tokens"]) == rec["text"]
    assert "".join(w["word"] for w in rec["words"]) == rec["text"]

    # CTC family -> clean CLI error
    rc = cli.main([
        "serve", wavs[0], "--checkpoint", str(tmp / "ckpt" / "final"),
    ])
    assert rc == 2
