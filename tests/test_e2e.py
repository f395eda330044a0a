"""Integration tests (SURVEY.md §4.4): the BASELINE configs[0] minimum slice
(single WAV -> on-device log-mel -> transformer-CTC -> greedy decode -> text
-> CER vs fixture) plus overfit-and-transcribe, fine_tune() API smoke, and
the multi-dialect stage schedule."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr import api
from jiao_liao_asr.data import CharTokenizer, ManifestRow, write_manifest
from jiao_liao_asr.evals import cer
from jiao_liao_asr.frontend.audio_io import write_wav
from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.train.engine import (
    batch_to_device,
    build_train_setup,
    init_state,
)
from jiao_liao_asr.utils.config import (
    CTCModelConfig,
    DataConfig,
    DialectStage,
    ExperimentConfig,
    FrontendConfig,
    OptimizerConfig,
    SpecAugmentConfig,
    TrainConfig,
)

TEXT = "你好世界"


def _tiny_config(vocab_size):
    return ExperimentConfig(
        model_family="ctc",
        frontend=FrontendConfig(chunk_seconds=2.0),
        ctc_model=CTCModelConfig(
            vocab_size=vocab_size, d_model=64, num_layers=2, num_heads=4,
            mlp_dim=128, conv_channels=32, dtype="float32",
            dropout=0.0,
        ),
        specaugment=SpecAugmentConfig(enabled=False),
        data=DataConfig(
            batch_size=2, bucket_boundaries_seconds=(2.0,), max_text_len=16,
            min_audio_seconds=0.1,
        ),
    )


@pytest.fixture(scope="module")
def overfit_bundle():
    """Overfit a tiny model on one synthetic utterance; reused across tests."""
    rng = np.random.RandomState(0)
    wav = (rng.randn(int(16000 * 1.5)) * 0.1).astype(np.float32)
    t = np.arange(len(wav)) / 16000.0
    wav += 0.3 * np.sin(2 * np.pi * 300 * t) * (t < 0.5)
    wav += 0.3 * np.sin(2 * np.pi * 800 * t) * (t >= 0.7)
    wav = wav.astype(np.float32)

    tok = CharTokenizer.build([TEXT])
    cfg = _tiny_config(len(tok))
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=3e-3, warmup_steps=10, total_steps=220, schedule="constant"
    )
    params = ModelBundle._init_params(cfg)
    _, _, tx, step = build_train_setup(cfg, params)
    state = init_state(cfg, tx, params)
    labels = np.zeros((1, 16), np.int32)
    ids = tok.encode(TEXT)
    labels[0, : len(ids)] = ids
    samples = int(cfg.frontend.chunk_seconds * 16000)
    audio = np.zeros((1, samples), np.float32)
    audio[0, : len(wav)] = wav
    batch = {
        "audio": jnp.asarray(audio),
        "audio_lengths": jnp.asarray([len(wav)], dtype=np.int32),
        "labels": jnp.asarray(labels),
        "label_lengths": jnp.asarray([len(ids)], dtype=np.int32),
    }
    loss = None
    for _ in range(220):
        state, m = step(state, batch)
        loss = float(m["loss"])
    bundle = ModelBundle(config=cfg, params=state.params, tokenizer=tok)
    return bundle, wav, loss


def test_minimum_slice_overfit_decodes_fixture_text(overfit_bundle):
    bundle, wav, loss = overfit_bundle
    assert loss < 0.1, f"failed to overfit, loss={loss}"
    texts = bundle.transcribe(wav, sample_rate=16000)
    assert texts == [TEXT]
    assert cer(TEXT, texts[0]) == 0.0


def test_greedy_decode_deterministic(overfit_bundle):
    bundle, wav, _ = overfit_bundle
    t1 = bundle.transcribe(wav, sample_rate=16000)
    t2 = bundle.transcribe(wav, sample_rate=16000)
    assert t1 == t2


def test_api_transcribe_timestamps(overfit_bundle):
    bundle, wav, _ = overfit_bundle
    text = api.transcribe(bundle, wav, sample_rate=16000)[0]
    timed = api.transcribe(bundle, wav, sample_rate=16000, timestamps=True)[0]
    assert "".join(t["token"] for t in timed) == text


def test_beam_decode_matches_greedy_on_peaky(overfit_bundle):
    bundle, wav, _ = overfit_bundle
    beam_cfg = dataclasses.replace(bundle.config.decode, strategy="beam", beam_size=4)
    assert bundle.transcribe(wav, sample_rate=16000, decode_cfg=beam_cfg) == [TEXT]


def test_bundle_save_load_roundtrip(overfit_bundle, tmp_path):
    bundle, wav, _ = overfit_bundle
    bundle.save(str(tmp_path / "ck"))
    loaded = api.load(checkpoint=str(tmp_path / "ck"))
    assert loaded.transcribe(wav, sample_rate=16000) == [TEXT]


def test_fine_tune_api_smoke(tmp_path, rng):
    """api.fine_tune on a 4-utterance manifest: runs, loss finite, ckpt written."""
    rows = []
    for i in range(4):
        wav = (rng.randn(int(16000 * 1.2)) * 0.1).astype(np.float32)
        p = tmp_path / f"u{i}.wav"
        write_wav(p, wav, 16000)
        rows.append(ManifestRow(str(p), TEXT, 1.2, "jiaoliao"))
    mpath = tmp_path / "train.jsonl"
    write_manifest(rows, mpath)

    cfg = _tiny_config(16)  # vocab auto-resized by run_experiment
    cfg.data.train_manifest = str(mpath)
    cfg.train = TrainConfig(
        optimizer=OptimizerConfig(
            learning_rate=1e-3, warmup_steps=2, total_steps=6, schedule="constant"
        ),
        checkpoint_dir=str(tmp_path / "ckpt"),
        checkpoint_every_steps=3,
        log_every_steps=2,
        metrics_path=str(tmp_path / "metrics.jsonl"),
    )
    state, bundle = api.fine_tune(cfg)
    assert int(state.step) == 6
    assert (tmp_path / "ckpt" / "00000006").exists()
    assert (tmp_path / "metrics.jsonl").exists()
    out = bundle.transcribe(rows[0].audio)
    assert isinstance(out[0], str)


def test_multi_dialect_stages(tmp_path, rng):
    """Sequential neighbor->target transfer schedule (BASELINE configs[3])."""
    from jiao_liao_asr.train.schedules import run_stages

    manifests = {}
    for dialect, text in [("jilu", "北京话很好"), ("jiaoliao", TEXT)]:
        rows = []
        for i in range(2):
            wav = (rng.randn(int(16000 * 1.0)) * 0.1).astype(np.float32)
            p = tmp_path / f"{dialect}{i}.wav"
            write_wav(p, wav, 16000)
            rows.append(ManifestRow(str(p), text, 1.0, dialect))
        mp = tmp_path / f"{dialect}.jsonl"
        write_manifest(rows, mp)
        manifests[dialect] = str(mp)

    cfg = _tiny_config(16)
    cfg.ctc_model = dataclasses.replace(
        cfg.ctc_model,
        adapter=dataclasses.replace(cfg.ctc_model.adapter, kind="wf", wf_rank=2),
    )
    cfg.stages = (
        DialectStage(name="neighbor", manifests=(manifests["jilu"],), steps=2,
                     train_adapters_only=False),
        DialectStage(name="target", manifests=(manifests["jiaoliao"],), steps=2,
                     train_adapters_only=True),
    )
    params, tok, history = run_stages(cfg)
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)


def test_long_form_chunked_transcription(overfit_bundle):
    """Recordings longer than chunk_seconds split into chunks and re-join."""
    bundle, wav, _ = overfit_bundle
    chunk = int(bundle.config.frontend.chunk_seconds * 16000)
    long_wav = np.concatenate([wav, np.zeros(chunk - len(wav), np.float32), wav])
    texts = bundle.transcribe(long_wav, sample_rate=16000)
    # chunk 0 carries trailing silence the overfit model never saw, which can
    # emit a few stray chars — the contract under test is that exactly two
    # chunks were decoded and re-joined IN ORDER: the transcript contains the
    # fixture text twice, with at most the silence-region strays in between
    assert texts[0].count(TEXT) == 2, texts
    assert len(texts[0]) <= 2 * len(TEXT) + 4, texts
    assert texts[0].startswith(TEXT) and texts[0].endswith(TEXT)


def test_eval_during_training(tmp_path, rng):
    """eval_manifest wired: metrics.jsonl gains eval_cer/eval_wer records."""
    import json

    rows = []
    for i in range(2):
        wav = (rng.randn(int(16000 * 1.2)) * 0.1).astype(np.float32)
        p = tmp_path / f"e{i}.wav"
        write_wav(p, wav, 16000)
        rows.append(ManifestRow(str(p), TEXT, 1.2, "jiaoliao"))
    mpath = tmp_path / "data.jsonl"
    write_manifest(rows, mpath)

    cfg = _tiny_config(16)
    cfg.data.train_manifest = str(mpath)
    cfg.data.eval_manifest = str(mpath)
    cfg.train = TrainConfig(
        optimizer=OptimizerConfig(
            learning_rate=1e-3, warmup_steps=1, total_steps=4, schedule="constant"
        ),
        checkpoint_dir=str(tmp_path / "ck"),
        checkpoint_every_steps=4,
        log_every_steps=2,
        eval_every_steps=2,
        metrics_path=str(tmp_path / "m.jsonl"),
    )
    api.fine_tune(cfg)
    recs = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert any("eval_cer" in r for r in recs)


def test_collect_audio_mixed_sample_rates(tmp_path):
    """Each input carries its own rate: a 16 kHz file, an 8 kHz file, and a
    raw array must each be resampled individually to fe.sample_rate."""
    from jiao_liao_asr.frontend.audio_io import write_wav

    rng = np.random.RandomState(0)
    a16 = (rng.randn(16000) * 0.1).astype(np.float32)  # 1 s @ 16 kHz
    a8 = (rng.randn(8000) * 0.1).astype(np.float32)  # 1 s @ 8 kHz
    p16, p8 = tmp_path / "a16.wav", tmp_path / "a8.wav"
    write_wav(p16, a16, 16000)
    write_wav(p8, a8, 8000)
    bundle = ModelBundle.load(config=_tiny_config(8))
    out, sr = bundle._collect_audio([str(p16), str(p8), a16], None)
    assert sr == 16000
    # 16 kHz inputs untouched; the 8 kHz file upsampled 2x to ~1 s @ 16 kHz
    assert abs(len(out[0]) - 16000) <= 1
    assert abs(len(out[1]) - 16000) <= 32  # polyphase edge padding tolerance
    assert abs(len(out[2]) - 16000) <= 1
    # order preserved: file order matches output order even with mixed rates
    assert np.allclose(out[0][:100], a16[:100], atol=2e-4)
