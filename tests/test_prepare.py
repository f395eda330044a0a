"""Corpus preparation tests (SURVEY.md 3.5): TSV ingest, duration from WAV
headers, deterministic splits, full prep pipeline."""

import numpy as np

from jiao_liao_asr.data.prepare import (
    from_directory,
    from_transcript_table,
    prepare_corpus,
    split_manifest,
    wav_duration,
)
from jiao_liao_asr.data.manifest import Manifest, ManifestRow, read_manifest
from jiao_liao_asr.frontend.audio_io import write_wav


def _make_wavs(tmp_path, rng, n=10, secs=1.0):
    names = []
    for i in range(n):
        wav = (rng.randn(int(16000 * secs)) * 0.1).astype(np.float32)
        p = tmp_path / f"utt{i}.wav"
        write_wav(p, wav, 16000)
        names.append(p)
    return names


def test_wav_duration(tmp_path, rng):
    p = _make_wavs(tmp_path, rng, 1, secs=2.5)[0]
    assert abs(wav_duration(p) - 2.5) < 1e-3


def test_from_transcript_table(tmp_path, rng):
    paths = _make_wavs(tmp_path, rng, 3)
    table = tmp_path / "trans.tsv"
    table.write_text(
        "\n".join(f"{p.name}\t你好世界{i}" for i, p in enumerate(paths)),
        encoding="utf-8",
    )
    m = from_transcript_table(table, audio_root=tmp_path, dialect="jiaoliao")
    assert len(m) == 3
    assert m.rows[0].dialect == "jiaoliao"
    assert abs(m.rows[0].duration - 1.0) < 1e-3


def test_from_directory(tmp_path, rng):
    paths = _make_wavs(tmp_path, rng, 4)
    transcripts = {p.stem: f"文本{p.stem}" for p in paths[:3]}  # one missing
    m = from_directory(tmp_path, transcripts)
    assert len(m) == 3


def test_split_deterministic(tmp_path, rng):
    rows = [ManifestRow(f"a{i}.wav", "x", 1.0) for i in range(40)]
    m = Manifest(rows)
    t1, d1, s1 = split_manifest(m, 0.1, 0.1, seed=7)
    t2, d2, s2 = split_manifest(m, 0.1, 0.1, seed=7)
    assert [r.audio for r in d1] == [r.audio for r in d2]
    assert len(d1) == 4 and len(s1) == 4 and len(t1) == 32
    all_audio = {r.audio for r in t1.rows + d1.rows + s1.rows}
    assert len(all_audio) == 40  # partition, no overlap


def test_prepare_corpus_end_to_end(tmp_path, rng):
    paths = _make_wavs(tmp_path, rng, 12)
    table = tmp_path / "trans.tsv"
    table.write_text(
        "\n".join(f"{p.name}\t胶辽话{i}" for i, p in enumerate(paths)),
        encoding="utf-8",
    )
    outs = prepare_corpus(table, tmp_path / "manifests", audio_root=tmp_path,
                          dialect="jiaoliao", dev_fraction=0.1, test_fraction=0.1)
    train = read_manifest(outs["train"])
    dev = read_manifest(outs["dev"])
    test = read_manifest(outs["test"])
    assert len(train) + len(dev) + len(test) == 12
    assert all(r.dialect == "jiaoliao" for r in train.rows)


def test_prepare_cli_subcommand(tmp_path, rng):
    """`cli prepare` writes split manifests (+ global-CMVN stats with --cmvn)."""
    import json as _json
    from pathlib import Path

    from jiao_liao_asr.cli import main as cli_main
    from jiao_liao_asr.frontend.audio_io import write_wav

    table = tmp_path / "table.tsv"
    lines = []
    for i in range(10):
        wav = (rng.randn(16000) * 0.1).astype(np.float32)
        p = tmp_path / f"u{i}.wav"
        write_wav(p, wav, 16000)
        lines.append(f"u{i}.wav\t你好世界{i}")
    table.write_text("\n".join(lines), encoding="utf-8")

    out_dir = tmp_path / "out"
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([
            "prepare", str(table), "--out-dir", str(out_dir),
            "--audio-root", str(tmp_path), "--dialect", "jiaoliao",
            "--min-seconds", "0.1", "--cmvn",
        ])
    assert rc == 0
    result = _json.loads(buf.getvalue().strip().splitlines()[-1])
    for split in ("train", "dev", "test"):
        assert Path(result[split]).exists(), split
    stats = np.load(result["cmvn_stats"])
    assert stats["mean"].shape == (80,) and stats["std"].shape == (80,)
    assert (stats["std"] > 0).all()
