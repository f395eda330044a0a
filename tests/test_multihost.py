"""Multi-host (multi-process) SPMD integration tests (SURVEY C19/§5.8).

The reference's distributed mode is multi-process DDP via `accelerate
launch` (/root/reference/requirements.txt:1,75). Here that is
multi-controller SPMD: here 2 subprocesses x 4 virtual CPU devices form one
8-device global mesh (gloo collectives), run the PRODUCTION train_loop with
per-process data sharding + checkpointing, and must reproduce the
1-process x 8-device loss trajectory exactly (same global batches, same
mesh partitioning).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_corpus(workdir: str, n: int = 16) -> None:
    from jiao_liao_asr.data import ManifestRow, write_manifest
    from jiao_liao_asr.frontend.audio_io import write_wav

    rng = np.random.RandomState(7)
    texts = ["你好世界", "胶辽官话", "语音识别测试", "多机并行"]
    rows = []
    for i in range(n):
        t = np.arange(int(16000 * 1.4)) / 16000.0
        wav = (
            0.3 * np.sin(2 * np.pi * (250 + 45 * i) * t)
            + 0.05 * rng.randn(len(t))
        ).astype(np.float32)
        path = os.path.join(workdir, f"u{i}.wav")
        write_wav(path, wav, 16000)
        rows.append(
            ManifestRow(audio=path, text=texts[i % 4], duration=1.4, dialect="jiaoliao")
        )
    write_manifest(rows, os.path.join(workdir, "train.jsonl"))


def _run(workdir: str, nproc: int, resume: bool = False) -> dict:
    import portpicker

    port = portpicker.pick_unused_port()
    args = [str(nproc)] + (["--resume"] if resume else [])
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, workdir, str(nproc), str(pid), str(port)]
            + (["--resume"] if resume else []),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=ROOT,
        )
        for pid in range(nproc)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out[-4000:]}"
        rec = json.loads(lines[-1][len("RESULT "):])
        results[rec["pid"]] = rec
    return results


def test_batch_iterator_local_slices_partition_global_batch(tmp_path):
    """Fast (no subprocesses): iterators constructed with explicit
    (process_index, process_count) must produce row slices that concatenate
    exactly to the single-process batch, with identical global iterator
    state."""
    from jiao_liao_asr.data.manifest import read_manifest
    from jiao_liao_asr.data.pipeline import BatchIterator
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.utils.config import DataConfig

    _make_corpus(str(tmp_path), n=12)
    manifest = read_manifest(os.path.join(str(tmp_path), "train.jsonl"))
    tok = CharTokenizer.build([r.text for r in manifest.rows])
    cfg = DataConfig(batch_size=4, bucket_boundaries_seconds=[2.0], max_text_len=8)

    whole = BatchIterator(manifest, tok, cfg, process_index=0, process_count=1)
    p0 = BatchIterator(manifest, tok, cfg, process_index=0, process_count=2)
    p1 = BatchIterator(manifest, tok, cfg, process_index=1, process_count=2)

    for _ in range(5):
        bw, b0, b1 = next(whole), next(p0), next(p1)
        assert bw.global_rows == b0.global_rows == b1.global_rows == 4
        assert len(b0.audio) == len(b1.audio) == 2
        np.testing.assert_array_equal(
            bw.audio, np.concatenate([b0.audio, b1.audio], axis=0)
        )
        np.testing.assert_array_equal(
            bw.labels, np.concatenate([b0.labels, b1.labels], axis=0)
        )
        assert bw.texts == b0.texts + b1.texts
        assert whole.state_dict() == p0.state_dict() == p1.state_dict()


def test_batch_iterator_rejects_indivisible_process_count(tmp_path):
    from jiao_liao_asr.data.manifest import read_manifest
    from jiao_liao_asr.data.pipeline import BatchIterator
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.utils.config import DataConfig

    _make_corpus(str(tmp_path), n=6)
    manifest = read_manifest(os.path.join(str(tmp_path), "train.jsonl"))
    tok = CharTokenizer.build([r.text for r in manifest.rows])
    cfg = DataConfig(batch_size=3, bucket_boundaries_seconds=[2.0], max_text_len=8)
    with pytest.raises(ValueError, match="divide"):
        BatchIterator(manifest, tok, cfg, process_index=0, process_count=2)


@pytest.mark.heavy
def test_two_process_matches_single_process(tmp_path):
    workdir = str(tmp_path)
    _make_corpus(workdir)

    single = _run(workdir, nproc=1)
    multi = _run(workdir, nproc=2)

    # identical global batches + identical 8-device mesh partitioning =>
    # the same loss trajectory (tolerance covers cross-process collective
    # reduction-order differences)
    np.testing.assert_allclose(
        multi[0]["losses"], single[0]["losses"], rtol=2e-4, atol=1e-6
    )
    # both processes agree on the final loss (replicated metrics)
    assert multi[1]["losses"][-1] == pytest.approx(multi[0]["losses"][-1], rel=2e-4)
    assert multi[0]["final_step"] == single[0]["final_step"] == 4

    # state gathered collectively, written with extra.json by the primary
    ckpt = os.path.join(workdir, "ckpt_np2", "00000004")
    assert os.path.exists(os.path.join(ckpt, "state.npz"))
    assert os.path.exists(os.path.join(ckpt, "extra.json"))

    # exact resume across the process boundary: 2 more steps from the
    # step-4 checkpoint in both topologies stay in lockstep
    single_r = _run(workdir, nproc=1, resume=True)
    multi_r = _run(workdir, nproc=2, resume=True)
    assert single_r[0]["final_step"] == multi_r[0]["final_step"] == 6
    np.testing.assert_allclose(
        multi_r[0]["losses"][-2:], single_r[0]["losses"][-2:], rtol=2e-4, atol=1e-6
    )
