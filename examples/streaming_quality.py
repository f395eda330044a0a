"""Measure streaming transcription's text-accuracy cost on the chip — and
the fix: streaming-matched training.

serve/streaming.py commits a frame once it has `lookahead_seconds` of right
context; inside a window the encoder is bidirectional, so whether early
commits match the offline decode depends on how far the MODEL reaches for
context. This script measures both sides of that coin end to end:

1. synthesize a 24-utterance corpus with LOCAL acoustics (each char is a
   0.35 s tone segment — the structure real speech has; a corpus whose
   labels are only decodable from global position would make any
   limited-context decode impossible by construction);
2. train TWO small flagship CTC models on it with `cli train`:
     * "offline":  the defaults — full bidirectional attention,
                   absolute sinusoidal positions;
     * "matched":  attention banded to (left 12, right 6) encoder frames +
                   position_mode=none (shift-invariant) — the
                   streaming-matched recipe
                   (CTCModelConfig.attention_*_context/position_mode);
3. evaluate each offline (cli evaluate, greedy) and streamed
   (window 1.92 s < utterances, hop 0.32 s, lookahead swept) — reporting
   corpus CER and exact-match rate vs each model's own offline texts.

Expected shape of the result (pinned bit-exactly at random init by
tests/test_limited_context.py): the matched model streams identically to
its offline decode once lookahead covers its right context; the offline
model loses accuracy streamed because its training never bounded its
context.

Usage: python examples/streaming_quality.py [--workdir /tmp/jl_sq3] [--steps 2000]
(--assert: exit 1 unless the matched model's streamed text is bit-exact
vs its own offline decode at every lookahead — re-checks the published
streaming-matched exactness claim.)
"""

import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sh(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(args, capture_output=True, text=True, env=env, cwd=_REPO)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} failed:\n{r.stderr[-2000:]}")
    return r.stdout


def main():
    from jiao_liao_asr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    workdir, steps = "/tmp/jl_sq3", 2000
    for i, a in enumerate(sys.argv):
        if a == "--workdir" and i + 1 < len(sys.argv):
            workdir = sys.argv[i + 1]
        if a == "--steps" and i + 1 < len(sys.argv):
            steps = int(sys.argv[i + 1])

    import numpy as np

    from jiao_liao_asr.data import ManifestRow, write_manifest
    from jiao_liao_asr.frontend.audio_io import write_wav

    os.makedirs(workdir, exist_ok=True)
    manifest = os.path.join(workdir, "train.jsonl")
    rng = np.random.RandomState(42)
    chars = list("的一是在不了有大人上中国我他这为来")
    seg_s, sr = 0.35, 16000
    wavs, refs, rows = [], [], []
    for i in range(24):
        n_chars = rng.randint(5, 9)
        idxs = rng.randint(0, len(chars), size=n_chars)
        pieces = []
        for c in idxs:
            t = np.arange(int(seg_s * sr)) / sr
            f0 = 200.0 + 60.0 * c
            pieces.append(
                0.3 * np.sin(2 * np.pi * f0 * t)
                + 0.1 * np.sin(2 * np.pi * 2 * f0 * t)
            )
        wav = np.concatenate(pieces) + 0.03 * rng.randn(
            int(seg_s * sr) * n_chars
        )
        wav = wav.astype(np.float32)
        text = "".join(chars[c] for c in idxs)
        path = os.path.join(workdir, f"u{i}.wav")
        write_wav(path, wav, sr)
        rows.append(ManifestRow(audio=path, text=text,
                                duration=len(wav) / sr, dialect="syn"))
        wavs.append(wav)
        refs.append(text)
    write_manifest(rows, manifest)

    cli = [sys.executable, "-m", "jiao_liao_asr.cli"]
    common = cli + [
        "train", "--config", "configs/adapter_finetune.json",
        f"data.train_manifest={manifest}",
        "data.batch_size=8", "data.bucket_boundaries_seconds=[3.2]",
        "frontend.chunk_seconds=3.2", "frontend.whisper_norm=false",
        "ctc_model.d_model=128", "ctc_model.num_layers=2",
        "ctc_model.num_heads=4", "ctc_model.mlp_dim=256",
        "ctc_model.conv_channels=64", "ctc_model.adapter.kind=none", "ctc_model.dropout=0.0",
        "train.train_adapters_only=false",
        f"train.optimizer.total_steps={steps}",
        "train.optimizer.learning_rate=3e-3", "train.optimizer.warmup_steps=50",
    ]
    variants = {
        "offline": [],
        "matched": [
            "ctc_model.attention_left_context=12",
            "ctc_model.attention_right_context=6",
            "ctc_model.position_mode=none",
        ],
    }
    def _trained_to_completion(metrics_path):
        # Trust a cached checkpoint only if its training run reached the
        # requested step count uninterrupted — a SIGTERM checkpoint-and-exit
        # also writes `final`, and a 10-step model would make every streamed
        # comparison trivially (and meaninglessly) exact.
        try:
            last = {}
            with open(metrics_path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec.get("event") == "sigterm_checkpoint_and_exit":
                        return False
                    last = rec
            return last.get("step", 0) >= steps
        except OSError:
            return False

    for name, extra in variants.items():
        ckpt = os.path.join(workdir, f"ckpt_{name}")
        metrics = os.path.join(workdir, name + ".jsonl")
        done = os.path.isdir(os.path.join(ckpt, "final")) and _trained_to_completion(metrics)
        if not done:
            # an interrupted run would otherwise resume (train_loop restores
            # from checkpoint_dir) with a stale metrics trail — start clean
            for p in (ckpt, metrics):
                if os.path.isdir(p):
                    shutil.rmtree(p)
                elif os.path.isfile(p):
                    os.remove(p)
            print(f"training '{name}' ({steps} steps) ...", flush=True)
            sh(common + extra + [
                f"train.checkpoint_dir={ckpt}",
                f"train.metrics_path={metrics}",
            ])

    from jiao_liao_asr.api import load
    from jiao_liao_asr.evals import corpus_cer
    from jiao_liao_asr.serve.streaming import (
        StreamingConfig,
        StreamingTranscriber,
    )

    results = {}
    hop = int(0.32 * sr)
    for name in variants:
        bundle = load(checkpoint=os.path.join(workdir, f"ckpt_{name}", "final"))
        offline_texts = bundle.transcribe(wavs)
        off_cer = corpus_cer(refs, offline_texts)
        results[f"{name}_offline_cer"] = off_cer
        print(f"[{name}] offline greedy CER {off_cer:.4f}", flush=True)
        for look in (0.32, 0.64):
            sc = StreamingConfig(window_seconds=1.92, hop_seconds=0.32,
                                 lookahead_seconds=look)
            streamed = []
            for wav in wavs:
                st = StreamingTranscriber(bundle, sc)
                for s in range(0, len(wav), hop):
                    st.feed(wav[s : s + hop])
                streamed.append(st.finish().text)
            cer = corpus_cer(refs, streamed)
            match = float(
                np.mean([a == b for a, b in zip(streamed, offline_texts)])
            )
            results[f"{name}_look{look}"] = {"cer": cer, "offline_match": match}
            print(
                f"[{name}] streamed window 1.92s lookahead {look}s: "
                f"CER {cer:.4f}  exact-match vs own offline {match:.2f}",
                flush=True,
            )
    print(json.dumps(results))
    if "--assert" in sys.argv:
        bad = [
            k for k, v in results.items()
            if k.startswith("matched_look") and v["offline_match"] < 1.0
        ]
        if bad:
            print(f"ASSERT FAILED: streaming-matched model not bit-exact: {bad}")
            raise SystemExit(1)
        print("ASSERT OK: streaming-matched model streams == its offline text")


if __name__ == "__main__":
    main()
