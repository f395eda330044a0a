"""Continuous batching vs static batches on the card.

The reference serves offline batches through transformers generate()
(SURVEY.md 3.2): every wave waits for its LONGEST utterance before the
next wave starts, so ragged transcript lengths burn decoder steps as
padding. serve/engine.py refills finished lanes mid-flight instead. This
script measures both on the same workload and model:

1. reuse examples/int8_quality.py's overfit checkpoint (--workdir,
   default /tmp/w8q; trains it if absent) — its transcripts are 4-8 chars,
   so decode lengths genuinely vary and lanes free up at different times;
2. build N requests cycling the 24 corpus wavs with per-request noise
   (distinct device buffers);
3. STATIC: transcribe in waves of `slots` through ModelBundle.transcribe
   (the reference's serving shape), timed end to end;
4. CONTINUOUS: the same N requests through ServingEngine(slots), timed,
   plus per-request latency stats the static path cannot even define
   (a static wave's latency is the wave's, not the utterance's).

Both paths are warmed (compile excluded) and hard-synced by consuming the
returned texts. Run: python examples/serve_bench.py [--n 64] [--slots 8]
[--steps-per-dispatch 8] [--int8]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from jiao_liao_asr.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    workdir, n_req, slots, spd = "/tmp/w8q", 64, 8, 8
    int8 = "--int8" in sys.argv
    for i, a in enumerate(sys.argv):
        if a == "--workdir" and i + 1 < len(sys.argv):
            workdir = sys.argv[i + 1]
        if a == "--n" and i + 1 < len(sys.argv):
            n_req = int(sys.argv[i + 1])
        if a == "--slots" and i + 1 < len(sys.argv):
            slots = int(sys.argv[i + 1])
        if a == "--steps-per-dispatch" and i + 1 < len(sys.argv):
            spd = int(sys.argv[i + 1])

    ckpt = os.path.join(workdir, "ckpt", "final")
    if not os.path.isdir(ckpt):
        print("no overfit checkpoint; building one via int8_quality ...")
        import subprocess

        subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(__file__), "int8_quality.py"),
             "--workdir", workdir],
            check=True,
        )

    from jiao_liao_asr.frontend.audio_io import read_audio
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.serve import ServingEngine

    bundle = ModelBundle.load(ckpt)
    if int8:
        bundle = bundle.quantize()
    rng = np.random.RandomState(0)
    base = [read_audio(os.path.join(workdir, f"u{i}.wav"))[0] for i in range(24)]
    reqs = [
        base[i % 24] + rng.randn(len(base[i % 24])).astype(np.float32) * 1e-4
        for i in range(n_req)
    ]

    # ---- static waves (the reference's serving shape) ----
    waves = [reqs[i : i + slots] for i in range(0, n_req, slots)]
    _ = bundle.transcribe(waves[0])  # warm the B=slots program
    t0 = time.time()
    static_texts, static_lat = [], []
    for w in waves:
        static_texts.extend(bundle.transcribe(w))
        # every request in the wave completes when the WAVE completes, and
        # all N were submitted at t0 — that is the utterance's latency
        static_lat.extend([time.time() - t0] * len(w))
    static_s = time.time() - t0

    # ---- continuous batching ----
    eng = ServingEngine(bundle, slots=slots, steps_per_dispatch=spd)
    _ = eng.transcribe(reqs[:slots])  # warm encode/admit/decode programs
    eng.stats.__init__()
    t0 = time.time()
    cont_texts = eng.transcribe(reqs)
    cont_s = time.time() - t0

    mism = sum(a != b for a, b in zip(static_texts, cont_texts))
    s = eng.stats

    # decoder-capacity utilization: true decode steps / lane-steps the
    # hardware actually ran. Static lanes burn max(wave) steps each (the
    # whole wave waits for its longest decode); continuous lanes idle at
    # most one dispatch before refill; throughput scales with it where
    # the decoder, not dispatch latency, is the bound.
    P = len(eng.prompt)
    true_steps = [len(t) + P + 1 for t in cont_texts]  # +1 for the EOT
    static_cap = sum(
        max(true_steps[i : i + slots]) * len(true_steps[i : i + slots])
        for i in range(0, n_req, slots)
    )
    cont_cap = s.dispatches * spd * slots
    print(
        f"N={n_req} slots={slots} spd={spd} int8={int8}\n"
        f"static waves: {static_s:.2f}s  ({n_req/static_s:.2f} utt/s)  "
        f"latency mean {np.mean(static_lat):.3f}s "
        f"p95 {np.percentile(static_lat, 95):.3f}s\n"
        f"continuous:   {cont_s:.2f}s  ({n_req/cont_s:.2f} utt/s)  "
        f"latency mean {s.mean_latency_s:.3f}s p95 {s.p95_latency_s:.3f}s\n"
        f"throughput ratio {static_s/cont_s:.2f}x  dispatches {s.dispatches}  "
        f"text mismatches {mism}/{n_req}\n"
        f"decoder utilization: static {sum(true_steps)/static_cap:.2f} "
        f"continuous {sum(true_steps)/cont_cap:.2f} "
        f"(true steps {sum(true_steps)}, static lane-steps {static_cap}, "
        f"continuous lane-steps {cont_cap})"
    )


if __name__ == "__main__":
    main()
