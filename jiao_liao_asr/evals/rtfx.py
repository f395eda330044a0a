"""RTFx benchmark harness: audio-seconds transcribed per wall-clock second.

The throughput eval behind BASELINE's >=200x real-time target (BASELINE.md;
the reference publishes no throughput numbers). Methodology:

* distinct input buffers every timed iteration
* every buffer warmed once before timing (compilation stays out of the
  timed window)
* a hard host sync (tiny scalar readback) each iteration
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class RTFxResult:
    rtfx: float
    seconds_per_batch: float
    audio_seconds_per_batch: float
    iters: int

    def to_json(self) -> dict:
        return {
            "metric": "rtfx",
            "value": round(self.rtfx, 2),
            "unit": "audio_sec_per_sec_per_chip",
            "seconds_per_batch": round(self.seconds_per_batch, 5),
        }


def measure_rtfx(
    infer: Callable,  # (wav [B, L], lengths [B]) -> pytree with a small leaf
    batch: int,
    chunk_seconds: float,
    sample_rate: int = 16000,
    iters: int = 10,
    num_buffers: int = 2,
    seed: int = 0,
    sync: Optional[Callable] = None,
) -> RTFxResult:
    import jax.numpy as jnp

    samples = int(chunk_seconds * sample_rate)
    rng = np.random.RandomState(seed)
    base = rng.randn(batch, samples).astype(np.float32) * 0.1
    wavs = [jnp.asarray(np.roll(base, i + 1, axis=0) + 1e-4 * (i + 1)) for i in range(num_buffers)]
    lengths = jnp.full((batch,), samples, jnp.int32)
    sync = sync or (lambda out: int(np.asarray(_first_leaf(out)).ravel()[0]))

    for w in wavs:  # compile + per-buffer warm
        sync(infer(w, lengths))

    t0 = time.perf_counter()
    for i in range(iters):
        sync(infer(wavs[i % num_buffers], lengths))
    dt = time.perf_counter() - t0

    audio = chunk_seconds * batch
    return RTFxResult(
        rtfx=audio * iters / dt,
        seconds_per_batch=dt / iters,
        audio_seconds_per_batch=audio,
        iters=iters,
    )


def _first_leaf(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)[0]
