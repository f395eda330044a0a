"""utils/profiling.py (checkify sanitizer, nan-debug toggle, trace, memory
stats) and evals/rtfx.py (the RTFx harness behind BASELINE's >=200x target)
— the two aux modules that previously had no dedicated tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jiao_liao_asr.evals.rtfx import RTFxResult, measure_rtfx
from jiao_liao_asr.utils.profiling import (
    annotate,
    checked,
    device_memory_stats,
    enable_nan_debug,
    trace,
)


def test_checked_raises_on_division_by_zero():
    def bad(x):
        return x / jnp.zeros_like(x)

    with pytest.raises(Exception):
        checked(bad)(jnp.ones((4,)))


def test_checked_passes_through_clean_fn_and_exposes_raw_form():
    def good(x):
        return x * 2.0

    wrapped = checked(good)
    out = wrapped(jnp.ones((4,)))
    np.testing.assert_allclose(np.asarray(out), 2.0)
    err, out2 = wrapped.checkified(jnp.ones((4,)))
    np.testing.assert_allclose(np.asarray(out2), 2.0)


def test_checked_surfaces_nan_from_inside_jit():
    @jax.jit
    def nan_fn(x):
        return jnp.log(x)  # log(-1) -> NaN

    with pytest.raises(Exception):
        checked(nan_fn)(-jnp.ones((2,)))


def test_enable_nan_debug_toggles_and_restores():
    enable_nan_debug(True)
    assert jax.config.jax_debug_nans
    enable_nan_debug(False)
    assert not jax.config.jax_debug_nans


def test_trace_none_is_noop_and_annotate_nests():
    with trace(None):
        with annotate("featurize"):
            _ = jnp.sum(jnp.ones((4,)))


def test_trace_writes_profile_to_logdir(tmp_path):
    logdir = str(tmp_path / "xprof")
    with trace(logdir):
        _ = float(jnp.sum(jnp.ones((8, 8))))
    files = [
        os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs
    ]
    assert files, "jax.profiler trace wrote nothing"


def test_device_memory_stats_keys_every_device():
    stats = device_memory_stats()
    assert len(stats) == len(jax.devices())
    for v in stats.values():
        assert isinstance(v, dict)


def test_measure_rtfx_counts_audio_seconds_and_syncs():
    calls = []

    @jax.jit
    def infer(wav, lengths):
        return jnp.sum(wav, axis=1), lengths

    def spy_sync(out):
        calls.append(1)
        return int(np.asarray(out[1]).ravel()[0])

    res = measure_rtfx(
        infer, batch=2, chunk_seconds=0.05, iters=4, num_buffers=2,
        sync=spy_sync,
    )
    assert isinstance(res, RTFxResult)
    assert res.iters == 4
    assert res.audio_seconds_per_batch == pytest.approx(0.1)
    assert res.rtfx > 0
    # warm once per buffer + once per timed iteration
    assert len(calls) == 2 + 4
    j = res.to_json()
    assert j["metric"] == "rtfx" and j["unit"] == "audio_sec_per_sec_per_chip"
    assert j["value"] == pytest.approx(res.rtfx, abs=0.01)


def test_measure_rtfx_uses_distinct_buffers():
    seen = []

    def infer(wav, lengths):
        seen.append(np.asarray(wav).tobytes())
        return jnp.zeros((1,)), lengths

    measure_rtfx(infer, batch=1, chunk_seconds=0.01, iters=2, num_buffers=2,
                 sync=lambda out: 0)
    # the two warmed buffers must differ (anti-memoization contract)
    assert seen[0] != seen[1]
