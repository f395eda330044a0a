"""Tracing / profiling and numeric-debug subsystems.

Reference analogue (SURVEY.md §5.1-2): wandb system-metric sampling only —
no torch-profiler pin, no sanitizers. Replacements:

* ``trace(logdir)`` — jax.profiler context: writes an xprof trace viewable
  in TensorBoard/XProf; wired to the CLI via ``--profile``.
* ``annotate(name)`` — jax.profiler.TraceAnnotation for labeling pipeline
  stages (featurize / forward / decode) inside a trace.
* ``checked(fn)`` — jax.checkify wrapper that surfaces NaNs, out-of-bounds
  indexing, and div-by-zero from inside jitted code; the test-suite's
  "sanitizer mode" (single-controller JAX needs no TSAN analogue).
* ``enable_nan_debug()`` — global jax_debug_nans toggle for bisection runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed block to `logdir` (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a region inside an active trace: `with annotate('featurize'):`"""
    return jax.profiler.TraceAnnotation(name)


def checked(fn: Callable, *, errors=None) -> Callable:
    """Wrap a jittable fn with checkify: returns (err, out); raises on error
    when called through ``checked(fn).throw`` style below."""
    from jax.experimental import checkify

    errs = errors if errors is not None else (
        checkify.float_checks | checkify.index_checks | checkify.div_checks
    )
    cfn = checkify.checkify(fn, errors=errs)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    wrapper.checkified = cfn  # access to the raw (err, out) form
    return wrapper


def enable_nan_debug(enable: bool = True) -> None:
    jax.config.update("jax_debug_nans", enable)


def device_memory_stats() -> dict:
    """Per-device live-buffer stats (the wandb-system-metrics analogue)."""
    out = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
            out[str(d)] = {
                "bytes_in_use": s.get("bytes_in_use"),
                "peak_bytes_in_use": s.get("peak_bytes_in_use"),
                "bytes_limit": s.get("bytes_limit"),
            }
        except Exception:
            out[str(d)] = {}
    return out
