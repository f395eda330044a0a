"""Polyphase FIR resampling on device.

Replacement for soxr (/root/reference/requirements.txt:70; SURVEY
N6). Implemented as a windowed-sinc polyphase filter expressed as a strided
convolution, so XLA lowers it onto one GEMM; scipy.signal.resample_poly is the
test oracle (same Kaiser-windowed sinc design).
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=32)
def _design_filter(up: int, down: int, window_beta: float = 5.0, half_width: int = 10):
    """Kaiser-windowed sinc low-pass for rational-rate conversion.

    Matches scipy.signal.resample_poly's default design (kaiser, beta=5,
    2*10*max(up,down)+1 taps, cutoff at min(1/up, 1/down) of Nyquist).
    """
    max_rate = max(up, down)
    f_c = 1.0 / max_rate  # normalized cutoff (relative to Nyquist of up-rate)
    half_len = half_width * max_rate
    t = np.arange(-half_len, half_len + 1, dtype=np.float64)
    h = f_c * np.sinc(f_c * t)
    h *= np.kaiser(2 * half_len + 1, window_beta)
    h *= up
    return h.astype(np.float32)


def resample(x: jnp.ndarray, orig_sr: int, target_sr: int) -> jnp.ndarray:
    """Resample 1-D (or [batch, time]) PCM from orig_sr to target_sr.

    Rational polyphase implementation: upsample by L (zero-stuffing folded
    into a gather-free conv), FIR low-pass, downsample by M.
    """
    if orig_sr == target_sr:
        return x
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    h = jnp.asarray(_design_filter(up, down))
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    y = _resample_poly(x, h, up, down)
    return y[0] if squeeze else y


def _resample_poly(x: jnp.ndarray, h: jnp.ndarray, up: int, down: int) -> jnp.ndarray:
    """[B, T] -> [B, ceil(T*up/down)] polyphase resampling.

    Decompose the FIR into `up` phases; each output sample n is
    y[n] = sum_k h_phase[n*down % up][k] * x[(n*down)//up - k + d0].
    Expressed as `up` strided convs batched into one conv with `up` output
    channels — a clean GEMM mapping.
    """
    n_taps = h.shape[0]
    # pad h to a multiple of up, centered like scipy (group delay = half)
    pad_to = -(-n_taps // up) * up
    h_pad = jnp.pad(h, (0, pad_to - n_taps))
    # polyphase decomposition: phase p takes taps h[p::up], time-reversed for conv
    hp = h_pad.reshape(-1, up).T  # [up, taps_per_phase]
    taps_pp = hp.shape[1]
    half = (n_taps - 1) // 2  # filter delay in up-rate samples

    B, T = x.shape
    out_len = -(-T * up // down)  # ceil

    # For output n: up-rate index m = n*down; phase = m % up; start = m // up.
    # x window needed: x[start - taps_pp + 1 : start + 1] convolved with
    # reversed phase taps, with the group-delay shift folded in.
    # Implement via conv_general_dilated with lhs dilation (zero-stuffing)
    # equivalent: gather x windows at stride pattern. Simpler & still
    # GEMM-friendly: dense frame-gather + matmul per phase group.
    m = jnp.arange(out_len) * down + half  # up-rate center index
    phase = m % up
    start = m // up  # index into x of the newest tap
    # frame indices [out_len, taps_pp]: x[start - k] for k in 0..taps_pp-1
    idx = start[:, None] - jnp.arange(taps_pp)[None, :]
    valid = (idx >= 0) & (idx < T)
    idx_c = jnp.clip(idx, 0, T - 1)
    frames = x[:, idx_c] * valid[None, :, :].astype(x.dtype)  # [B, out_len, taps]
    # per-output-phase taps: hp[phase] -> [out_len, taps]
    taps = hp[phase]  # gather rows
    y = jnp.einsum("bot,ot->bo", frames, taps, preferred_element_type=jnp.float32)
    return y.astype(x.dtype)
