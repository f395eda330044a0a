"""On-device waveform augmentation with jax.random.

Replacement for the reference's audiomentations /
torch-audiomentations / torch-pitch-shift / julius stack
(/root/reference/requirements.txt:7,30,76,77; SURVEY.md C4). All transforms
are shape-preserving and jit-compatible (static shapes, lax control flow)
so they run fused on device inside the training input pipeline:

* random gain (dB)
* additive Gaussian noise at a random SNR
* speed perturbation from a *static* discrete rate set (resample-based;
  static rates keep shapes compile-time constant, matching SB's 0.9/1.0/1.1)
* pitch shift = speed perturbation + length-preserving time stretch via
  phase-free granular overlap-add (cheap, augmentation-grade)
* low/high/band-pass filter augmentation (julius req:30 and
  audiomentations' filter transforms req:7): windowed-sinc FIR whose
  cutoff is a TRACED per-example random draw — the kernel taps are jnp
  functions of the cutoff, so one compiled program covers the whole cutoff
  range — applied as a single depthwise conv (batch rows = channel groups),
  which XLA maps straight onto one GEMM. (julius' own low-pass is the same
  windowed-sinc FIR; an IIR biquad would serialize over 480k samples in a
  lax.scan — a long sequential dependency chain.)
* standalone time stretch (audiomentations TimeStretch): static discrete
  rates, pitch preserved via the same granular OLA used by pitch_shift
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.config import AugmentConfig
from .resample import resample


def _with_prob(key, p: float, fn, x):
    kp, kf = jax.random.split(key)
    return jnp.where(jax.random.uniform(kp) < p, fn(kf, x), x)


def random_gain(key, wav: jnp.ndarray, lo_db: float, hi_db: float) -> jnp.ndarray:
    g_db = jax.random.uniform(key, (wav.shape[0], 1), minval=lo_db, maxval=hi_db)
    return wav * 10.0 ** (g_db / 20.0)


def add_noise_snr(key, wav: jnp.ndarray, lo_snr: float, hi_snr: float) -> jnp.ndarray:
    kn, ks = jax.random.split(key)
    snr = jax.random.uniform(ks, (wav.shape[0], 1), minval=lo_snr, maxval=hi_snr)
    sig_pow = jnp.mean(wav**2, axis=1, keepdims=True) + 1e-12
    noise_pow = sig_pow / 10.0 ** (snr / 10.0)
    noise = jax.random.normal(kn, wav.shape) * jnp.sqrt(noise_pow)
    return wav + noise


def speed_perturb(key, wav: jnp.ndarray, rates: Tuple[float, ...]) -> jnp.ndarray:
    """Pick one of the static rates per batch; resample and pad/trim back to
    the original length (keeps shapes static under jit)."""
    n = wav.shape[1]
    branches = []
    for r in rates:
        num, den = _rate_to_ratio(r)

        def _b(w, num=num, den=den):
            if num == den:
                return w
            y = resample(w, num, den)  # rate r = den/num length scale
            return _fix_len(y, n)

        branches.append(_b)
    idx = jax.random.randint(key, (), 0, len(rates))
    return jax.lax.switch(idx, branches, wav)


def _rate_to_ratio(rate: float, max_den: int = 100) -> Tuple[int, int]:
    from fractions import Fraction

    fr = Fraction(rate).limit_denominator(max_den)
    return fr.numerator, fr.denominator


def _fix_len(x: jnp.ndarray, n: int) -> jnp.ndarray:
    cur = x.shape[1]
    if cur >= n:
        return x[:, :n]
    return jnp.pad(x, ((0, 0), (0, n - cur)))


def _ola_stretch_to(y: jnp.ndarray, n: int, win: int = 512) -> jnp.ndarray:
    """Length-only granular time stretch [B, m] -> [B, n] (phase-free
    overlap-add, augmentation-grade). All indices are compile-time constants:
    output grains sit at hop win//2; analysis grains are read at the constant
    ratio that spreads the input evenly over the output."""
    import numpy as np

    m = y.shape[1]
    if m == n:
        return y
    hop = win // 2
    frames = max((n - win) // hop + 1, 1)
    a_hop = (m - win) / max(frames - 1, 1)
    a_start = np.minimum(
        np.round(np.arange(frames) * a_hop).astype(np.int64), max(m - win, 0)
    )
    gather_idx = (a_start[:, None] + np.arange(win)[None, :]).reshape(-1)  # [F*W]
    scatter_idx = (
        (np.arange(frames) * hop)[:, None] + np.arange(win)[None, :]
    ).reshape(-1)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win) / win))  # hann
    wflat = np.tile(w, frames).astype(np.float32)

    grains = y[:, gather_idx] * jnp.asarray(wflat)[None, :]
    out = jnp.zeros((y.shape[0], n), y.dtype).at[:, scatter_idx].add(grains)
    wsum = (
        jnp.zeros((n,), jnp.float32).at[jnp.asarray(scatter_idx)].add(jnp.asarray(wflat))
    )
    return out / jnp.maximum(wsum, 1e-3)[None, :]


def pitch_shift(key, wav: jnp.ndarray, lo: float, hi: float) -> jnp.ndarray:
    """Random pitch shift by a whole number of semitones in [lo, hi]
    (torch-pitch-shift equivalent, SURVEY C4): resample by 2^(s/12) — which
    shifts pitch AND speed — then granular-OLA time-stretch back to the
    original length so only pitch moves. Static semitone set keeps every
    branch shape compile-time constant."""
    import math

    n = wav.shape[1]
    shifts = [s for s in range(math.ceil(lo), math.floor(hi) + 1) if s != 0]
    if not shifts:
        return wav
    branches = []
    for s in shifts:
        num, den = _rate_to_ratio(2.0 ** (s / 12.0), max_den=64)

        def _b(w, num=num, den=den):
            y = resample(w, num, den)  # length n*den/num = n / rate
            return _ola_stretch_to(y, n)

        branches.append(_b)
    idx = jax.random.randint(key, (), 0, len(branches))
    return jax.lax.switch(idx, branches, wav)


# ---------------------------------------------------------------------------
# Filter augmentation (SURVEY C4: julius req:30, audiomentations req:7)
# ---------------------------------------------------------------------------


def lowpass_fir_taps(fc: jnp.ndarray, taps: int) -> jnp.ndarray:
    """Hann-windowed-sinc low-pass FIR taps for a TRACED normalized cutoff
    fc in (0, 0.5) cycles/sample, shape [..., taps]; unity DC gain. fc may
    carry a batch dimension ([B, 1] -> [B, taps])."""
    n = jnp.arange(taps, dtype=jnp.float32) - (taps - 1) / 2.0
    h = 2.0 * fc * jnp.sinc(2.0 * fc * n)
    w = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * jnp.arange(taps) / (taps - 1))
    h = h * w
    return h / jnp.sum(h, axis=-1, keepdims=True)


def highpass_fir_taps(fc: jnp.ndarray, taps: int) -> jnp.ndarray:
    """Spectral inversion of the low-pass: delta - lowpass (taps odd)."""
    h = -lowpass_fir_taps(fc, taps)
    center = jnp.zeros((taps,), jnp.float32).at[(taps - 1) // 2].set(1.0)
    return h + center


def bandpass_fir_taps(f_lo: jnp.ndarray, f_hi: jnp.ndarray, taps: int) -> jnp.ndarray:
    """Difference of sincs: lowpass(f_hi) - lowpass(f_lo) passes
    (f_lo, f_hi)."""
    return lowpass_fir_taps(f_hi, taps) - lowpass_fir_taps(f_lo, taps)


def depthwise_filter(wav: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Apply a per-example FIR: wav [B, L], kernels [B, K] -> [B, L]
    ('same' alignment). One grouped conv (batch rows as channel groups);
    kernels are symmetric-by-construction so XLA's cross-correlation is
    the convolution."""
    B, L = wav.shape
    K = kernels.shape[-1]
    y = jax.lax.conv_general_dilated(
        wav[None].astype(jnp.float32),
        kernels[:, None, :].astype(jnp.float32),
        window_strides=(1,),
        padding=[(K // 2, K - 1 - K // 2)],
        dimension_numbers=("NCW", "OIW", "NCW"),
        feature_group_count=B,
    )
    return y[0].astype(wav.dtype)


def random_lowpass(key, wav, hz_range: Tuple[float, float], sr: int, taps: int):
    fc = jax.random.uniform(
        key, (wav.shape[0], 1), minval=hz_range[0] / sr, maxval=hz_range[1] / sr
    )
    return depthwise_filter(wav, lowpass_fir_taps(fc, taps))


def random_highpass(key, wav, hz_range: Tuple[float, float], sr: int, taps: int):
    fc = jax.random.uniform(
        key, (wav.shape[0], 1), minval=hz_range[0] / sr, maxval=hz_range[1] / sr
    )
    return depthwise_filter(wav, highpass_fir_taps(fc, taps))


def random_bandpass(
    key, wav, lo_range: Tuple[float, float], hi_range: Tuple[float, float],
    sr: int, taps: int,
):
    klo, khi = jax.random.split(key)
    f_lo = jax.random.uniform(
        klo, (wav.shape[0], 1), minval=lo_range[0] / sr, maxval=lo_range[1] / sr
    )
    f_hi = jax.random.uniform(
        khi, (wav.shape[0], 1), minval=hi_range[0] / sr, maxval=hi_range[1] / sr
    )
    return depthwise_filter(wav, bandpass_fir_taps(f_lo, f_hi, taps))


def time_stretch(key, wav: jnp.ndarray, rates: Tuple[float, ...]) -> jnp.ndarray:
    """Standalone time stretch (audiomentations TimeStretch, SURVEY C4):
    pick one of the static rates per batch; granular-OLA stretch the content
    to length n/rate (pitch preserved — unlike speed_perturb) and pad/trim
    back to the static length."""
    n = wav.shape[1]
    branches = []
    for r in rates:

        def _b(w, r=float(r)):
            if abs(r - 1.0) < 1e-9:
                return w
            m = max(int(round(n / r)), 2)
            return _fix_len(_ola_stretch_to(w, m), n)

        branches.append(_b)
    idx = jax.random.randint(key, (), 0, len(branches))
    return jax.lax.switch(idx, branches, wav)


def augment_waveform(
    key: jax.Array,
    wav: jnp.ndarray,
    cfg: AugmentConfig,
    sample_rate: int = 16000,
) -> jnp.ndarray:
    """Apply the augmentation chain to [B, L] PCM. jit-safe; shape preserved."""
    if not cfg.enabled:
        return wav
    k1, k2, k3, k4, k5, k6, k7, k8 = jax.random.split(key, 8)
    wav = _with_prob(
        k1, cfg.probability, lambda k, x: random_gain(k, x, *cfg.gain_db), wav
    )
    wav = _with_prob(
        k2, cfg.probability, lambda k, x: add_noise_snr(k, x, *cfg.noise_snr_db), wav
    )
    if len(cfg.speed_rates) > 1:
        wav = _with_prob(
            k3, cfg.probability, lambda k, x: speed_perturb(k, x, cfg.speed_rates), wav
        )
    import math

    lo, hi = cfg.pitch_semitones
    if any(s != 0 for s in range(math.ceil(lo), math.floor(hi) + 1)):
        wav = _with_prob(
            k4, cfg.probability, lambda k, x: pitch_shift(k, x, lo, hi), wav
        )
    if cfg.lowpass_probability > 0:
        wav = _with_prob(
            k5, cfg.lowpass_probability,
            lambda k, x: random_lowpass(k, x, cfg.lowpass_hz, sample_rate, cfg.filter_taps),
            wav,
        )
    if cfg.highpass_probability > 0:
        wav = _with_prob(
            k6, cfg.highpass_probability,
            lambda k, x: random_highpass(k, x, cfg.highpass_hz, sample_rate, cfg.filter_taps),
            wav,
        )
    if cfg.bandpass_probability > 0:
        wav = _with_prob(
            k7, cfg.bandpass_probability,
            lambda k, x: random_bandpass(
                k, x, cfg.highpass_hz, cfg.lowpass_hz, sample_rate, cfg.filter_taps
            ),
            wav,
        )
    if len(cfg.time_stretch_rates) > 0:
        wav = _with_prob(
            k8, cfg.probability,
            lambda k, x: time_stretch(k, x, cfg.time_stretch_rates), wav,
        )
    return wav
