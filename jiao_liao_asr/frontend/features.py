"""GEMM-native log-mel spectrogram, bit-compatible with the reference's
WhisperFeatureExtractor semantics.

Reference pipeline (SURVEY.md C3, verified against the pinned transformers
WhisperFeatureExtractor): pad/trim to 30 s -> STFT (n_fft=400, hop=160,
periodic Hann, centered reflect padding) -> power spectrum -> slaney mel
filterbank (80 or 128 mels, fmax 8 kHz) -> log10 with 1e-10 floor -> clamp to
(max - 8) -> (x + 4) / 4.

Design: the STFT is *not* an FFT — it is a dense DFT matmul with the Hann
window folded into the basis, i.e. a single strided conv
[B, 1, L] * [2*(n_fft/2+1), 1, n_fft] that XLA lowers to one GEMM-shaped
convolution (the MelT pattern, PAPERS.md). For n_fft=400 the dense DFT costs
~2x an FFT's flops. All frontend math is float32 at HIGHEST precision
(parity hard-part #1, SURVEY §7); whether cuFFT beats it on the GPU is an
open measurement (ROADMAP.md).

"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import FrontendConfig

# ---------------------------------------------------------------------------
# Mel filterbank (slaney scale + slaney area-normalization, librosa-compatible)
# ---------------------------------------------------------------------------


def _hz_to_mel(f: np.ndarray, scale: str) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # f=0 hits the unused log branch
        return np.where(
            f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels
        )


def _mel_to_hz(m: np.ndarray, scale: str) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=16)
def mel_filterbank(
    num_mels: int = 80,
    n_fft: int = 400,
    sample_rate: int = 16000,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    scale: str = "slaney",
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank [num_mels, n_fft//2 + 1] (float32).

    Matches librosa.filters.mel / transformers.audio_utils.mel_filter_bank
    for the Whisper configuration (slaney scale, slaney norm, fmax=8000).
    """
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale), num_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# Windowed DFT basis (GEMM-native STFT)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _dft_basis(n_fft: int) -> np.ndarray:
    """[2 * (n_fft//2+1), n_fft] stacked (cos; sin) basis with the periodic
    Hann window folded in. Power spectrum = (x@cos.T)^2 + (x@sin.T)^2."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic hann
    k = np.arange(n_freqs, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * window[None, :]
    return basis.astype(np.float32)


def stft_power(wav: jnp.ndarray, n_fft: int, hop_length: int) -> jnp.ndarray:
    """Centered power STFT of [B, L] -> [B, n_freqs, 1 + L//hop].

    Reflect-pads by n_fft//2 on both sides (torch/librosa `center=True`),
    then computes the windowed DFT as one strided convolution.
    """
    basis = jnp.asarray(_dft_basis(n_fft))  # [2F, n_fft]
    pad = n_fft // 2
    x = jnp.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    # [B, 1, L+2p] conv [2F, 1, n_fft] stride hop -> [B, 2F, T]
    y = jax.lax.conv_general_dilated(
        x[:, None, :].astype(jnp.float32),
        basis[:, None, :],
        window_strides=(hop_length,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # full f32 passes: the default (bf16-grade) precision loses ~1e-2
        # absolute in near-cancelling DFT bins, which shows up as 0.3 log10
        # units after the log — outside text-parity tolerance (SURVEY §7.1).
        precision=jax.lax.Precision.HIGHEST,
    )
    n_freqs = n_fft // 2 + 1
    return y[:, :n_freqs, :] ** 2 + y[:, n_freqs:, :] ** 2


def log_mel_spectrogram(
    wav: jnp.ndarray,
    cfg: Optional[FrontendConfig] = None,
    *,
    per_example_max: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """[B, L] float32 PCM -> [B, num_mels, L//hop] Whisper-normalized log-mel.

    Drops the final STFT frame (Whisper convention), applies log10 with a
    1e-10 floor, clamps to (per-utterance max - 8), then maps to (x+4)/4.
    """
    cfg = cfg or FrontendConfig()
    if wav.ndim == 1:
        wav = wav[None, :]
    power = stft_power(wav, cfg.n_fft, cfg.hop_length)[:, :, :-1]  # drop last frame
    mel = jnp.asarray(
        mel_filterbank(cfg.num_mels, cfg.n_fft, cfg.sample_rate, scale=cfg.mel_scale)
    )
    mel_spec = jnp.einsum(
        "mf,bft->bmt",
        mel,
        power,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    log_spec = jnp.log10(jnp.maximum(mel_spec, cfg.log_floor))
    if cfg.whisper_norm:
        mx = (
            per_example_max
            if per_example_max is not None
            else jnp.max(log_spec, axis=(1, 2), keepdims=True)
        )
        log_spec = jnp.maximum(log_spec, mx - 8.0)
        log_spec = (log_spec + 4.0) / 4.0
    if cfg.cmvn == "utterance":
        mean = jnp.mean(log_spec, axis=2, keepdims=True)
        std = jnp.std(log_spec, axis=2, keepdims=True)
        log_spec = (log_spec - mean) / (std + 1e-8)
    return log_spec


def log_mel_reference(wav: np.ndarray, cfg: Optional[FrontendConfig] = None) -> np.ndarray:
    """Plain numpy float64 reference of log_mel_spectrogram (np.fft.rfft
    over reflect-padded periodic-Hann frames): [B, L] -> [B, mels, L//hop].
    Whisper normalization only (no cmvn)."""
    cfg = cfg or FrontendConfig()
    wav = np.atleast_2d(np.asarray(wav, np.float64))
    pad = cfg.n_fft // 2
    x = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = 1 + (x.shape[1] - cfg.n_fft) // cfg.hop_length
    idx = np.arange(cfg.n_fft)[None, :] + cfg.hop_length * np.arange(n_frames)[:, None]
    n = np.arange(cfg.n_fft)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / cfg.n_fft))
    spec = np.fft.rfft(x[:, idx] * window, axis=-1)  # [B, T, F]
    power = (np.abs(spec) ** 2)[:, :-1, :]  # drop last frame
    mel = mel_filterbank(cfg.num_mels, cfg.n_fft, cfg.sample_rate, scale=cfg.mel_scale)
    log_spec = np.log10(np.maximum(np.einsum("mf,btf->bmt", mel, power), cfg.log_floor))
    if cfg.whisper_norm:
        log_spec = np.maximum(log_spec, log_spec.max(axis=(1, 2), keepdims=True) - 8.0)
        log_spec = (log_spec + 4.0) / 4.0
    return log_spec


def fbank(
    wav: jnp.ndarray,
    cfg: Optional[FrontendConfig] = None,
) -> jnp.ndarray:
    """SpeechBrain-style log-mel fbank (SURVEY.md C3, SB `Fbank` path):
    optional preemphasis -> centered power STFT -> mel -> natural log with
    floor -> optional utterance CMVN. Used by the transformer-CTC recipe
    family; the Whisper path uses log_mel_spectrogram instead."""
    cfg = cfg or FrontendConfig(whisper_norm=False, cmvn="utterance", preemphasis=0.97)
    if wav.ndim == 1:
        wav = wav[None, :]
    x = wav.astype(jnp.float32)
    if cfg.preemphasis > 0:
        x = jnp.concatenate(
            [x[:, :1], x[:, 1:] - cfg.preemphasis * x[:, :-1]], axis=1
        )
    power = stft_power(x, cfg.n_fft, cfg.hop_length)[:, :, :-1]
    mel = jnp.asarray(
        mel_filterbank(cfg.num_mels, cfg.n_fft, cfg.sample_rate, scale=cfg.mel_scale)
    )
    mel_spec = jnp.einsum(
        "mf,bft->bmt",
        mel,
        power,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    log_spec = jnp.log(jnp.maximum(mel_spec, cfg.log_floor))
    if cfg.cmvn == "utterance":
        mean = jnp.mean(log_spec, axis=2, keepdims=True)
        std = jnp.std(log_spec, axis=2, keepdims=True)
        log_spec = (log_spec - mean) / (std + 1e-8)
    return log_spec


def pad_or_trim(wav: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Host-side pad/trim of 1-D PCM to the fixed 30 s chunk (Whisper
    receptive field, SURVEY §5.7)."""
    target = int(cfg.chunk_seconds * cfg.sample_rate)
    if len(wav) >= target:
        return np.asarray(wav[:target], dtype=np.float32)
    out = np.zeros(target, dtype=np.float32)
    out[: len(wav)] = wav
    return out


@partial(
    jax.jit,
    static_argnames=(
        "n_fft",
        "hop_length",
        "num_mels",
        "mel_scale",
        "whisper_norm",
        "cmvn",
    ),
)
def _featurize_jit(
    wav: jnp.ndarray,
    n_fft: int,
    hop_length: int,
    num_mels: int,
    mel_scale: str,
    whisper_norm: bool,
    cmvn: str,
) -> jnp.ndarray:
    cfg = FrontendConfig(
        n_fft=n_fft,
        hop_length=hop_length,
        num_mels=num_mels,
        mel_scale=mel_scale,
        whisper_norm=whisper_norm,
        cmvn=cmvn,
    )
    return log_mel_spectrogram(wav, cfg)


@lru_cache(maxsize=8)
def _cmvn_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    from .cmvn import load_cmvn

    return load_cmvn(path)


def dequantize_pcm(wav: jnp.ndarray) -> jnp.ndarray:
    """int16 wire-format audio (DataConfig.transfer_dtype='int16') -> float32
    in [-1, 1). Division by 2^15 is exact, so this matches the host decoder's
    i/32768 bit-for-bit; float input passes through untouched."""
    if wav.dtype == jnp.int16:
        return wav.astype(jnp.float32) * (1.0 / 32768.0)
    return wav


def featurize_batch(wav: jnp.ndarray, cfg: Optional[FrontendConfig] = None) -> jnp.ndarray:
    """Featurize a padded batch [B, chunk_samples] -> [B, mels, frames].

    The jit boundary for the on-device frontend. Accepts float32 PCM or
    int16 wire-format audio (dequantized on device). cmvn="global" applies
    corpus stats from cfg.cmvn_stats_path (a trace-time constant, so this
    stays jit-safe) and fails loudly when the stats are missing.
    """
    cfg = cfg or FrontendConfig()
    wav = dequantize_pcm(wav)
    if cfg.cmvn not in ("none", "utterance", "global"):
        raise ValueError(f"unknown cmvn mode {cfg.cmvn!r}")
    feats = _featurize_jit(
        wav,
        cfg.n_fft,
        cfg.hop_length,
        cfg.num_mels,
        cfg.mel_scale,
        cfg.whisper_norm,
        "utterance" if cfg.cmvn == "utterance" else "none",
    )
    if cfg.cmvn == "global":
        if not cfg.cmvn_stats_path:
            raise ValueError(
                "cmvn='global' needs frontend.cmvn_stats_path — compute stats "
                "with `cli prepare --cmvn` or frontend.cmvn.compute_corpus_cmvn"
            )
        from .cmvn import apply_global_cmvn

        mean, std = _cmvn_stats(cfg.cmvn_stats_path)
        feats = apply_global_cmvn(feats, mean, std)
    return feats
