"""SB-style fbank, global CMVN, augmentation chain, RTFx harness,
profiling utilities."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.frontend.augment import augment_waveform
from jiao_liao_asr.frontend.cmvn import (
    GlobalCMVN,
    apply_global_cmvn,
    load_cmvn,
)
from jiao_liao_asr.frontend.features import fbank
from jiao_liao_asr.utils.config import AugmentConfig, FrontendConfig


def test_fbank_shapes_and_cmvn():
    cfg = FrontendConfig(whisper_norm=False, cmvn="utterance", preemphasis=0.97)
    wav = jnp.asarray(np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1)
    out = np.asarray(fbank(wav, cfg))
    assert out.shape == (2, 80, 100)
    # utterance CMVN: per-mel mean ~0, std ~1
    assert np.abs(out.mean(axis=2)).max() < 1e-4
    assert np.abs(out.std(axis=2) - 1.0).max() < 1e-2


def test_fbank_preemphasis_changes_spectrum():
    wav = jnp.asarray(np.random.RandomState(0).randn(1, 16000).astype(np.float32) * 0.1)
    a = np.asarray(fbank(wav, FrontendConfig(whisper_norm=False, cmvn="none", preemphasis=0.0)))
    b = np.asarray(fbank(wav, FrontendConfig(whisper_norm=False, cmvn="none", preemphasis=0.97)))
    assert np.abs(a - b).max() > 0.1  # low freqs attenuated


def test_global_cmvn_roundtrip(tmp_path, rng):
    acc = GlobalCMVN(4)
    feats = rng.randn(3, 4, 50).astype(np.float32) * 2.0 + 1.0
    lengths = np.array([50, 30, 10])
    acc.update(feats, lengths)
    mean, std = acc.finalize()
    # oracle over valid frames
    valid = np.concatenate([feats[b, :, : lengths[b]] for b in range(3)], axis=1)
    assert np.abs(mean - valid.mean(axis=1)).max() < 1e-5
    assert np.abs(std - valid.std(axis=1)).max() < 1e-4

    acc.save(tmp_path / "cmvn.npz")
    m2, s2 = load_cmvn(tmp_path / "cmvn.npz")
    assert np.allclose(m2, mean) and np.allclose(s2, std)

    normed = np.asarray(apply_global_cmvn(jnp.asarray(feats), m2, s2))
    nv = np.concatenate([normed[b, :, : lengths[b]] for b in range(3)], axis=1)
    assert np.abs(nv.mean(axis=1)).max() < 1e-4


def test_augment_chain_shapes_and_determinism():
    cfg = AugmentConfig(enabled=True, probability=1.0)
    wav = jnp.asarray(np.random.RandomState(0).randn(2, 8000).astype(np.float32) * 0.1)
    k = jax.random.PRNGKey(0)
    a = augment_waveform(k, wav, cfg)
    b = augment_waveform(k, wav, cfg)
    assert a.shape == wav.shape
    assert np.allclose(np.asarray(a), np.asarray(b))  # same key, same output
    c = augment_waveform(jax.random.PRNGKey(1), wav, cfg)
    assert not np.allclose(np.asarray(a), np.asarray(c))
    assert np.isfinite(np.asarray(a)).all()


def test_augment_jit_compatible():
    cfg = AugmentConfig(enabled=True, probability=0.5)
    wav = jnp.zeros((1, 8000), jnp.float32)
    f = jax.jit(lambda k, w: augment_waveform(k, w, cfg))
    out = f(jax.random.PRNGKey(0), wav)
    assert out.shape == wav.shape


def test_rtfx_harness():
    from jiao_liao_asr.evals.rtfx import measure_rtfx

    def infer(wav, lengths):
        return jnp.sum(wav, axis=1).astype(jnp.int32)

    res = measure_rtfx(infer, batch=2, chunk_seconds=1.0, iters=3, num_buffers=2)
    assert res.rtfx > 0
    assert res.to_json()["metric"] == "rtfx"


def test_checked_catches_nan():
    from jiao_liao_asr.utils.profiling import checked

    def bad(x):
        return jnp.log(x)  # nan for negative

    f = checked(bad)
    assert np.isfinite(float(f(jnp.asarray(2.0))))
    with pytest.raises(Exception):
        f(jnp.asarray(-1.0))


def test_pitch_shift_changes_pitch_preserves_shape():
    """pitch_semitones is consumed: a pure tone shifted +2 semitones moves
    its dominant frequency by ~2^(2/12) while keeping length/duration."""
    from jiao_liao_asr.frontend.augment import pitch_shift

    sr, n = 16000, 16000
    t = np.arange(n) / sr
    wav = jnp.asarray(np.sin(2 * np.pi * 440.0 * t, dtype=np.float32)[None])
    # lo=hi band around +2 -> the only branch is +2 semitones
    out = pitch_shift(jax.random.PRNGKey(0), wav, 1.5, 2.5)
    assert out.shape == wav.shape
    spec = np.abs(np.fft.rfft(np.asarray(out)[0, 2000:14000]))
    freqs = np.fft.rfftfreq(12000, 1 / sr)
    peak = freqs[np.argmax(spec)]
    expect = 440.0 * 2 ** (2 / 12)  # ~493.9 Hz
    assert abs(peak - expect) < 15.0, peak


def test_augment_consumes_pitch_config():
    cfg = AugmentConfig(enabled=True, probability=1.0,
                        gain_db=(0.0, 0.0), noise_snr_db=(100.0, 100.0),
                        speed_rates=(1.0,), pitch_semitones=(2.0, 2.0))
    # degenerate range (lo==hi, no integer in open set) -> config validated:
    # with lo=hi=2 the integer set is {2}, so pitch DOES apply
    rng = np.random.RandomState(0)
    wav = jnp.asarray(rng.randn(2, 8000).astype(np.float32))
    out = augment_waveform(jax.random.PRNGKey(1), wav, cfg)
    assert out.shape == wav.shape
    assert np.abs(np.asarray(out) - np.asarray(wav)).max() > 1e-3


def test_global_cmvn_wired_into_featurize(tmp_path, rng):
    """cmvn='global' loads stats from cmvn_stats_path and applies them;
    a missing path fails loudly instead of silently no-oping."""
    from jiao_liao_asr.frontend.features import featurize_batch

    wav = jnp.asarray(rng.randn(2, 32000).astype(np.float32) * 0.1)
    base_cfg = FrontendConfig(chunk_seconds=2.0, cmvn="none")
    feats = featurize_batch(wav, base_cfg)

    acc = GlobalCMVN(base_cfg.num_mels)
    acc.update(np.asarray(feats))
    stats = tmp_path / "cmvn.npz"
    acc.save(stats)

    cfg = FrontendConfig(chunk_seconds=2.0, cmvn="global", cmvn_stats_path=str(stats))
    got = featurize_batch(wav, cfg)
    mean, std = load_cmvn(stats)
    want = apply_global_cmvn(feats, mean, std)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() < 1e-5
    # corpus-mean ~0 per mel bin after normalization
    assert np.abs(np.asarray(got).mean(axis=(0, 2))).max() < 1e-3

    with pytest.raises(ValueError, match="cmvn_stats_path"):
        featurize_batch(wav, FrontendConfig(chunk_seconds=2.0, cmvn="global"))
    with pytest.raises(ValueError, match="unknown cmvn"):
        featurize_batch(wav, FrontendConfig(chunk_seconds=2.0, cmvn="banana"))


# ---------------------------------------------------------------------------
# Filter augmentation (SURVEY C4: julius req:30 / audiomentations req:7)
# ---------------------------------------------------------------------------


def _gain_at(wav_out, wav_in, freq, sr=16000):
    """Amplitude ratio at `freq` between output and input tones."""
    n = wav_in.shape[-1]
    w = np.hanning(n)
    f = np.fft.rfftfreq(n, 1 / sr)
    i = np.argmin(np.abs(f - freq))
    a_in = np.abs(np.fft.rfft(np.asarray(wav_in)[0] * w))[i]
    a_out = np.abs(np.fft.rfft(np.asarray(wav_out)[0] * w))[i]
    return a_out / max(a_in, 1e-12)


def test_lowpass_fir_frequency_response():
    """random_lowpass with a pinned cutoff: passband unity, stopband
    attenuated (windowed-sinc property, julius-equivalent)."""
    from jiao_liao_asr.frontend.augment import random_lowpass

    sr, n = 16000, 8192
    t = np.arange(n) / sr
    low = np.sin(2 * np.pi * 500.0 * t).astype(np.float32)
    high = np.sin(2 * np.pi * 5000.0 * t).astype(np.float32)
    wav = jnp.asarray((low + high)[None])
    out = random_lowpass(jax.random.PRNGKey(0), wav, (2000.0, 2000.0), sr, 101)
    assert out.shape == wav.shape
    assert _gain_at(out, jnp.asarray(low[None]), 500.0, sr) > 0.9
    assert _gain_at(out, jnp.asarray(high[None]), 5000.0, sr) < 0.05


def test_highpass_fir_frequency_response():
    from jiao_liao_asr.frontend.augment import random_highpass

    sr, n = 16000, 8192
    t = np.arange(n) / sr
    low = np.sin(2 * np.pi * 100.0 * t).astype(np.float32)
    high = np.sin(2 * np.pi * 3000.0 * t).astype(np.float32)
    wav = jnp.asarray((low + high)[None])
    out = random_highpass(jax.random.PRNGKey(0), wav, (400.0, 400.0), sr, 101)
    assert _gain_at(out, jnp.asarray(high[None]), 3000.0, sr) > 0.9
    assert _gain_at(out, jnp.asarray(low[None]), 100.0, sr) < 0.2


def test_bandpass_fir_frequency_response():
    from jiao_liao_asr.frontend.augment import random_bandpass

    sr, n = 16000, 8192
    t = np.arange(n) / sr
    mid = np.sin(2 * np.pi * 1500.0 * t).astype(np.float32)
    low = np.sin(2 * np.pi * 80.0 * t).astype(np.float32)
    high = np.sin(2 * np.pi * 6000.0 * t).astype(np.float32)
    wav = jnp.asarray((low + mid + high)[None])
    out = random_bandpass(
        jax.random.PRNGKey(0), wav, (400.0, 400.0), (3000.0, 3000.0), sr, 101
    )
    assert _gain_at(out, jnp.asarray(mid[None]), 1500.0, sr) > 0.85
    assert _gain_at(out, jnp.asarray(low[None]), 80.0, sr) < 0.2
    assert _gain_at(out, jnp.asarray(high[None]), 6000.0, sr) < 0.1


def test_filter_augment_per_example_cutoffs_and_jit():
    """Per-example cutoffs: with a wide range, two batch rows of the same
    tone get different attenuation; whole transform jits."""
    from jiao_liao_asr.frontend.augment import random_lowpass

    sr, n = 16000, 4096
    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * 4000.0 * t).astype(np.float32)
    wav = jnp.asarray(np.stack([tone, tone]))
    out = jax.jit(
        lambda k, x: random_lowpass(k, x, (1000.0, 7000.0), sr, 101)
    )(jax.random.PRNGKey(3), wav)
    e0 = float(jnp.sum(out[0] ** 2))
    e1 = float(jnp.sum(out[1] ** 2))
    assert abs(e0 - e1) / max(e0, e1) > 0.05  # different cutoffs drawn


def test_time_stretch_preserves_pitch_changes_tempo():
    """Standalone time stretch at rate 1.25: a tone-burst occupying the
    first 60% of the buffer compresses to ~48% while its dominant frequency
    stays put (pitch preserved, unlike speed_perturb)."""
    from jiao_liao_asr.frontend.augment import time_stretch

    sr, n = 16000, 16000
    t = np.arange(n) / sr
    wav = np.zeros(n, np.float32)
    burst = int(0.6 * n)
    wav[:burst] = np.sin(2 * np.pi * 440.0 * t[:burst]).astype(np.float32)
    out = np.asarray(
        time_stretch(jax.random.PRNGKey(0), jnp.asarray(wav[None]), (1.25,))
    )[0]
    # tempo: energy midpoint shifts from ~0.3n to ~0.24n
    env = np.cumsum(out**2)
    mid = np.searchsorted(env, env[-1] / 2) / n
    assert 0.18 < mid < 0.29, mid
    # pitch: dominant bin still ~440 Hz over the active region
    act = out[1000 : int(burst / 1.25) - 1000]
    freqs = np.fft.rfftfreq(act.size, 1 / sr)
    peak = freqs[np.argmax(np.abs(np.fft.rfft(act * np.hanning(act.size))))]
    assert abs(peak - 440.0) < 12.0, peak


def test_augment_consumes_filter_and_stretch_config():
    """The new AugmentConfig fields are live: enabling each filter (p=1)
    changes the waveform; time_stretch_rates routes through the chain."""
    rng = np.random.RandomState(0)
    wav = jnp.asarray(rng.randn(2, 8000).astype(np.float32))
    base = AugmentConfig(
        enabled=True, probability=0.0, lowpass_probability=0.0,
        highpass_probability=0.0, bandpass_probability=0.0,
    )
    out0 = augment_waveform(jax.random.PRNGKey(1), wav, base)
    np.testing.assert_array_equal(np.asarray(out0), np.asarray(wav))
    for field in ("lowpass_probability", "highpass_probability", "bandpass_probability"):
        cfg = AugmentConfig(
            enabled=True, probability=0.0, **{field: 1.0}
        )
        out = augment_waveform(jax.random.PRNGKey(1), wav, cfg)
        assert np.abs(np.asarray(out) - np.asarray(wav)).max() > 1e-4, field
    cfg = AugmentConfig(
        enabled=True, probability=1.0, gain_db=(0.0, 0.0),
        noise_snr_db=(100.0, 100.0), speed_rates=(1.0,),
        pitch_semitones=(0.0, 0.0), time_stretch_rates=(1.2,),
    )
    out = augment_waveform(jax.random.PRNGKey(2), wav, cfg)
    assert np.abs(np.asarray(out) - np.asarray(wav)).max() > 1e-3
