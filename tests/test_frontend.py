"""Frontend golden-fixture parity (SURVEY.md §4.1-2): log-mel vs the pinned
transformers WhisperFeatureExtractor, mel filterbank vs its formula,
resampler vs scipy polyphase, SpecAugment invariants."""

import numpy as np
import pytest

import jax.numpy as jnp

from jiao_liao_asr.frontend import (
    log_mel_spectrogram,
    mel_filterbank,
    resample,
    spec_augment,
)
from jiao_liao_asr.frontend.features import pad_or_trim, featurize_batch
from jiao_liao_asr.utils.config import FrontendConfig, SpecAugmentConfig

TOL = 2e-4  # normalized log-mel units; argmax-text parity needs << 0.25


@pytest.fixture(scope="module")
def whisper_fe():
    from transformers import WhisperFeatureExtractor

    return WhisperFeatureExtractor()


def _mk_wav(seed, secs, scale=0.1):
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * secs)) / 16000.0
    return (
        rng.randn(len(t)) * scale * 0.3 + np.sin(2 * np.pi * 440 * t) * scale
    ).astype(np.float32)


@pytest.mark.parametrize("seed,secs,scale", [(0, 5, 0.1), (1, 29, 0.5), (2, 1.3, 0.01)])
def test_logmel_matches_whisper_fe(whisper_fe, seed, secs, scale):
    wav = _mk_wav(seed, secs, scale)
    ref = whisper_fe(wav, sampling_rate=16000, return_tensors="np").input_features[0]
    cfg = FrontendConfig()
    mine = np.asarray(log_mel_spectrogram(pad_or_trim(wav, cfg)[None], cfg))[0]
    assert mine.shape == ref.shape == (80, 3000)
    assert np.abs(mine - ref).max() < TOL


def test_mel_filterbank_matches_reference_formula():
    from transformers.audio_utils import mel_filter_bank

    ref = mel_filter_bank(
        num_frequency_bins=201,
        num_mel_filters=80,
        min_frequency=0.0,
        max_frequency=8000.0,
        sampling_rate=16000,
        norm="slaney",
        mel_scale="slaney",
    )
    mine = mel_filterbank(80, 400, 16000)
    assert np.abs(ref.T - mine).max() < 1e-8


def test_mel_filterbank_htk_mode():
    fb = mel_filterbank(80, 400, 16000, scale="htk", norm=None)
    assert fb.shape == (80, 201)
    assert (fb >= 0).all() and fb.max() <= 1.0 + 1e-6


def test_featurize_batch_shape():
    cfg = FrontendConfig()
    wav = np.zeros((2, 480000), np.float32)
    out = featurize_batch(jnp.asarray(wav), cfg)
    assert out.shape == (2, 80, 3000)


def test_resample_vs_scipy(rng):
    from scipy.signal import resample_poly

    x = rng.randn(16000).astype(np.float32) * 0.3
    for orig, tgt in [(8000, 16000), (22050, 16000), (44100, 16000), (16000, 8000)]:
        mine = np.asarray(resample(jnp.asarray(x), orig, tgt))
        import math

        g = math.gcd(orig, tgt)
        ref = resample_poly(x.astype(np.float64), tgt // g, orig // g)
        n = min(len(mine), len(ref))
        # interior parity (edges differ by padding convention)
        pad = 200
        err = np.abs(mine[pad : n - pad] - ref[pad : n - pad]).max()
        assert err < 5e-3, (orig, tgt, err)


def test_specaugment_masks_and_determinism():
    import jax

    cfg = SpecAugmentConfig(num_freq_masks=2, freq_mask_width=10, num_time_masks=2)
    x = jnp.ones((2, 80, 300))
    key = jax.random.PRNGKey(0)
    y1 = spec_augment(key, x, cfg)
    y2 = spec_augment(key, x, cfg)
    assert np.allclose(y1, y2)  # reproducible per key
    assert (np.asarray(y1) == 0).any()  # something masked
    frac = (np.asarray(y1) == 0).mean()
    assert frac < 0.6  # not wiping everything out
    y3 = spec_augment(jax.random.PRNGKey(1), x, cfg)
    assert not np.allclose(y1, y3)  # key-dependent


def test_wav_roundtrip(tmp_path, tiny_wav):
    from jiao_liao_asr.frontend.audio_io import read_wav, write_wav

    p = tmp_path / "x.wav"
    write_wav(p, tiny_wav, 16000)
    pcm, sr = read_wav(p)
    assert sr == 16000
    assert len(pcm) == len(tiny_wav)
    assert np.abs(pcm - tiny_wav).max() < 1e-3  # 16-bit quantization


def test_native_wavio_rejects_malformed_headers(tmp_path):
    """Hostile WAVs: short fmt chunks and sub-byte bit depths must be
    rejected by the C++ decoder, not heap-over-read or divide by zero."""
    import struct

    from jiao_liao_asr.utils import native_ext

    if not native_ext.native_available("wavio"):
        pytest.skip("native wavio not built")
    wavio = native_ext.load_wavio()

    def riff(fmt_chunk: bytes, data: bytes = b"\0" * 8) -> bytes:
        body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
        body += b"data" + struct.pack("<I", len(data)) + data
        return b"RIFF" + struct.pack("<I", len(body)) + body

    # fmt chunk shorter than the 16-byte base block (was a heap over-read)
    p1 = tmp_path / "short_fmt.wav"
    p1.write_bytes(riff(struct.pack("<HHI", 1, 1, 16000)))
    with pytest.raises(IOError):
        wavio.read(str(p1))

    # bits=4 passes a !=0 check but makes bytes-per-frame zero (div by zero)
    p2 = tmp_path / "bits4.wav"
    p2.write_bytes(riff(struct.pack("<HHIIHH", 1, 1, 16000, 8000, 1, 4)))
    with pytest.raises(IOError):
        wavio.read(str(p2))

    # zero channels
    p3 = tmp_path / "ch0.wav"
    p3.write_bytes(riff(struct.pack("<HHIIHH", 1, 0, 16000, 32000, 2, 16)))
    with pytest.raises(IOError):
        wavio.read(str(p3))

    # extensible fmt with truncated extension block
    p4 = tmp_path / "ext_short.wav"
    p4.write_bytes(riff(struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 32000, 2, 16)))
    with pytest.raises(IOError):
        wavio.read(str(p4))

    # a well-formed file still reads
    ok = tmp_path / "ok.wav"
    from jiao_liao_asr.frontend.audio_io import write_wav

    write_wav(ok, np.zeros(100, np.float32), 16000)
    pcm, sr = wavio.read(str(ok))
    assert sr == 16000 and len(pcm) == 100
