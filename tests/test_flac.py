"""Native FLAC decoder (native/flacio.cpp) against the independent
bit-format writer in tests/flacgen.py — every subframe type, every stereo
decorrelation mode, multi-frame streams, and the read_audio dispatch.

KNOWN LIMITATION (review finding, round 2): every fixture here is encoded
by tests/flacgen.py, written expressly to test the decoder — a shared
misreading of the FLAC spec would pass. An externally-encoded fixture
(libFLAC/ffmpeg bytes) would close that hole, but this environment has no
FLAC encoder and no network (soundfile/ffmpeg absent; zero egress —
verified each round). flacgen.py mitigates by being a bit-level writer
built directly from the format spec (frame headers, UTF-8 frame numbers,
rice partitions, CRC8/16) sharing no code or structure with the decoder.
If an externally-encoded .flac ever lands in tests/fixtures/, add it to
test_mono_subframe_kinds-style assertions first."""

import numpy as np
import pytest

from jiao_liao_asr.utils import native_ext

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from flacgen import write_flac  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_ext.native_available("flacio"), reason="native flacio not built"
)


def _sig(n, rng, amp=2000):
    t = np.arange(n) / 16000.0
    s = amp * np.sin(2 * np.pi * 440 * t) + rng.randint(-50, 50, n)
    return np.round(s).astype(np.int64)


def _expect_mono(channels, bps):
    scale = 1.0 / (1 << (bps - 1))
    return np.mean([c.astype(np.float64) * scale for c in channels], axis=0)


@pytest.mark.parametrize("kind", ["verbatim", "fixed", "lpc"])
def test_mono_subframe_kinds(tmp_path, rng, kind):
    sig = _sig(1000, rng)
    p = tmp_path / f"{kind}.flac"
    write_flac(p, [sig], subframe_kind=kind, block_size=256)
    flac = native_ext.load_flacio()
    frames, sr, ch = flac.info(str(p))
    assert (frames, sr, ch) == (1000, 16000, 1)
    pcm, sr = flac.read(str(p))
    assert sr == 16000 and len(pcm) == 1000
    want = _expect_mono([sig], 16)
    assert np.abs(pcm - want).max() < 1e-6, kind


def test_constant_subframe(tmp_path):
    sig = np.full(512, -123, np.int64)
    p = tmp_path / "const.flac"
    write_flac(p, [sig], subframe_kind="constant", block_size=256)
    pcm, _ = native_ext.load_flacio().read(str(p))
    assert np.abs(pcm - (-123 / 32768.0)).max() < 1e-6


def test_fixed_orders(tmp_path, rng):
    sig = _sig(512, rng)
    flac = native_ext.load_flacio()
    for order in range(5):
        p = tmp_path / f"fixed{order}.flac"
        write_flac(p, [sig], subframe_kind="fixed", block_size=256)
        pcm, _ = flac.read(str(p))
        assert np.abs(pcm - _expect_mono([sig], 16)).max() < 1e-6


@pytest.mark.parametrize(
    "mode", ["independent", "left_side", "right_side", "mid_side"]
)
def test_stereo_decorrelation(tmp_path, rng, mode):
    left = _sig(800, rng)
    right = _sig(800, np.random.RandomState(7), amp=1500)
    p = tmp_path / f"{mode}.flac"
    write_flac(p, [left, right], subframe_kind="fixed", stereo_mode=mode,
               block_size=200)
    pcm, sr = native_ext.load_flacio().read(str(p))
    want = _expect_mono([left, right], 16)
    assert np.abs(pcm - want).max() < 1e-6, mode


def test_multi_frame_and_partial_last_block(tmp_path, rng):
    sig = _sig(1000, rng)  # 3 full 256 blocks + 232 tail
    p = tmp_path / "multi.flac"
    write_flac(p, [sig], subframe_kind="lpc", block_size=256,
               lpc_coefs=[5, -4, 1])
    pcm, _ = native_ext.load_flacio().read(str(p))
    assert len(pcm) == 1000
    assert np.abs(pcm - _expect_mono([sig], 16)).max() < 1e-6


def test_read_audio_dispatches_flac(tmp_path, rng):
    from jiao_liao_asr.frontend.audio_io import (
        read_audio,
        write_wav,
    )

    sig = _sig(640, rng)
    pf = tmp_path / "u.flac"
    write_flac(pf, [sig], subframe_kind="fixed")
    pcm_f, sr_f = read_audio(pf)
    # same content through the WAV path
    pw = tmp_path / "u.wav"
    write_wav(pw, (sig / 32768.0).astype(np.float32), 16000)
    pcm_w, sr_w = read_audio(pw)
    assert sr_f == sr_w == 16000
    assert np.abs(pcm_f - pcm_w).max() < 2e-4  # wav path is 16-bit quantized


def test_flac_manifest_row_flows_through_pipeline(tmp_path, rng):
    """A .flac row in a manifest batches exactly like a .wav row."""
    from jiao_liao_asr.data import (
        BatchIterator,
        CharTokenizer,
        Manifest,
        ManifestRow,
    )
    from jiao_liao_asr.utils.config import DataConfig

    sig = _sig(16000, rng)
    p = tmp_path / "u0.flac"
    write_flac(p, [sig], subframe_kind="fixed")
    rows = [ManifestRow(str(p), "你好", 1.0, "jiaoliao")] * 2
    tok = CharTokenizer.build(["你好"])
    it = BatchIterator(
        Manifest(rows), tok, DataConfig(batch_size=2,
                                        bucket_boundaries_seconds=(1.5,),
                                        min_audio_seconds=0.1),
    )
    b = next(it)
    assert b.audio.shape == (2, 24000)
    assert np.abs(b.audio[0, :16000] - _expect_mono([sig], 16)).max() < 1e-6


def test_flac_rejects_garbage(tmp_path):
    p = tmp_path / "bad.flac"
    p.write_bytes(b"fLaC" + b"\x00" * 10)
    with pytest.raises(IOError):
        native_ext.load_flacio().read(str(p))
    p2 = tmp_path / "notflac.flac"
    p2.write_bytes(b"RIFFxxxx")
    with pytest.raises(IOError):
        native_ext.load_flacio().read(str(p2))


def test_fuzz_mutations_no_crash_no_hang(tmp_path, rng):
    """Seeded mutation fuzz: truncations and bit flips
    over flacgen corpora — headers, LPC params, rice codes — must produce
    either decoded PCM or a clean IOError, never a crash, hang, or runaway
    allocation. Runs in subprocesses so a decoder segfault fails the test
    with the reproducing (worker, seed) instead of killing pytest."""
    import subprocess
    import sys as _sys

    bases = []
    specs = [
        ("lpc", 256, 1), ("fixed", 192, 2), ("verbatim", 128, 1),
    ]
    for kind, bs, nch in specs:
        chans = [_sig(700, rng) for _ in range(nch)]
        p = tmp_path / f"fuzzbase_{kind}.flac"
        write_flac(p, chans, subframe_kind=kind, block_size=bs)
        bases.append(str(p))

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "flac_fuzz_worker.py")
    for seed in (101, 202):
        r = subprocess.run(
            [_sys.executable, worker, *bases, "--seed", str(seed), "--n", "150"],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0, (
            f"fuzz worker crashed (seed {seed}, rc {r.returncode}):\n"
            f"{r.stdout[-500:]}\n{r.stderr[-1500:]}"
        )
        assert "fuzz ok" in r.stdout


def test_read_rejects_implausible_frame_count(tmp_path, rng):
    """A corrupted STREAMINFO frame count must raise, not allocate: patch
    the 36-bit total-samples field to a huge value and call read()."""
    sig = _sig(400, rng)
    p = tmp_path / "huge.flac"
    write_flac(p, [sig], subframe_kind="fixed", block_size=256)
    raw = bytearray(open(p, "rb").read())
    # STREAMINFO starts at byte 8 (after fLaC + block header); its layout is
    # 16+16+24+24 (blocks/frames) + 20 (rate) + 3 (ch) + 5 (bps) = 108 bits,
    # then 36 bits of total samples: low nibble of byte 8+13=21 + bytes 22-25
    raw[21] |= 0x0F
    raw[22:26] = b"\xff\xff\xff\xff"
    with open(p, "wb") as f:
        f.write(raw)
    flac = native_ext.load_flacio()
    frames, sr_, ch = flac.info(str(p))
    assert frames > 1_000_000_000
    with pytest.raises(IOError, match="implausible"):
        flac.read(str(p))
