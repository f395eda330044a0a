"""Host-side audio decode: WAV via the C++ decoder (native/wavio.cpp) with a
stdlib-`wave` fallback; FLAC via the C++ decoder (native/flacio.cpp).

Replaces the reference's libsndfile/audioread decode path
(/root/reference/requirements.txt:8,69; SURVEY.md C2, N5 "chunked WAV/FLAC").
Decoding stays on host by design — the device pipeline starts at raw PCM
float32. `read_audio` dispatches on file suffix.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils import native_ext


def read_audio(path: str | Path) -> Tuple[np.ndarray, int]:
    """Read WAV or FLAC -> (mono float32 PCM in [-1, 1], sample_rate),
    dispatched on the file suffix."""
    if str(path).lower().endswith(".flac"):
        return read_flac(path)
    return read_wav(path)


def read_flac(path: str | Path) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file via the C++ decoder (native/flacio.cpp). There is
    no pure-Python fallback — `make -C native` (or CLI build-native) first."""
    if not native_ext.native_available("flacio"):
        raise RuntimeError(
            "FLAC decode needs the native library: run `make -C native` or "
            "`python -m jiao_liao_asr.cli build-native`"
        )
    return native_ext.load_flacio().read(str(path))


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (mono float32 PCM in [-1, 1], sample_rate).

    Multi-channel audio is mixed down to mono by averaging. Supports
    8/16/24/32-bit integer PCM and 32-bit float WAV.
    """
    try:
        if native_ext.native_available("wavio"):
            return native_ext.load_wavio().read(str(path))
    except Exception:
        pass  # fall through to the stdlib decoder
    return _read_wav_py(path)


def _read_wav_py(path: str | Path) -> Tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as wf:
        sr = wf.getframerate()
        n = wf.getnframes()
        ch = wf.getnchannels()
        sw = wf.getsampwidth()
        raw = wf.readframes(n)
    if sw == 2:
        pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        # stdlib wave exposes both int32 PCM and float WAV as sampwidth 4;
        # wave only supports PCM, so treat as int32.
        pcm = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        pcm = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32 = np.where(i32 & 0x800000, i32 - 0x1000000, i32)
        pcm = i32.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw} in {path}")
    if ch > 1:
        pcm = pcm.reshape(-1, ch).mean(axis=1)
    return pcm, sr


def write_wav(path: str | Path, pcm: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 PCM to a 16-bit WAV (fixtures/tests helper)."""
    pcm16 = np.clip(np.asarray(pcm, dtype=np.float32), -1.0, 1.0)
    pcm16 = (pcm16 * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm16.tobytes())
