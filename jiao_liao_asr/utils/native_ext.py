"""ctypes loader for the framework's native C++ components.

The reference gets its native code from third-party wheels (rapidfuzz
edit distance, libsndfile decode, Rust tokenizers — SURVEY.md §2.2). This
framework builds its own minimal C++ equivalents in native/ and
binds them via ctypes (pybind11 is not available in this image). Every
native component has a pure-Python fallback, so the framework works before
`make -C native` has run.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"


def _lib_path(name: str) -> Path:
    return _NATIVE_DIR / "build" / f"lib{name}.so"


@lru_cache(maxsize=None)
def load_editdist():
    """Load the C++ edit-distance kernel (native/editdist.cpp).

    Returns an object with ``edit_distance(ref_i32, hyp_i32) -> int`` or
    raises if the library has not been built.
    """
    lib = ctypes.CDLL(str(_lib_path("editdist")))
    lib.jl_edit_distance.restype = ctypes.c_int64
    lib.jl_edit_distance.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]

    class _EditDist:
        @staticmethod
        def edit_distance(ref: np.ndarray, hyp: np.ndarray) -> int:
            ref = np.ascontiguousarray(ref, dtype=np.int32)
            hyp = np.ascontiguousarray(hyp, dtype=np.int32)
            return lib.jl_edit_distance(
                ref.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(ref),
                hyp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(hyp),
            )

    return _EditDist()


@lru_cache(maxsize=None)
def load_wavio():
    """Load the C++ WAV decoder (native/wavio.cpp).

    Returns an object with ``read(path) -> (np.float32 pcm, sample_rate)``
    or raises if the library has not been built.
    """
    lib = ctypes.CDLL(str(_lib_path("wavio")))
    lib.jl_wav_info.restype = ctypes.c_int32
    lib.jl_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),  # num frames
        ctypes.POINTER(ctypes.c_int32),  # sample rate
        ctypes.POINTER(ctypes.c_int32),  # channels
    ]
    lib.jl_wav_read.restype = ctypes.c_int32
    lib.jl_wav_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]

    class _WavIO:
        @staticmethod
        def read(path: str):
            frames = ctypes.c_int64()
            sr = ctypes.c_int32()
            ch = ctypes.c_int32()
            rc = lib.jl_wav_info(
                str(path).encode(), ctypes.byref(frames), ctypes.byref(sr), ctypes.byref(ch)
            )
            if rc != 0:
                raise IOError(f"wavio: cannot read header of {path} (rc={rc})")
            out = np.empty(frames.value, dtype=np.float32)  # mono-mixed
            rc = lib.jl_wav_read(
                str(path).encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frames.value,
            )
            if rc != 0:
                raise IOError(f"wavio: decode failed for {path} (rc={rc})")
            return out, sr.value

    return _WavIO()


@lru_cache(maxsize=None)
def load_flacio():
    """Load the C++ FLAC decoder (native/flacio.cpp).

    Returns an object with ``info(path) -> (frames, sample_rate, channels)``
    and ``read(path) -> (np.float32 mono pcm, sample_rate)``.
    """
    lib = ctypes.CDLL(str(_lib_path("flacio")))
    lib.jl_flac_info.restype = ctypes.c_int32
    lib.jl_flac_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.jl_flac_read.restype = ctypes.c_int32
    lib.jl_flac_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]

    class _FlacIO:
        @staticmethod
        def info(path: str):
            frames = ctypes.c_int64()
            sr = ctypes.c_int32()
            ch = ctypes.c_int32()
            rc = lib.jl_flac_info(
                str(path).encode(), ctypes.byref(frames), ctypes.byref(sr),
                ctypes.byref(ch),
            )
            if rc != 0:
                raise IOError(f"flacio: cannot read header of {path} (rc={rc})")
            return frames.value, sr.value, ch.value

        @staticmethod
        def read(path: str):
            frames, sr, _ch = _FlacIO.info(path)
            if frames > 1_000_000_000:  # ~17 h at 16 kHz
                # the count comes from the (untrusted) STREAMINFO header: a
                # corrupted file must not turn into an unbounded allocation
                raise IOError(
                    f"flacio: implausible frame count {frames} in {path}"
                )
            out = np.empty(max(frames, 1), dtype=np.float32)
            decoded = ctypes.c_int64()
            rc = lib.jl_flac_read(
                str(path).encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                frames,
                ctypes.byref(decoded),
            )
            if rc != 0:
                raise IOError(f"flacio: decode failed for {path} (rc={rc})")
            return out[: decoded.value], sr

    return _FlacIO()


@lru_cache(maxsize=None)
def load_beam():
    """Load the C++ batched CTC prefix beam search (native/beam.cpp).

    Returns an object with
    ``search(lp_top, tok_top, lp_blank, lengths, beam_size, n_threads)
    -> (ids [B, T] int32, lens [B] int32)`` over device-pruned top-K frame
    posteriors (see decode/ctc.py::ctc_prefix_beam_search_native).
    """
    lib = ctypes.CDLL(str(_lib_path("beam")))
    lib.ctc_beam_search_topk.restype = None
    lib.ctc_beam_search_topk.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # lp_top [B,T,K]
        ctypes.POINTER(ctypes.c_int32),   # tok_top [B,T,K]
        ctypes.POINTER(ctypes.c_float),   # lp_blank [B,T]
        ctypes.POINTER(ctypes.c_int32),   # lengths [B]
        ctypes.c_int32,                   # B
        ctypes.c_int32,                   # T
        ctypes.c_int32,                   # K
        ctypes.c_int32,                   # beam_size
        ctypes.POINTER(ctypes.c_int32),   # out_ids [B,T]
        ctypes.POINTER(ctypes.c_int32),   # out_lens [B]
        ctypes.c_int32,                   # n_threads
        ctypes.c_float,                   # prune_logp (<0 prunes; >=0 exact)
    ]

    class _Beam:
        @staticmethod
        def search(lp_top, tok_top, lp_blank, lengths, beam_size, n_threads=0,
                   prune_logp=0.0):
            lp_top = np.ascontiguousarray(lp_top, dtype=np.float32)
            tok_top = np.ascontiguousarray(tok_top, dtype=np.int32)
            lp_blank = np.ascontiguousarray(lp_blank, dtype=np.float32)
            lengths = np.ascontiguousarray(lengths, dtype=np.int32)
            B, T, K = lp_top.shape
            out_ids = np.zeros((B, T), dtype=np.int32)
            out_lens = np.zeros((B,), dtype=np.int32)
            lib.ctc_beam_search_topk(
                lp_top.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                tok_top.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lp_blank.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                B, T, K, beam_size,
                out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                n_threads,
                float(prune_logp),
            )
            return out_ids, out_lens

    return _Beam()


def load_bpe(tokenizer):
    """Bind the C++ BPE merge loop (native/bpe.cpp) to a ByteLevelBPE
    instance: merge rules become (left<<32|right) keys over vocab ids.

    Returns an object with ``encode_word(mapped: str) -> list[int] | None``
    (None when a char is missing from the vocab — caller falls back).
    """
    lib = ctypes.CDLL(str(_lib_path("bpe")))
    lib.jl_bpe_new.restype = ctypes.c_void_p
    lib.jl_bpe_new.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.jl_bpe_encode.restype = ctypes.c_int64
    lib.jl_bpe_encode.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.jl_bpe_free.restype = None
    lib.jl_bpe_free.argtypes = [ctypes.c_void_p]

    vocab = tokenizer.vocab
    keys, merged = [], []
    for (a, b), _rank in sorted(tokenizer.ranks.items(), key=lambda kv: kv[1]):
        va, vb, vm = vocab.get(a), vocab.get(b), vocab.get(a + b)
        if va is None or vb is None or vm is None:
            continue  # rule references tokens outside the vocab; skip
        keys.append((va << 32) | vb)
        merged.append(vm)
    keys_arr = np.asarray(keys, dtype=np.int64)
    merged_arr = np.asarray(merged, dtype=np.int32)
    handle = lib.jl_bpe_new(
        len(keys),
        keys_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        merged_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )

    class _Bpe:
        # keep source arrays alive with the handle
        _keep = (keys_arr, merged_arr)

        @staticmethod
        def encode_word(mapped: str):
            syms = np.empty(len(mapped), dtype=np.int32)
            for i, ch in enumerate(mapped):
                vid = vocab.get(ch)
                if vid is None:
                    return None
                syms[i] = vid
            out = np.empty(max(len(mapped), 1), dtype=np.int32)
            n = lib.jl_bpe_encode(
                handle,
                syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(syms),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            return [int(x) for x in out[:n]]

    return _Bpe()


def native_available(name: str) -> bool:
    return _lib_path(name).exists()


def build_native(verbose: bool = False) -> bool:
    """Best-effort `make -C native` (used by CLI setup, never at import)."""
    import subprocess

    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=not verbose,
        )
        return True
    except Exception:
        return False
