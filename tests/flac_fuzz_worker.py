"""Seeded FLAC mutation-fuzz worker (run in a subprocess by test_flac.py).

Takes base .flac files, applies deterministic mutations (truncations, bit
flips anywhere, header-concentrated bit flips), and decodes every mutant
with native/flacio.cpp. The decoder must either return PCM or raise a clean
IOError — any crash kills this subprocess (nonzero exit / signal), which the
parent test reports with the (file, seed) needed to reproduce.

Usage: python flac_fuzz_worker.py <base.flac> [<base2.flac> ...] --seed S --n N
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
from jiao_liao_asr.utils import native_ext  # noqa: E402


def mutate(data: bytes, rng: np.random.RandomState) -> bytes:
    buf = bytearray(data)
    kind = rng.randint(3)
    if kind == 0:  # truncate (header boundaries included)
        cut = rng.randint(1, len(buf) + 1)
        return bytes(buf[:cut])
    if kind == 1:  # random bit flips anywhere
        for _ in range(rng.randint(1, 9)):
            i = rng.randint(len(buf))
            buf[i] ^= 1 << rng.randint(8)
        return bytes(buf)
    # header/LPC/rice-parameter-concentrated flips: the first 160 bytes hold
    # STREAMINFO + the first frame header, subframe headers and rice params
    for _ in range(rng.randint(1, 6)):
        i = rng.randint(min(160, len(buf)))
        buf[i] ^= 1 << rng.randint(8)
    return bytes(buf)


def main() -> int:
    args = sys.argv[1:]
    seed = int(args[args.index("--seed") + 1])
    n = int(args[args.index("--n") + 1])
    bases = [a for a in args if not a.startswith("--") and a.endswith(".flac")]
    flac = native_ext.load_flacio()
    rng = np.random.RandomState(seed)
    decoded = errors = 0
    with tempfile.TemporaryDirectory() as td:
        for i in range(n):
            base = bases[i % len(bases)]
            raw = open(base, "rb").read()
            mut = mutate(raw, rng)
            p = os.path.join(td, "m.flac")
            with open(p, "wb") as f:
                f.write(mut)
            try:
                pcm, sr = flac.read(p)
                # decoded output must be finite and bounded by the original
                # length (no runaway buffers from corrupt block sizes)
                assert np.all(np.isfinite(pcm)), f"non-finite pcm (seed {seed}, i {i})"
                assert pcm.size <= 10_000_000, f"runaway pcm size {pcm.size}"
                decoded += 1
            except (IOError, OSError):
                errors += 1  # clean rejection is a pass
    print(f"fuzz ok: {decoded} decoded, {errors} cleanly rejected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
