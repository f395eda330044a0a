"""CMVN: cepstral mean/variance normalization, utterance- and corpus-level.

The reference's SB path applies InputNormalization over fbank features
(SURVEY.md C3). Here: utterance CMVN is fused into the featurizer
(features.log_mel_spectrogram); this module
adds *global* CMVN — corpus statistics accumulated on host once, applied
on-device as a cheap affine op — plus stat persistence.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.config import DataConfig, FrontendConfig


class GlobalCMVN:
    """Running mean/var accumulator over [B, M, T] feature batches."""

    def __init__(self, num_mels: int):
        self.n = 0
        self.sum = np.zeros(num_mels, np.float64)
        self.sumsq = np.zeros(num_mels, np.float64)

    def update(self, feats: np.ndarray, frame_lengths: Optional[np.ndarray] = None):
        f = np.asarray(feats, np.float64)  # [B, M, T]
        if frame_lengths is None:
            self.sum += f.sum(axis=(0, 2))
            self.sumsq += (f**2).sum(axis=(0, 2))
            self.n += f.shape[0] * f.shape[2]
        else:
            for b in range(f.shape[0]):
                t = int(frame_lengths[b])
                self.sum += f[b, :, :t].sum(axis=1)
                self.sumsq += (f[b, :, :t] ** 2).sum(axis=1)
                self.n += t

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mean = self.sum / max(self.n, 1)
        var = self.sumsq / max(self.n, 1) - mean**2
        return mean.astype(np.float32), np.sqrt(np.maximum(var, 1e-8)).astype(np.float32)

    def save(self, path: str | Path) -> None:
        mean, std = self.finalize()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, mean=mean, std=std, count=self.n)


def load_cmvn(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    d = np.load(path)
    return d["mean"], d["std"]


def apply_global_cmvn(feats, mean, std):
    """[B, M, T] -> normalized, on device (jit-safe affine)."""
    import jax.numpy as jnp

    m = jnp.asarray(mean)[None, :, None]
    s = jnp.asarray(std)[None, :, None]
    return (feats - m) / (s + 1e-8)


def compute_corpus_cmvn(
    manifest, tokenizer, data_cfg: DataConfig, fe_cfg: FrontendConfig,
    max_batches: int = 100,
) -> GlobalCMVN:
    """One pass over (a prefix of) the corpus accumulating feature stats."""
    import jax.numpy as jnp

    from ..data.pipeline import BatchIterator
    from .features import featurize_batch

    it = BatchIterator(manifest, tokenizer, data_cfg, shuffle=False)
    acc = GlobalCMVN(fe_cfg.num_mels)
    for _ in range(min(max_batches, max(len(manifest) // data_cfg.batch_size, 1))):
        b = next(it)
        feats = featurize_batch(jnp.asarray(b.audio), fe_cfg)
        acc.update(np.asarray(feats), b.audio_lengths // fe_cfg.hop_length)
    return acc
