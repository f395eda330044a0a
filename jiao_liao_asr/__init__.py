"""ASR framework for low-resource Jiao-Liao Mandarin.

A brand-new JAX/XLA/pjit framework with the capabilities of the
reference system mixxs/Jiao-Liao_Speech_Recognition (see SURVEY.md):
an end-to-end pipeline of

  on-device fused audio frontend (resample -> STFT -> mel -> log + CMVN ->
  SpecAugment), transformer-CTC acoustic model and Whisper encoder-decoder
  backbones, WFAdapter / AttAdapter / bottleneck adapter injection on a frozen
  backbone, multi-dialect knowledge-transfer fine-tuning, on-device CTC loss,
  greedy + prefix-beam decoding, CER / jieba-segmented-WER evaluation.

Public north-star API (BASELINE.json): ``load`` / ``featurize`` /
``transcribe`` / ``fine_tune`` — re-exported here from :mod:`.api` —
plus ``stream`` for incremental (online) transcription.
"""

__version__ = "0.1.0"

from .api import load, featurize, transcribe, fine_tune, stream  # noqa: F401

__all__ = ["load", "featurize", "transcribe", "fine_tune", "stream", "__version__"]
