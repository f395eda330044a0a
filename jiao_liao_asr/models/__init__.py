"""Model layer: transformer-CTC encoder, Whisper encoder-decoder, adapters.

Re-design of the reference's model stack (SURVEY.md C7-C11): plain
functions over nested param dicts (models/module.py) compiled by XLA, bf16
compute / f32 params, attention through jax.nn.dot_product_attention
(cuDNN where it applies), and the paper's WFAdapter / AttAdapter /
bottleneck-adapter family injected on a frozen backbone (README.md:1 — the
reference hand-writes these as torch nn.Modules; here they are fused
low-rank / attention inserts inside the transformer blocks).
"""

from .adapters import AdapterConfig  # noqa: F401
from .ctc_model import CTCEncoderModel  # noqa: F401
from .whisper import WhisperModel  # noqa: F401
