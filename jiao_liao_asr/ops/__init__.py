"""On-device ops: CTC loss (log-semiring scan) and weight-only int8
quantization.

The CTC loss replaces the reference's cuDNN CTC loss
(torch.nn.functional.ctc_loss, /root/reference/requirements.txt:75; SURVEY
N1) with a statically shaped scan that runs wherever XLA does.
"""

from .ctc_loss import ctc_loss  # noqa: F401
