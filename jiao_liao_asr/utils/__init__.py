"""Utilities: dataclass configs (JSON round-trip), jsonl metrics logging,
native C++ extension loading.

Replaces the reference's HyperPyYAML config system
(/root/reference/requirements.txt:24) with plain, non-code-executing
dataclass configs, and its wandb tracking (requirements.txt:85) with a
structured jsonl logger plus an optional wandb sink.
"""

from . import config  # noqa: F401
from .logging import MetricsLogger  # noqa: F401
