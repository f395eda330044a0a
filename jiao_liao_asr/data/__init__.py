"""Data layer: jsonl manifests, char tokenizer, length bucketing, host
streaming into padded device batches.

Replacement for the reference's HF-datasets arrow pipeline
(/root/reference/requirements.txt:14,50; SURVEY.md C1): plain jsonl manifest
rows {audio, text, duration, dialect}, host wav decode, fixed bucket shapes
so jit never recompiles (SURVEY §7 hard-part 4).
"""

from .manifest import Manifest, ManifestRow, read_manifest, write_manifest  # noqa: F401
from .tokenizer import CharTokenizer  # noqa: F401
from .unigram import UnigramTokenizer  # noqa: F401
from .pipeline import BatchIterator, make_batches  # noqa: F401
