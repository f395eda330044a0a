"""Evaluation layer: CER / WER metrics, text normalization, RTFx harness.

Replacement for the reference's jiwer+rapidfuzz+jieba eval stack
(reference evidence: /root/reference/requirements.txt:26,28,56; see SURVEY.md
C15).  Semantics match jiwer: error rate = (S + D + I) / len(reference),
aggregated corpus-level as sum(errors) / sum(ref lengths).
"""

from .metrics import (  # noqa: F401
    cer,
    wer,
    corpus_cer,
    corpus_wer,
    edit_distance,
    edit_ops,
    normalize_text,
    segment_words,
)
