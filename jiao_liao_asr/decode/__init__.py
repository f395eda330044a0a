"""Decoding: CTC greedy / prefix beam search, Whisper AR generate, optional
external-LM shallow fusion.

Replacement for SpeechBrain CTC searchers and
WhisperGenerationMixin.generate (SURVEY.md C14). LM fusion (decode/lm.py:
n-gram char LM, host-beam fusion + on-device bigram fusion) is an extension
beyond the reference, whose lockfile has no kenlm/pyctcdecode — enabled only
via DecodeConfig.lm_path/lm_weight, off by default for reference parity.
"""

from .align import whisper_token_spans  # noqa: F401
from .ctc import ctc_greedy_decode, ctc_prefix_beam_search  # noqa: F401
from .lm import NGramCharLM  # noqa: F401
from .speculative import joint_spec_greedy, spec_greedy_from_enc  # noqa: F401
