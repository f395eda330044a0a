"""External-LM shallow fusion for beam decoding (BASELINE configs[4]
stretch: "attention decode + LM fusion").

The reference has NO LM fusion (no kenlm/pyctcdecode in its lockfile,
SURVEY §0.2) — this is an extension. Two consumption paths:

* host CTC prefix beam (decode/ctc.py): per-extension stupid-backoff n-gram
  scores, the kenlm-style fusion recipe
* on-device AR beam (decode/whisper_generate.py): the LM lowered to a dense
  [V, V] bigram log-prob matrix added to the per-step logits inside the
  lax.while_loop — for the char-vocab whisper fine-tunes the matrix is tiny
  and the fusion costs one gather per step

Training data is just the manifest transcripts; `cli train-lm` builds and
saves the model as an .npz of packed n-gram hash tables.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

BACKOFF = 0.4  # stupid-backoff factor (Brants et al., 2007)


class NGramCharLM:
    """Character n-gram LM with stupid-backoff scoring.

    Tokens are tokenizer ids, so the same model serves the CTC char path and
    the char-vocab whisper path. BOS uses id -1 internally.
    """

    def __init__(self, order: int, vocab_size: int,
                 counts: Optional[Dict[Tuple[int, ...], int]] = None):
        assert order >= 1
        self.order = order
        self.vocab_size = vocab_size
        # counts[ngram] for every 1..order gram; context counts are the
        # (n-1)-gram entries, so one dict serves both numerator and denom
        self.counts: Dict[Tuple[int, ...], int] = counts or {}
        self.total = sum(c for k, c in self.counts.items() if len(k) == 1)

    # ------------------------------------------------------------- training
    @classmethod
    def train(cls, id_seqs: Iterable[Sequence[int]], order: int, vocab_size: int
              ) -> "NGramCharLM":
        counts: Dict[Tuple[int, ...], int] = {}
        for seq in id_seqs:
            toks = [-1] * (order - 1) + [int(t) for t in seq]
            for i in range(order - 1, len(toks)):
                for n in range(1, order + 1):
                    if i - n + 1 < 0:
                        break
                    g = tuple(toks[i - n + 1 : i + 1])
                    counts[g] = counts.get(g, 0) + 1
        return cls(order, vocab_size, counts)

    @classmethod
    def train_from_texts(cls, texts: Iterable[str], tokenizer, order: int = 3
                         ) -> "NGramCharLM":
        return cls.train(
            (tokenizer.encode(t) for t in texts), order, len(tokenizer)
        )

    # -------------------------------------------------------------- scoring
    def logp(self, context: Sequence[int], tok: int) -> float:
        """Stupid-backoff log-prob of `tok` given up to order-1 context ids."""
        ctx = tuple(int(c) for c in context)[-(self.order - 1):] if self.order > 1 else ()
        factor = 0.0
        while True:
            denom = self.counts.get(ctx, 0) if ctx else self.total
            num = self.counts.get(ctx + (int(tok),), 0)
            if num > 0 and denom > 0:
                return factor + float(np.log(num / denom))
            if not ctx:
                # add-one floor over the vocab
                return factor + float(
                    np.log((num + 1.0) / (max(self.total, 1) + self.vocab_size))
                )
            ctx = ctx[1:]
            factor += float(np.log(BACKOFF))

    def score_sequence(self, ids: Sequence[int]) -> float:
        ctx: Tuple[int, ...] = (-1,) * (self.order - 1)
        total = 0.0
        for t in ids:
            total += self.logp(ctx, t)
            ctx = (ctx + (int(t),))[-(self.order - 1):] if self.order > 1 else ()
        return total

    def bigram_log_matrix(self) -> np.ndarray:
        """Dense [V, V] log P(next | prev) for on-device fusion. Row -1 (BOS)
        is folded into unigram; unseen pairs back off to unigram * BACKOFF."""
        V = self.vocab_size
        uni = np.array(
            [self.logp((), v) for v in range(V)], np.float32
        )  # unigram with floor
        mat = np.tile(np.log(BACKOFF) + uni[None, :], (V, 1)).astype(np.float32)
        for g, c in self.counts.items():
            if len(g) == 2 and 0 <= g[0] < V and 0 <= g[1] < V:
                denom = self.counts.get((g[0],), 0)
                if denom > 0:
                    mat[g[0], g[1]] = np.log(c / denom)
        return mat

    # ---------------------------------------------------------- persistence
    def save(self, path: str | Path) -> None:
        keys = sorted(self.counts)
        flat = np.full((len(keys), self.order), -2, np.int32)
        vals = np.zeros(len(keys), np.int64)
        for i, k in enumerate(keys):
            flat[i, : len(k)] = k
            vals[i] = self.counts[k]
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path, grams=flat, counts=vals,
            meta=json.dumps({"order": self.order, "vocab_size": self.vocab_size}),
        )

    @classmethod
    def load(cls, path: str | Path) -> "NGramCharLM":
        d = np.load(path, allow_pickle=False)
        meta = json.loads(str(d["meta"]))
        counts: Dict[Tuple[int, ...], int] = {}
        for row, c in zip(d["grams"], d["counts"]):
            g = tuple(int(t) for t in row if t != -2)
            counts[g] = int(c)
        return cls(meta["order"], meta["vocab_size"], counts)
