"""SP-unigram tokenizer (data/unigram.py, SURVEY N9): Viterbi optimality,
EM training, SP-format interop, pipeline + bundle wiring."""

import itertools
import math

import numpy as np
import pytest

from jiao_liao_asr.data.unigram import (
    _UNK_PENALTY,
    UnigramTokenizer,
)


def _brute_force_best(text, tok):
    """Best segmentation score by enumerating all segmentations."""
    n = len(text)
    best = -math.inf
    for cuts in itertools.product([0, 1], repeat=n - 1):
        pieces, start = [], 0
        for i, c in enumerate(cuts, 1):
            if c:
                pieces.append(text[start:i])
                start = i
        pieces.append(text[start:])
        score = 0.0
        ok = True
        for p in pieces:
            pid = tok.to_id.get(p)
            if pid is not None and pid >= 2:
                score += tok.logprobs[pid]
            elif len(p) == 1:
                score += _UNK_PENALTY
            else:
                ok = False
                break
        if ok:
            best = max(best, score)
    return best


def test_viterbi_matches_brute_force():
    pieces = ["a", "b", "c", "ab", "bc", "abc", "cab"]
    logprobs = [-3.0, -3.2, -2.9, -2.0, -2.5, -4.0, -1.5]
    tok = UnigramTokenizer(pieces, logprobs)
    rng = np.random.RandomState(0)
    for _ in range(30):
        s = "".join(rng.choice(list("abc"), size=rng.randint(2, 9)))
        ids = tok.encode(s)
        score = sum(
            tok.logprobs[i] if i >= 2 else _UNK_PENALTY for i in ids
        )
        assert abs(score - _brute_force_best(s, tok)) < 1e-9, s
        # segmentation covers the string exactly
        assert "".join(tok.vocab[i] if i >= 2 else s[0] for i in ids) or s == ""


def test_viterbi_prefers_high_prob_merge():
    tok = UnigramTokenizer(["a", "b", "ab"], [-5.0, -5.0, -1.0])
    assert tok.encode("ab") == [tok.to_id["ab"]]
    tok2 = UnigramTokenizer(["a", "b", "ab"], [-1.0, -1.0, -9.0])
    assert tok2.encode("ab") == [tok2.to_id["a"], tok2.to_id["b"]]


def test_train_learns_frequent_pieces_and_roundtrips():
    texts = ["你好世界", "你好朋友", "世界真好", "你好你好世界"] * 10
    tok = UnigramTokenizer.train(texts, vocab_size=24, max_piece_len=3)
    assert "你好" in tok.to_id  # the dominant bigram becomes a piece
    for t in texts[:4]:
        ids = tok.encode(t)
        assert tok.decode(ids) == t
        assert all(i >= 2 for i in ids)  # full coverage, no unk
    # unknown char -> unk id, decode skips it
    ids = tok.encode("你好X")
    assert tok.unk_id in ids
    assert tok.decode(ids) == "你好"


def test_sp_vocab_tsv_roundtrip(tmp_path):
    texts = ["水水山山", "山水山水"] * 5
    tok = UnigramTokenizer.train(texts, vocab_size=16)
    p = tmp_path / "uni.vocab"
    tok.save_sp_vocab(p)
    tok2 = UnigramTokenizer.load(p)
    assert tok2.vocab == tok.vocab
    assert tok2.encode("山水水") == tok.encode("山水水")
    # JSON save format roundtrip too
    pj = tmp_path / "uni.json"
    tok.save(pj)
    tok3 = UnigramTokenizer.load(pj)
    assert tok3.vocab == tok.vocab


def test_pipeline_and_bundle_wiring(tmp_path):
    """data.unigram_vocab routes build_tokenizer_for to the unigram vocab
    and sizes the CTC head; bundle save/load restores the same tokenizer."""
    from jiao_liao_asr.data.manifest import (
        Manifest,
        ManifestRow,
    )
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.train.engine import (
        build_tokenizer_for,
    )
    from jiao_liao_asr.utils.config import (
        CTCModelConfig,
        ExperimentConfig,
    )

    texts = ["胶辽官话", "官话识别", "胶辽识别"] * 4
    tok = UnigramTokenizer.train(texts, vocab_size=20)
    vp = tmp_path / "uni.json"
    tok.save(vp)

    config = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=8, d_model=32, num_layers=1, num_heads=2, mlp_dim=64,
            conv_channels=8, ),
    )
    config.data.unigram_vocab = str(vp)
    manifest = Manifest([ManifestRow(audio="x.wav", text=t) for t in texts])
    got = build_tokenizer_for(config, manifest)
    assert isinstance(got, UnigramTokenizer)
    assert config.ctc_model.vocab_size == len(got)

    params = ModelBundle._init_params(config)
    bundle = ModelBundle(config=config, params=params, tokenizer=got)
    out = tmp_path / "ckpt"
    bundle.save(str(out))
    loaded = ModelBundle.load(checkpoint=str(out))
    assert isinstance(loaded.tokenizer, UnigramTokenizer)
    assert loaded.tokenizer.vocab == got.vocab
    assert loaded.tokenizer.encode("官话") == got.encode("官话")
