"""Byte-level BPE tokenizer tests: round-trip on a hand-built vocab,
pretokenizer behavior, C++ merge-loop parity with the Python reference,
and (when torch/transformers fixtures allow) GPT-2 merge semantics."""

import json

import numpy as np
import pytest

from jiao_liao_asr.data.bpe import (
    ByteLevelBPE,
    bytes_to_unicode,
    gpt2_pretokenize,
)


def _tiny_bpe():
    """Vocab: all 256 byte chars + a few merges over 'hello world 你好'."""
    b2u = bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(b2u.values())}

    def tok(s):  # text -> mapped symbol string
        return "".join(b2u[b] for b in s.encode("utf-8"))

    merges = []
    for pair in [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
                 ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d")]:
        merges.append(pair)
        joined = pair[0] + pair[1]
        if joined not in vocab:
            vocab[joined] = len(vocab)
    sp = tok(" ")
    for pair in [(sp, "hello"), (sp, "world")]:
        merges.append(pair)
        joined = pair[0] + pair[1]
        if joined not in vocab:
            vocab[joined] = len(vocab)
    vocab["<|eot|>"] = len(vocab)
    return ByteLevelBPE(vocab, merges, {"<|eot|>": vocab["<|eot|>"]})


def test_roundtrip_ascii_and_cjk():
    bpe = _tiny_bpe()
    for text in ["hello world", "hello hello world", "你好世界", "mix 你好 hello"]:
        ids = bpe.encode(text)
        assert bpe.decode(ids) == text, text


def test_merges_applied():
    bpe = _tiny_bpe()
    ids = bpe.encode("hello world")
    # 'hello' merges to 1 token; ' world' merges to 1 token
    assert len(ids) == 2


def test_specials_skipped_in_decode():
    bpe = _tiny_bpe()
    eot = bpe.special["<|eot|>"]
    ids = bpe.encode("hello") + [eot]
    assert bpe.decode(ids) == "hello"
    assert "<|eot|>" in bpe.decode(ids, skip_special=False)


def test_pretokenize_shapes():
    toks = gpt2_pretokenize("hello world, it's 42 你好!")
    assert "".join(toks) == "hello world, it's 42 你好!"
    assert " world" in toks
    assert "'s" in toks
    assert " 42" in toks


def test_pretokenize_matches_gpt2_regex():
    """Cross-check the state machine against the canonical regex when the
    `regex` package is available (it is not pinned; skip otherwise)."""
    regex = pytest.importorskip("regex")
    pat = regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
    cases = [
        "hello world",
        "it's 42  spaces\tand\nnewlines",
        "你好，世界！ Mixed 语言 text42 ...",
        "  leading and trailing  ",
        "don't stop-me now!!!",
    ]
    for text in cases:
        assert gpt2_pretokenize(text) == pat.findall(text), text


def test_native_matches_python(tmp_path):
    from jiao_liao_asr.utils import native_ext

    if not native_ext.native_available("bpe"):
        pytest.skip("native bpe lib not built")
    bpe = _tiny_bpe()
    assert bpe._native is not None
    texts = ["hello world", "你好 hello world hello", "wwworld hhello"]
    for text in texts:
        ids_native = bpe.encode(text)
        bpe_py = ByteLevelBPE(bpe.vocab, [m for m, _ in sorted(bpe.ranks.items(), key=lambda kv: kv[1])], bpe.special)
        bpe_py._native = None
        assert ids_native == bpe_py.encode(text), text


def test_specials_protected_in_encode():
    """<|...|> specials in input text map to their reserved ids (and can be
    disabled for untrusted text)."""
    bpe = _tiny_bpe()
    eot = bpe.special["<|eot|>"]
    ids = bpe.encode("hello<|eot|>world")
    assert eot in ids
    i = ids.index(eot)
    assert bpe.decode(ids[:i]) == "hello"
    assert bpe.decode(ids[i + 1:]) == "world"
    # untrusted mode: treated as plain text, no special id emitted
    ids2 = bpe.encode("hello<|eot|>world", allow_special=False)
    assert eot not in ids2
