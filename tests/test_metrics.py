"""Metric parity tests (SURVEY.md §4.5): CER/WER semantics vs brute force
and, when available, vs jiwer-style formulas on fixture pairs."""

import numpy as np
import pytest

from jiao_liao_asr.evals import (
    cer,
    corpus_cer,
    corpus_wer,
    edit_distance,
    edit_ops,
    normalize_text,
    segment_words,
    wer,
)


def brute_edit(a, b):
    n, m = len(a), len(b)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i][j] = min(
                dp[i - 1][j - 1] + (a[i - 1] != b[j - 1]),
                dp[i - 1][j] + 1,
                dp[i][j - 1] + 1,
            )
    return dp[n][m]


def test_edit_distance_vs_bruteforce(rng):
    alphabet = list("abcde")
    for _ in range(200):
        a = [alphabet[i] for i in rng.randint(0, 5, rng.randint(0, 12))]
        b = [alphabet[i] for i in rng.randint(0, 5, rng.randint(0, 12))]
        assert edit_distance(a, b) == brute_edit(a, b)


def test_edit_ops_consistent(rng):
    for _ in range(50):
        a = list(map(str, rng.randint(0, 4, rng.randint(1, 10))))
        b = list(map(str, rng.randint(0, 4, rng.randint(1, 10))))
        h, s, d, i = edit_ops(a, b)
        assert s + d + i == brute_edit(a, b)
        assert h + s + d == len(a)
        assert h + s + i == len(b)


def test_cer_basic():
    assert cer("今天天气", "今天天气") == 0.0
    assert cer("今天天气", "今天天器") == pytest.approx(0.25)
    # insertion
    assert cer("abc", "abcd") == pytest.approx(1 / 3)
    # punctuation/whitespace stripped by normalization
    assert cer("今天,天气!", "今天天气") == 0.0


def test_normalize_text():
    assert normalize_text("Hello, 世界！　ＡＢＣ") == "hello世界abc"
    assert normalize_text("a b", keep_spaces=True) == "a b"


def test_wer_jieba_segmentation():
    # jieba is pinned in the reference (requirements.txt:26); installed here.
    words = segment_words("我爱北京天安门")
    assert "".join(words) == "我爱北京天安门"
    assert len(words) >= 3  # segmentation actually splits
    assert wer("我爱北京天安门", "我爱北京天安门") == 0.0
    assert 0.0 < wer("我爱北京天安门", "我爱上海天安门") <= 1.0


def test_corpus_aggregation():
    refs = ["今天天气", "很好"]
    hyps = ["今天天器", "很好"]
    # corpus CER = total errors / total ref chars = 1/6
    assert corpus_cer(refs, hyps) == pytest.approx(1 / 6)
    assert corpus_wer(refs, refs) == 0.0


def test_empty_edge_cases():
    assert cer("", "") == 0.0
    assert cer("", "abc") == float("inf")
    assert cer("abc", "") == 1.0
