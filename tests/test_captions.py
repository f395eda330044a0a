"""SRT/WebVTT caption rendering (utils/captions.py): cue grouping splits on
silence gaps / duration / line length, and both formats carry the exact
millisecond stamps in their spec's syntax."""

from jiao_liao_asr.utils.captions import (
    format_srt,
    format_vtt,
    group_cues,
)


def _tok(t, s, e):
    return {"token": t, "start": s, "end": e}


def test_group_cues_splits_on_gap_duration_and_length():
    toks = [
        _tok("你", 0.0, 0.2), _tok("好", 0.2, 0.4),
        _tok("吗", 1.5, 1.7),  # 1.1 s gap -> new cue
    ]
    cues = group_cues(toks, max_gap=0.6)
    assert [c["text"] for c in cues] == ["你好", "吗"]
    assert cues[0] == {"start": 0.0, "end": 0.4, "text": "你好"}

    # duration ceiling
    long = [_tok(str(i), i * 1.0, i * 1.0 + 1.0) for i in range(7)]
    cues = group_cues(long, max_gap=10.0, max_dur=3.0, max_chars=99)
    assert all(c["end"] - c["start"] <= 3.0 for c in cues)
    assert "".join(c["text"] for c in cues) == "0123456"

    # character ceiling
    chars = [_tok("字", i * 0.1, i * 0.1 + 0.1) for i in range(10)]
    cues = group_cues(chars, max_gap=10.0, max_dur=99.0, max_chars=4)
    assert [len(c["text"]) for c in cues] == [4, 4, 2]

    assert group_cues([]) == []


def test_group_words_merges_token_spans():
    from jiao_liao_asr.utils.captions import group_words

    # "你好" is one jieba/FMM word spanning two tokens; "吗" stays alone
    toks = [_tok("你", 0.0, 0.2), _tok("好", 0.2, 0.4), _tok("吗", 0.5, 0.7)]
    words = group_words(toks)
    assert "".join(w["word"] for w in words) == "你好吗"
    assert words[0]["start"] == 0.0
    # the word covering the last char ends at that token's end
    assert words[-1]["end"] == 0.7
    # spans are monotone and each word's span covers its tokens
    last = 0.0
    for w in words:
        assert last <= w["start"] < w["end"]
        last = w["end"]

    # multi-char tokens (BPE) keep offset math consistent
    toks = [_tok("你好", 0.0, 0.4), _tok("吗", 0.5, 0.7)]
    words = group_words(toks)
    assert "".join(w["word"] for w in words) == "你好吗"

    assert group_words([]) == []


def test_format_srt_and_vtt():
    cues = [
        {"start": 0.0, "end": 1.5, "text": "你好"},
        {"start": 61.25, "end": 3661.999, "text": "再见"},
    ]
    srt = format_srt(cues)
    assert srt.split("\n\n")[0] == "1\n00:00:00,000 --> 00:00:01,500\n你好"
    assert "2\n00:01:01,250 --> 01:01:01,999\n再见" in srt

    vtt = format_vtt(cues)
    assert vtt.startswith("WEBVTT\n\n")
    assert "00:00:00.000 --> 00:00:01.500\n你好" in vtt
    assert "00:01:01.250 --> 01:01:01.999\n再见" in vtt
