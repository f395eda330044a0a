"""Per-token timestamps from the CTC frame alignment.

Pins: the collapse-with-times emission rule (identical token sequence to
ctc_greedy_collapse, spans = runs of equal frames), transcribe_timed's
text == transcribe's text with monotone non-overlapping spans (including
across long-form chunk boundaries), and streaming timed_tokens ==
transcribe_timed when the utterance fits one window.
"""

import numpy as np
import pytest

from jiao_liao_asr.decode.ctc import (
    ctc_collapse_with_times,
    ctc_greedy_collapse,
)


def test_collapse_with_times_rule():
    # frames: 1 1 0 1 2 2 0 0 3
    ids = np.array([1, 1, 0, 1, 2, 2, 0, 0, 3])
    got = ctc_collapse_with_times(ids, len(ids), blank_id=0)
    assert got == [(1, 0, 2), (1, 3, 4), (2, 4, 6), (3, 8, 9)]
    # truncated length stops mid-run
    assert ctc_collapse_with_times(ids, 5, 0) == [(1, 0, 2), (1, 3, 4), (2, 4, 5)]
    assert ctc_collapse_with_times(ids, 0, 0) == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collapse_with_times_matches_device_collapse(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 4, size=(3, 50)).astype(np.int32)
    lens = np.array([50, 17, 0], np.int32)
    dev_ids, dev_lens = ctc_greedy_collapse(ids, lens, 0)
    dev_ids, dev_lens = np.asarray(dev_ids), np.asarray(dev_lens)
    for b in range(3):
        timed = ctc_collapse_with_times(ids[b], lens[b], 0)
        assert [t for t, _, _ in timed] == list(dev_ids[b][: dev_lens[b]])
        # spans are monotone, non-overlapping, inside the valid frames
        last = 0
        for _, s, e in timed:
            assert last <= s < e <= lens[b]
            last = e


def _bundle(chunk_seconds=2.56):
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import (
        CTCModelConfig,
        ExperimentConfig,
    )

    cfg = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=8, d_model=32, num_layers=2, num_heads=2,
            mlp_dim=64, conv_channels=16, dropout=0.0,
        ),
    )
    cfg.frontend.chunk_seconds = chunk_seconds
    params = ModelBundle._init_params(cfg)
    return ModelBundle(
        config=cfg, params=params,
        tokenizer=CharTokenizer([chr(0x4E00 + i) for i in range(6)]),
    )


def test_transcribe_timed_matches_text():
    bundle = _bundle()
    rng = np.random.RandomState(3)
    audio = (rng.randn(int(16000 * 1.6)) * 0.1).astype(np.float32)
    text = bundle.transcribe(audio)[0]
    timed = bundle.transcribe_timed(audio)[0]
    assert "".join(t["token"] for t in timed) == text
    last = 0.0
    for t in timed:
        assert last <= t["start"] < t["end"]
        last = t["end"]


def test_transcribe_timed_long_form_offsets():
    # 2 chunks: second chunk's tokens start at >= chunk_seconds
    bundle = _bundle(chunk_seconds=1.28)
    rng = np.random.RandomState(4)
    audio = (rng.randn(int(16000 * 2.2)) * 0.1).astype(np.float32)
    text = bundle.transcribe(audio)[0]
    timed = bundle.transcribe_timed(audio)[0]
    assert "".join(t["token"] for t in timed) == text
    assert any(t["start"] >= 1.28 for t in timed)  # tokens from chunk 2


def test_streaming_timed_tokens_match_offline():
    from jiao_liao_asr.serve.streaming import (
        StreamingConfig,
        StreamingTranscriber,
    )

    bundle = _bundle()
    rng = np.random.RandomState(5)
    audio = (rng.randn(int(16000 * 1.28)) * 0.1).astype(np.float32)
    want = bundle.transcribe_timed(audio)[0]
    st = StreamingTranscriber(
        bundle, StreamingConfig(window_seconds=2.56, hop_seconds=2.56,
                                lookahead_seconds=0.0),
    )
    st.feed(audio)
    st.finish()
    assert st.timed_tokens == want

    from jiao_liao_asr.utils.captions import group_words

    assert st.timed_words == group_words(want)
    assert "".join(w["word"] for w in st.timed_words) == st.text


# ------------------------------------------- whisper cross-attention DTW
def test_dtw_spans_recover_peaked_alignment():
    """Tokens whose attention is concentrated on known frame runs must get
    spans containing their peaks, contiguous and in order."""
    from jiao_liao_asr.decode.align import dtw_spans

    S, T = 3, 12
    peaks = [(1, 3), (5, 7), (9, 11)]
    A = np.full((S, T), 1e-3)
    for i, (a, b) in enumerate(peaks):
        A[i, a:b] = 1.0
    A /= A.sum(axis=1, keepdims=True)
    spans = dtw_spans(A)
    assert len(spans) == S
    last_end = 0
    for (s, e), (a, b) in zip(spans, peaks):
        assert s == last_end  # contiguous, non-overlapping
        assert e > s
        # the span covers the token's attention peak
        assert s <= int(np.argmax(A[peaks.index((a, b))])) < e
        last_end = e
    assert last_end == T

    # degenerate shapes
    assert dtw_spans(np.zeros((0, 5))) == []
    assert dtw_spans(np.ones((1, 4)) / 4.0) == [(0, 4)]


@pytest.mark.parametrize("seed", range(5))
def test_dtw_spans_always_valid(seed):
    """Property: for any row-stochastic matrix with T >= S, spans are
    contiguous, non-overlapping, cover [0, T) exactly, and each token gets
    >= 1 frame; for T < S (pathological) starts stay non-decreasing."""
    from jiao_liao_asr.decode.align import dtw_spans

    rng = np.random.RandomState(seed)
    S = rng.randint(1, 12)
    T = rng.randint(1, 40)
    A = rng.dirichlet(np.ones(T), size=S)
    spans = dtw_spans(A)
    assert len(spans) == S
    if T >= S:
        prev_end = 0
        for s, e in spans:
            assert s == prev_end and e >= s + 1
            prev_end = e
        assert prev_end == T
    else:
        assert all(e >= s + 1 for s, e in spans)
        assert all(
            spans[i][0] <= spans[i + 1][0] for i in range(len(spans) - 1)
        )
        assert spans[-1][1] <= T + 1


def _whisper_bundle(chunk_seconds=0.64):
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import (
        ExperimentConfig,
        WhisperConfig,
    )

    # enc positions = chunk mel frames / 2 (conv stride 2)
    src = int(chunk_seconds * 16000 / 160) // 2
    cfg = ExperimentConfig(
        model_family="whisper",
        whisper=WhisperConfig(
            vocab_size=96, d_model=64, encoder_layers=1, decoder_layers=2,
            num_heads=2, mlp_dim=128, max_source_positions=src,
            max_target_positions=16, prompt_ids=(1, 3), eot_id=2,
            dtype="float32", ),
    )
    cfg.frontend.chunk_seconds = chunk_seconds
    cfg.decode.max_decode_len = 12
    params = ModelBundle._init_params(cfg)
    vocab = [chr(0x4E00 + i) for i in range(94)]
    return ModelBundle(
        config=cfg, params=params, tokenizer=CharTokenizer(vocab)
    )


def test_whisper_transcribe_timed_matches_text():
    bundle = _whisper_bundle()
    rng = np.random.RandomState(7)
    audio = (rng.randn(int(16000 * 0.6)) * 0.1).astype(np.float32)
    text = bundle.transcribe(audio)[0]
    timed = bundle.transcribe_timed(audio)[0]
    assert "".join(t["token"] for t in timed) == text
    assert len(timed) > 0  # the random model must actually emit tokens
    last = 0.0
    for t in timed:
        assert last <= t["start"] < t["end"]
        last = t["end"]
    # spans stay inside the audio's valid encoder frames (0.6 s + rounding)
    assert timed[-1]["end"] <= 0.62


def test_whisper_alignment_heads_select_subset():
    """alignment_heads=((layer, head), ...) restricts the DTW's attention
    average to those heads (HF generation_config semantics); rows stay a
    probability distribution and the selection actually changes the matrix."""
    import dataclasses

    import jax.numpy as jnp

    from jiao_liao_asr.decode.align import (
        cross_attention_matrix,
    )
    from jiao_liao_asr.frontend import features

    bundle = _whisper_bundle()
    fe = bundle.config.frontend
    rng = np.random.RandomState(9)
    wav = (rng.randn(int(16000 * 0.64)) * 0.1).astype(np.float32)
    mel = features.featurize_batch(jnp.asarray(wav[None]), fe)
    tokens = np.array([[1, 3, 10, 11, 12, 2]])

    wcfg = bundle.config.whisper
    A_all = cross_attention_matrix(wcfg, bundle.params, mel, tokens)
    sub = dataclasses.replace(wcfg, alignment_heads=((1, 0),))
    A_sub = cross_attention_matrix(sub, bundle.params, mel, tokens)
    for A in (A_all, A_sub):
        assert A.shape == (1, 6, 32)
        np.testing.assert_allclose(A.sum(axis=-1), 1.0, rtol=1e-5)
    assert np.abs(A_all - A_sub).max() > 1e-6  # the subset genuinely differs

    # alignment_heads pointing outside the model fail loudly
    bad = dataclasses.replace(wcfg, alignment_heads=((99, 0),))
    with pytest.raises(AssertionError, match="alignment_heads"):
        cross_attention_matrix(bad, bundle.params, mel, tokens)


def test_hf_alignment_heads_roundtrip(tmp_path):
    """generation_config.json alignment_heads import -> WhisperConfig ->
    export writes them back in HF layout."""
    import dataclasses
    import json as _json

    from jiao_liao_asr.models.whisper_import import (
        load_hf_generation_constraints,
    )

    (tmp_path / "generation_config.json").write_text(_json.dumps({
        "suppress_tokens": [5], "begin_suppress_tokens": [],
        "alignment_heads": [[0, 1], [1, 0]],
    }))
    gc = load_hf_generation_constraints(tmp_path)
    assert gc["alignment_heads"] == ((0, 1), (1, 0))

    from jiao_liao_asr.models.whisper_import import (
        export_hf_checkpoint,
    )

    bundle = _whisper_bundle()
    cfg = dataclasses.replace(
        bundle.config,
        whisper=dataclasses.replace(
            bundle.config.whisper, alignment_heads=gc["alignment_heads"]
        ),
    )
    bundle = dataclasses.replace(bundle, config=cfg)
    out = export_hf_checkpoint(bundle, tmp_path / "hf")
    data = _json.loads((out / "generation_config.json").read_text())
    assert data["alignment_heads"] == [[0, 1], [1, 0]]

    # config YAML roundtrip keeps the pairs iterable (saved checkpoints)
    from jiao_liao_asr.utils.config import (
        load_config,
        save_config,
    )

    save_config(cfg, str(tmp_path / "cfg.json"))
    back = load_config(str(tmp_path / "cfg.json"))
    assert [tuple(p) for p in back.whisper.alignment_heads] == [(0, 1), (1, 0)]


def test_whisper_timed_with_wf_adapter():
    """The alignment capture reads q/k through WFDense, so a WFAdapter-
    injected whisper model (the paper's fine-tuning config) aligns with the
    adapter's contribution included — text still matches transcribe."""
    import dataclasses

    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import AdapterConfig

    base = _whisper_bundle()
    cfg = dataclasses.replace(
        base.config,
        whisper=dataclasses.replace(
            base.config.whisper, adapter=AdapterConfig(kind="wf", wf_rank=2)
        ),
    )
    params = ModelBundle._init_params(cfg)
    bundle = ModelBundle(
        config=cfg, params=params,
        tokenizer=CharTokenizer([chr(0x4E00 + i) for i in range(94)]),
    )
    rng = np.random.RandomState(12)
    audio = (rng.randn(int(16000 * 0.6)) * 0.1).astype(np.float32)
    text = bundle.transcribe(audio)[0]
    timed = bundle.transcribe_timed(audio)[0]
    assert "".join(t["token"] for t in timed) == text


def test_whisper_timed_on_quantized_bundle():
    """transcribe_timed works on an int8-quantized serving bundle (the
    teacher-forced capture reads q/k through WFDense's dense_q dequant) and
    its text matches the quantized bundle's own transcribe."""
    bundle = _whisper_bundle().quantize()
    rng = np.random.RandomState(11)
    audio = (rng.randn(int(16000 * 0.6)) * 0.1).astype(np.float32)
    text = bundle.transcribe(audio)[0]
    timed = bundle.transcribe_timed(audio)[0]
    assert "".join(t["token"] for t in timed) == text
    assert all(t["start"] < t["end"] for t in timed)


def test_whisper_transcribe_timed_long_form_offsets():
    bundle = _whisper_bundle(chunk_seconds=0.64)
    rng = np.random.RandomState(8)
    audio = (rng.randn(int(16000 * 1.1)) * 0.1).astype(np.float32)
    text = bundle.transcribe(audio)[0]
    timed = bundle.transcribe_timed(audio)[0]
    assert "".join(t["token"] for t in timed) == text
    assert any(t["start"] >= 0.64 for t in timed)  # tokens from chunk 2
