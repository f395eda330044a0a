"""Native C++ CTC prefix beam search (native/beam.cpp) against the exact
python host searcher — same merge semantics, multithreaded batching, and
the bundle 'beam' strategy dispatch."""

import numpy as np
import pytest

from jiao_liao_asr.utils import native_ext

pytestmark = pytest.mark.skipif(
    not native_ext.native_available("beam"), reason="native beam lib not built"
)


def _rand_log_probs(rng, B, T, V, peaked=0.0):
    x = rng.randn(B, T, V).astype(np.float32) * (1.0 + 3.0 * peaked)
    x = x - x.max(axis=-1, keepdims=True)
    lse = np.log(np.exp(x).sum(axis=-1, keepdims=True))
    return (x - lse).astype(np.float32)


@pytest.mark.parametrize("beam_size", [1, 4, 8])
def test_native_matches_host_exact(rng, beam_size):
    """topk >= V-1 -> no pruning on either side -> identical results."""
    from jiao_liao_asr.decode.ctc import (
        ctc_prefix_beam_search_host,
        ctc_prefix_beam_search_native,
    )

    B, T, V = 5, 24, 12
    lp = _rand_log_probs(rng, B, T, V)
    lengths = np.array([24, 20, 24, 7, 1], np.int32)
    ids_h, len_h = ctc_prefix_beam_search_host(
        lp, lengths, beam_size=beam_size, topk_tokens=V - 1
    )
    ids_n, len_n = ctc_prefix_beam_search_native(
        lp, lengths, beam_size=beam_size, topk_tokens=V - 1
    )
    np.testing.assert_array_equal(len_h, len_n)
    for b in range(B):
        np.testing.assert_array_equal(
            ids_h[b, : len_h[b]], ids_n[b, : len_n[b]], err_msg=f"utt {b}"
        )


def test_native_beam1_equals_greedy_on_peaked(rng):
    """On well-separated frames, beam search must agree with greedy."""
    from jiao_liao_asr.decode.ctc import (
        ctc_greedy_decode,
        ctc_prefix_beam_search_native,
    )

    B, T, V = 3, 16, 20
    lp = _rand_log_probs(rng, B, T, V, peaked=4.0)
    lengths = np.full((B,), T, np.int32)
    g_ids, g_len = map(np.asarray, ctc_greedy_decode(lp, lengths))
    n_ids, n_len = ctc_prefix_beam_search_native(lp, lengths, beam_size=4)
    for b in range(B):
        np.testing.assert_array_equal(g_ids[b, : g_len[b]], n_ids[b, : n_len[b]])


def test_native_threads_deterministic(rng):
    from jiao_liao_asr.decode.ctc import (
        ctc_prefix_beam_search_native,
    )

    B, T, V = 16, 40, 30
    lp = _rand_log_probs(rng, B, T, V)
    lengths = np.full((B,), T, np.int32)
    a = ctc_prefix_beam_search_native(lp, lengths, beam_size=8, n_threads=1)
    b = ctc_prefix_beam_search_native(lp, lengths, beam_size=8, n_threads=8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_bundle_beam_strategy_uses_native(tmp_path, rng, tiny_wav):
    """End-to-end: transcribe with strategy='beam' routes through the C++
    engine (no LM) and returns deterministic text."""
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import (
        CTCModelConfig,
        DecodeConfig,
        ExperimentConfig,
    )

    tok = CharTokenizer.build(["你好世界测试"])
    cfg = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=len(tok), d_model=64, num_layers=1, num_heads=4,
            mlp_dim=128, conv_channels=16, ),
    )
    cfg.frontend.chunk_seconds = 2.0
    bundle = ModelBundle(
        config=cfg, params=ModelBundle._init_params(cfg), tokenizer=tok
    )
    beam = bundle.transcribe(tiny_wav, decode_cfg=DecodeConfig(strategy="beam"))
    beam2 = bundle.transcribe(tiny_wav, decode_cfg=DecodeConfig(strategy="beam"))
    assert beam == beam2
    assert isinstance(beam[0], str)


def test_pruned_beam_matches_exact_on_peaked(rng):
    """prune_logp < 0 drops only negligible-mass candidates: on peaked
    (trained-like) posteriors the pruned search returns the exact result,
    and a blank-dominated corpus exercises the O(beams) fast path."""
    from jiao_liao_asr.decode.ctc import (
        ctc_prefix_beam_search_native,
    )

    B, T, V = 6, 32, 16
    lp = _rand_log_probs(rng, B, T, V, peaked=4.0)
    # make half the frames blank-dominated (the production regime)
    lp[:, ::2, 0] = -0.01
    lp[:, ::2, 1:] = np.log(
        np.maximum(1.0 - np.exp(-0.01), 1e-9) / (V - 1)
    )
    lengths = np.full((B,), T, np.int32)
    exact = ctc_prefix_beam_search_native(lp, lengths, beam_size=8)
    pruned = ctc_prefix_beam_search_native(
        lp, lengths, beam_size=8, prune_logp=-10.0
    )
    np.testing.assert_array_equal(exact[1], pruned[1])
    np.testing.assert_array_equal(exact[0], pruned[0])


def test_prune_zero_is_noop(rng):
    from jiao_liao_asr.decode.ctc import (
        ctc_prefix_beam_search_native,
    )

    B, T, V = 4, 20, 10
    lp = _rand_log_probs(rng, B, T, V)
    lengths = np.full((B,), T, np.int32)
    a = ctc_prefix_beam_search_native(lp, lengths, beam_size=8, prune_logp=0.0)
    b = ctc_prefix_beam_search_native(lp, lengths, beam_size=8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
