"""Continuous-batching serving engine (serve/engine.py).

The reference serves static batches through transformers generate()
(SURVEY.md 3.2) — the whole batch waits for its longest utterance. The
engine keeps a fixed slot pool and admits utterances mid-flight, so every
decode position is per-row. These tests pin:

* update_cache_rows: the per-row scatter == lax.dynamic_update_slice when
  every row shares the position, and writes land on the right rows when
  they don't (packed [B,T,d] and head-major [B,H,T,dh]+scale layouts);
* decode_step with a [B] position VECTOR == decode_step with the scalar;
* engine text output == ModelBundle.transcribe (offline greedy) — aligned
  lanes, ragged mid-flight admission, quantized int8 bundles, and
  long-form chunk re-joining;
* the CTC family is rejected loudly (single forward pass, nothing to lane).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.models.layers import update_cache_rows


# --------------------------------------------------------------- fixtures
EOT = 2
PROMPT = (1, 3)


def _tiny_bundle(vocab_size=96, decoder_layers=2):
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import (
        ExperimentConfig,
        WhisperConfig,
    )

    cfg = ExperimentConfig(
        model_family="whisper",
        whisper=WhisperConfig(
            vocab_size=vocab_size, d_model=64, encoder_layers=1,
            decoder_layers=decoder_layers, num_heads=2, mlp_dim=128,
            max_source_positions=32, max_target_positions=16,
            prompt_ids=PROMPT, eot_id=EOT, dtype="float32",
        ),
    )
    cfg.frontend.chunk_seconds = 0.64
    cfg.decode.max_decode_len = 12
    params = ModelBundle._init_params(cfg)
    # real vocab covering the model ids so texts genuinely distinguish
    # token sequences (ids <= 1 and >= len(vocab) decode to nothing)
    vocab = [chr(0x4E00 + i) for i in range(vocab_size - 2)]
    return ModelBundle(
        config=cfg, params=params, tokenizer=CharTokenizer(vocab)
    )


def _wavs(n, seed=0, seconds=0.6):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(int(16000 * seconds)).astype(np.float32) * 0.1
        for _ in range(n)
    ]


# ------------------------------------------------------ update_cache_rows
def test_update_cache_rows_vector_matches_scalar():
    """When every row shares the position, the [B] vector path must equal
    the scalar lax.dynamic_update_slice path — packed and head-major."""
    rng = np.random.RandomState(0)
    B, H, T, dh = 3, 2, 8, 4
    packed = jnp.asarray(rng.randn(B, T, H * dh).astype(np.float32))
    new_p = jnp.asarray(rng.randn(B, 1, H * dh).astype(np.float32))
    hm = jnp.asarray(rng.randn(B, H, T, dh).astype(np.float32))
    new_h = jnp.asarray(rng.randn(B, H, 1, dh).astype(np.float32))
    scale = jnp.asarray(rng.randn(B, H, T).astype(np.float32))
    new_s = jnp.asarray(rng.randn(B, H, 1).astype(np.float32))
    for idx in (0, 3, T - 1):
        vec = jnp.full((B,), idx, jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(update_cache_rows(packed, new_p, idx, 1)),
            np.asarray(update_cache_rows(packed, new_p, vec, 1)),
        )
        np.testing.assert_array_equal(
            np.asarray(update_cache_rows(hm, new_h, idx, 2)),
            np.asarray(update_cache_rows(hm, new_h, vec, 2)),
        )
        np.testing.assert_array_equal(
            np.asarray(update_cache_rows(scale, new_s, idx, 2)),
            np.asarray(update_cache_rows(scale, new_s, vec, 2)),
        )


def test_update_cache_rows_ragged_rows():
    """Distinct per-row positions: each batch row's write lands at ITS
    index and nothing else moves."""
    rng = np.random.RandomState(1)
    B, H, T, dh = 3, 2, 8, 4
    idx = jnp.asarray([0, 5, 7], jnp.int32)

    packed = jnp.asarray(rng.randn(B, T, H * dh).astype(np.float32))
    new_p = jnp.asarray(rng.randn(B, 1, H * dh).astype(np.float32))
    out = np.asarray(update_cache_rows(packed, new_p, idx, 1))
    ref = np.asarray(packed).copy()
    for b in range(B):
        ref[b, int(idx[b])] = np.asarray(new_p)[b, 0]
    np.testing.assert_array_equal(out, ref)

    hm = jnp.asarray(rng.randn(B, H, T, dh).astype(np.float32))
    new_h = jnp.asarray(rng.randn(B, H, 1, dh).astype(np.float32))
    out = np.asarray(update_cache_rows(hm, new_h, idx, 2))
    ref = np.asarray(hm).copy()
    for b in range(B):
        ref[b, :, int(idx[b])] = np.asarray(new_h)[b, :, 0]
    np.testing.assert_array_equal(out, ref)

    with pytest.raises(ValueError, match="time_axis"):
        update_cache_rows(hm, new_h, idx, 3)


# ------------------------------------------------------ decode_step vector pos
def test_decode_step_vector_pos_matches_scalar():
    """A [B] all-equal position vector must produce the same logits and the
    same cache contents as the scalar position."""
    from jiao_liao_asr.models.whisper import WhisperModel

    bundle = _tiny_bundle()
    model = WhisperModel(bundle.config.whisper)
    params = bundle.params
    rng = np.random.RandomState(2)
    B = 3
    mel = jnp.asarray(rng.randn(B, 80, 64).astype(np.float32) * 0.3)
    enc = model.apply({"params": params}, mel, method=model.encode)
    caches = model.apply(
        {"params": params}, B, enc, 12, method=model.init_cache
    )

    # prime two scalar steps so position 2 sees a non-trivial cache
    toks = jnp.asarray(rng.randint(2, 90, (B, 3)), jnp.int32)
    c_s = c_v = caches
    for p in range(2):
        _, c_s = model.apply(
            {"params": params}, toks[:, p : p + 1], jnp.int32(p), enc, c_s,
            method=model.decode_step,
        )
        _, c_v = model.apply(
            {"params": params}, toks[:, p : p + 1],
            jnp.full((B,), p, jnp.int32), enc, c_v,
            method=model.decode_step,
        )
    lg_s, c_s = model.apply(
        {"params": params}, toks[:, 2:3], jnp.int32(2), enc, c_s,
        method=model.decode_step,
    )
    lg_v, c_v = model.apply(
        {"params": params}, toks[:, 2:3], jnp.full((B,), 2, jnp.int32),
        enc, c_v, method=model.decode_step,
    )
    np.testing.assert_array_equal(np.asarray(lg_s), np.asarray(lg_v))
    for leaf_s, leaf_v in zip(
        jax.tree_util.tree_leaves(c_s), jax.tree_util.tree_leaves(c_v)
    ):
        np.testing.assert_array_equal(np.asarray(leaf_s), np.asarray(leaf_v))


# -------------------------------------------------------------- the engine
def test_serving_engine_matches_offline_greedy():
    """5 utterances through a 2-slot pool (mid-flight admission as lanes
    free) == offline batched greedy transcribe, text for text."""
    from jiao_liao_asr.serve import ServingEngine

    bundle = _tiny_bundle()
    wavs = _wavs(5, seed=3)
    ref = bundle.transcribe(wavs)
    eng = ServingEngine(bundle, slots=2, steps_per_dispatch=4, max_len=12)
    got = eng.transcribe(wavs)
    assert got == ref
    assert eng.stats.completed == 5
    assert eng.stats.dispatches >= 3  # 2 lanes cannot take 5 in one wave
    assert len(eng.stats.latencies_s) == 5
    assert eng.stats.p95_latency_s >= eng.stats.mean_latency_s >= 0.0


def test_serving_engine_timestamps_match_offline_timed():
    """timestamps=True: each finished request carries per-token spans equal
    to bundle.transcribe_timed's (same alignment, same window)."""
    from jiao_liao_asr.serve import ServingEngine

    bundle = _tiny_bundle()
    wavs = _wavs(3, seed=5)
    eng = ServingEngine(
        bundle, slots=2, steps_per_dispatch=4, max_len=12, timestamps=True
    )
    rids = [eng.submit(w) for w in wavs]
    got = {}
    while eng.in_flight:
        for req in eng.step():
            got[req.rid] = req
    for rid, wav in zip(rids, wavs):
        req = got[rid]
        want = bundle.transcribe_timed(wav, sample_rate=16000)[0]
        assert req.timed == want
        assert "".join(t["token"] for t in req.timed) == req.text


def test_serving_engine_ragged_midflight_admission():
    """Admit lane 1 while lane 0 is several tokens deep — the slots sit at
    genuinely different positions in the same dispatch — and both texts
    still match offline greedy."""
    from jiao_liao_asr.serve import ServingEngine

    bundle = _tiny_bundle()
    wavs = _wavs(2, seed=4)
    ref = bundle.transcribe(wavs)

    eng = ServingEngine(bundle, slots=2, steps_per_dispatch=3, max_len=12)
    r0 = eng.submit(wavs[0])
    eng._dispatch_and_harvest()  # lane 0 advances 3 tokens alone
    pos_before = int(np.asarray(eng._pos)[0])
    r1 = eng.submit(wavs[1])  # admitted at position 0 mid-flight
    assert int(np.asarray(eng._pos)[1]) == 0 and pos_before > 0
    texts = eng.drain()
    assert [texts[r0], texts[r1]] == ref


def test_serving_engine_step_api():
    """step() harvests finished requests incrementally (with timestamps),
    in_flight tracks queued + laned work, and drain() composes on step()."""
    from jiao_liao_asr.serve import ServingEngine

    bundle = _tiny_bundle()
    wavs = _wavs(3, seed=7)
    ref = bundle.transcribe(wavs)
    eng = ServingEngine(bundle, slots=2, steps_per_dispatch=16, max_len=12)
    assert eng.in_flight == 0 and eng.step() == []
    rids = [eng.submit(w) for w in wavs]
    assert eng.in_flight == 3
    got = {}
    while eng.in_flight:
        for req in eng.step():
            assert req.finished_at >= req.started_at >= req.submitted_at
            got[req.rid] = req.text
    assert [got[r] for r in rids] == ref


def test_serving_engine_quantized_bundle():
    """quantize() -> ServingEngine composes: int8 decoder weights + int8
    cross caches stream through the slot pool and match the quantized
    offline transcribe."""
    from jiao_liao_asr.serve import ServingEngine

    bundle = _tiny_bundle(decoder_layers=1)
    qb = bundle.quantize()
    wavs = _wavs(3, seed=5)
    ref = qb.transcribe(wavs)
    eng = ServingEngine(qb, slots=2, steps_per_dispatch=4, max_len=12)
    assert eng.transcribe(wavs) == ref


def test_serving_engine_long_form_chunking():
    """A recording longer than the model window splits into consecutive
    windows and re-joins per utterance, matching bundle.transcribe's
    long-form semantics (SURVEY 5.7)."""
    from jiao_liao_asr.serve import ServingEngine

    bundle = _tiny_bundle()
    rng = np.random.RandomState(6)
    long_wav = rng.randn(int(16000 * 1.5)).astype(np.float32) * 0.1  # 3 windows
    short = rng.randn(int(16000 * 0.4)).astype(np.float32) * 0.1
    ref = bundle.transcribe([long_wav, short])
    eng = ServingEngine(bundle, slots=2, steps_per_dispatch=4, max_len=12)
    got = eng.transcribe([long_wav, short])
    assert got == ref
    assert eng.stats.completed == 4  # 3 windows + 1


def test_serving_engine_rejects_ctc_family():
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.serve import ServingEngine
    from jiao_liao_asr.utils.config import ExperimentConfig

    cfg = ExperimentConfig(model_family="ctc")
    cfg.ctc_model.d_model = 64
    cfg.ctc_model.num_layers = 1
    cfg.ctc_model.num_heads = 2
    cfg.ctc_model.mlp_dim = 128
    cfg.ctc_model.vocab_size = 8
    cfg.ctc_model.conv_channels = 16
    cfg.ctc_model.max_frames = 256
    params = ModelBundle._init_params(cfg)
    bundle = ModelBundle(config=cfg, params=params, tokenizer=None)
    with pytest.raises(ValueError, match="CTC"):
        ServingEngine(bundle)
