"""Weight-only int8 decode quantization (ops/quant.py + ModelBundle.quantize).

The serving transform for memory-bound whisper AR decode: decoder Dense
kernels become int8 + per-output-channel scales, and the int8 KV caches
carry per-position scales that the attention folds in elementwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jiao_liao_asr.ops import quant as Q


def test_quantize_int8_roundtrip_error_bound():
    rng = np.random.RandomState(0)
    w = jnp.asarray(rng.randn(64, 48).astype(np.float32) * 0.07)
    q, scale = Q.quantize_int8(w)
    assert q.dtype == jnp.int8 and scale.shape == (48,)
    deq = np.asarray(q, np.float32) * np.asarray(scale)[None, :]
    # symmetric rounding: error <= half a quantization step per element
    err = np.abs(deq - np.asarray(w))
    assert np.all(err <= 0.5 * np.asarray(scale)[None, :] + 1e-8)


def test_quantize_int8_zero_channel():
    w = jnp.zeros((16, 4), jnp.float32)
    q, scale = Q.quantize_int8(w)
    assert np.all(np.asarray(q) == 0) and np.all(np.asarray(scale) == 0)


def test_int8_matmul_long_rows_takes_xla_path():
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, 100, 64).astype(np.float32), jnp.bfloat16)
    w = jnp.asarray(rng.randn(64, 32).astype(np.float32) * 0.1)
    q, scale = Q.quantize_int8(w)
    out = Q.int8_matmul(x, q, scale)
    assert out.shape == (2, 100, 32) and out.dtype == x.dtype
    want = np.asarray(x, np.float32) @ (
        np.asarray(q, np.float32) * np.asarray(scale)[None, :]
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), want, atol=3e-2, rtol=2e-2
    )


def test_int8_cross_attention_matches_dequantized_reference():
    """layers._int8_cache_attention (mul-reduce over int8 caches) must match
    plain f32 attention over the dequantized caches, and the caches must
    carry per-position scales that reconstruct K/V to int8 accuracy."""
    from jiao_liao_asr.models.layers import (
        _int8_cache_attention as _int8_cross_attention,
    )

    rng = np.random.RandomState(5)
    B, H, Tq, Tk, dh = 2, 3, 1, 17, 8
    q = jnp.asarray(rng.randn(B, H, Tq, dh).astype(np.float32))
    k = rng.randn(B, H, Tk, dh).astype(np.float32)
    v = rng.randn(B, H, Tk, dh).astype(np.float32)
    kq, ks = Q.quantize_kv(k)
    vq, vs = Q.quantize_kv(v)
    lens = np.array([Tk, 11])
    mask = jnp.asarray(np.arange(Tk)[None, None, None, :] < lens[:, None, None, None])

    got = _int8_cross_attention(
        q, kq, ks, vq, vs, jnp.asarray(lens, jnp.int32), None, jnp.float32
    )
    # mask-only call (no threaded lengths) must take the exact masked path
    # and agree with the threaded-lengths result
    got_mask = _int8_cross_attention(q, kq, ks, vq, vs, None, mask, jnp.float32)
    np.testing.assert_allclose(
        np.asarray(got_mask), np.asarray(got), atol=1e-6, rtol=1e-6
    )

    kd = np.asarray(kq, np.float32) * np.asarray(ks)[..., None]
    vd = np.asarray(vq, np.float32) * np.asarray(vs)[..., None]
    s = np.einsum("bhqd,bhkd->bhqk", np.asarray(q), kd) / np.sqrt(dh)
    s = np.where(np.asarray(mask), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bhkd->bhqd", p, vd)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5, rtol=2e-5)
    # int8 reconstruction of the original K is within half a step
    np.testing.assert_allclose(kd, k, atol=0.5 * np.abs(k).max() / 127 + 1e-7)


def test_int8_decode_attention_zero_length_row_is_finite():
    """A zero-length row must give a finite (uniform-softmax) output, not
    NaN — the int8 cache attention masks with finfo.min."""
    from jiao_liao_asr.models import layers as L

    rng = np.random.RandomState(9)
    B, H, Tq, Tk, dh = 2, 2, 1, 40, 16
    q = jnp.asarray(rng.randn(B, H, Tq, dh).astype(np.float32))
    kq, ks = Q.quantize_kv(rng.randn(B, H, Tk, dh).astype(np.float32))
    vq, vs = Q.quantize_kv(rng.randn(B, H, Tk, dh).astype(np.float32))
    lens = jnp.asarray([0, Tk], jnp.int32)
    out = np.asarray(
        L._int8_cache_attention(q, kq, ks, vq, vs, lens, None, jnp.float32)
    )
    assert np.all(np.isfinite(out))


def test_int8_cross_attention_padded_cache_matches_unpadded():
    """A cache longer than its valid horizon (zero scales in the tail, the
    horizon passed as lengths) must give the same output as the cache cut
    to the horizon."""
    from jiao_liao_asr.models import layers as L

    rng = np.random.RandomState(11)
    B, H, Tq, Tk, dh = 2, 2, 1, 50, 16
    q = jnp.asarray(rng.randn(B, H, Tq, dh).astype(np.float32))
    kq, ks = Q.quantize_kv(rng.randn(B, H, Tk, dh).astype(np.float32))
    vq, vs = Q.quantize_kv(rng.randn(B, H, Tk, dh).astype(np.float32))
    want = L._int8_cache_attention(q, kq, ks, vq, vs, None, None, jnp.float32)
    pad3, pad4 = ((0, 0), (0, 0), (0, 128 - Tk)), ((0, 0), (0, 0), (0, 128 - Tk), (0, 0))
    got = L._int8_cache_attention(
        q, jnp.pad(kq, pad4), jnp.pad(ks, pad3), jnp.pad(vq, pad4),
        jnp.pad(vs, pad3), jnp.full((B,), Tk, jnp.int32), None, jnp.float32,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_int8_tied_logits_matches_dequantized_reference():
    """Row-major int8 logits vs dequantize+matmul in numpy, at two widths."""
    rng = np.random.RandomState(13)
    for D in (128, 96):
        R, V = 3, 300  # V deliberately not a 128 multiple
        x = jnp.asarray(rng.randn(R, D).astype(np.float32))
        emb = rng.randn(V, D).astype(np.float32)
        qT, s = Q.quantize_int8(jnp.asarray(emb).T)
        q_vd = qT.T
        got = Q.int8_tied_logits(x, q_vd, s)
        want = np.asarray(x) @ (
            np.asarray(q_vd, np.float32) * np.asarray(s)[:, None]
        ).T
        assert got.shape == (R, V)
        # bf16 operands: abs error scales with ||x||*||row||
        # (~11 here), not with the logit value -> atol-dominated bound
        np.testing.assert_allclose(np.asarray(got), want, atol=0.12, rtol=1e-2)


def test_tied_embedding_matches_nn_embed():
    """Unquantized TiedEmbedding is a plain embedding: one {embedding [V, D]}
    param, lookups are its rows, attend is x @ table.T."""
    from jiao_liao_asr.models.module import Scope
    from jiao_liao_asr.models.whisper import TiedEmbedding

    rng = np.random.RandomState(15)
    V, D = 40, 16
    tokens = jnp.asarray(rng.randint(0, V, (2, 5)))
    x = jnp.asarray(rng.randn(2, 5, D).astype(np.float32))
    tied = TiedEmbedding(V, D, dtype=jnp.float32)
    params = {}
    tied(Scope(params, init_key=jax.random.PRNGKey(0)), tokens)
    assert set(params.keys()) == {"embedding"}
    table = np.asarray(params["embedding"])
    out_t = tied(Scope(params), tokens)
    np.testing.assert_allclose(np.asarray(out_t), table[np.asarray(tokens)])
    att_t = tied.attend(Scope(params), x)
    np.testing.assert_allclose(
        np.asarray(att_t), np.asarray(x) @ table.T, atol=1e-5, rtol=1e-5
    )


def test_quantized_bundle_embeds_int8_table():
    """quantize() converts embed_tokens to {embedding_q, scale}; lookups
    and logits stay int8-close to the bf16 table."""
    bundle = _tiny_whisper_bundle()
    qb = bundle.quantize()
    et = qb.params["decoder"]["embed_tokens"]
    assert set(et.keys()) == {"embedding_q", "scale"}
    assert et["embedding_q"].dtype == jnp.int8
    ref = np.asarray(bundle.params["decoder"]["embed_tokens"]["embedding"])
    deq = np.asarray(et["embedding_q"], np.float32) * np.asarray(et["scale"])[:, None]
    step = np.abs(ref).max(axis=1, keepdims=True) / 127
    assert np.all(np.abs(deq - ref) <= 0.5 * step + 1e-7)


def test_quantized_bundle_builds_int8_cross_caches(monkeypatch):
    """init_cache on a quantized tree stores int8 head-major cross caches
    at ANY batch size; SELF caches stay packed bf16 below the head-major
    batch threshold (the measured small-batch optimum) and become int8
    head-major with per-position f32 scales above it."""
    from jiao_liao_asr.models import layers as L
    from jiao_liao_asr.models.whisper import WhisperModel

    bundle = _tiny_whisper_bundle()
    qb = bundle.quantize()
    model = WhisperModel(bundle.config.whisper)
    rng = np.random.RandomState(6)
    mel = jnp.asarray(rng.randn(2, 80, 64).astype(np.float32))
    enc = model.apply({"params": qb.params}, mel, method=model.encode)
    caches = model.apply(
        {"params": qb.params}, 2, enc, 8, method=model.init_cache
    )
    c0 = caches["block_0"]
    assert c0["cross"]["k"].dtype == jnp.int8
    assert c0["cross"]["k"].ndim == 4  # head-major even at batch 2
    assert "k_scale" in c0["cross"] and c0["cross"]["k_scale"].dtype == jnp.float32
    assert c0["self"]["k"].dtype != jnp.int8  # small batch: packed bf16 self
    assert c0["self"]["k"].ndim == 3
    # unquantized tree at small batch: bf16 packed cross caches as before
    caches_ref = model.apply(
        {"params": bundle.params}, 2, enc, 8, method=model.init_cache
    )
    assert caches_ref["block_0"]["cross"]["k"].dtype != jnp.int8
    assert caches_ref["block_0"]["cross"]["k"].ndim == 3
    # above the head-major threshold: int8 self with scales
    monkeypatch.setattr(L, "HEAD_MAJOR_MIN_BATCH", 1)
    caches_hm = model.apply(
        {"params": qb.params}, 2, enc, 8, method=model.init_cache
    )
    s0 = caches_hm["block_0"]["self"]
    assert s0["k"].dtype == jnp.int8
    assert s0["k"].ndim == 4
    assert "k_scale" in s0 and s0["k_scale"].dtype == jnp.float32


def _tiny_whisper_bundle():
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import (
        ExperimentConfig,
        WhisperConfig,
    )

    cfg = ExperimentConfig(
        model_family="whisper",
        whisper=WhisperConfig(
            vocab_size=128, d_model=64, encoder_layers=1, decoder_layers=2,
            num_heads=2, mlp_dim=128, max_source_positions=32,
            max_target_positions=16,
        ),
    )
    cfg.frontend.chunk_seconds = 0.64
    params = ModelBundle._init_params(cfg)
    from jiao_liao_asr.data.tokenizer import CharTokenizer

    return ModelBundle(config=cfg, params=params, tokenizer=CharTokenizer([]))


def test_bundle_quantize_decoder_logit_fidelity():
    """quantize() rewrites every decoder dense -> dense_q (encoder untouched)
    and the teacher-forced logits stay int8-close: same top-1 token almost
    everywhere."""
    import jax.numpy as jnp

    from jiao_liao_asr.models.whisper import WhisperModel

    bundle = _tiny_whisper_bundle()
    qb = bundle.quantize()

    def count_keys(node, key):
        if not isinstance(node, dict):
            return 0
        return sum(count_keys(v, key) for v in node.values()) + sum(
            1 for k in node if k == key
        )

    assert count_keys(qb.params["decoder"], "dense_q") > 0
    assert count_keys(qb.params["decoder"], "dense") == 0
    assert count_keys(qb.params["encoder"], "dense_q") == 0
    # original bundle untouched (quantize returns a new tree)
    assert count_keys(bundle.params["decoder"], "dense") > 0

    model = WhisperModel(bundle.config.whisper)
    rng = np.random.RandomState(3)
    mel = jnp.asarray(rng.randn(2, 80, 64).astype(np.float32))
    toks = jnp.asarray(rng.randint(0, 128, (2, 8)).astype(np.int32))
    ref = model.apply({"params": bundle.params}, mel, toks, deterministic=True)
    got = model.apply({"params": qb.params}, mel, toks, deterministic=True)
    assert got.shape == ref.shape
    agree = (np.argmax(np.asarray(got), -1) == np.argmax(np.asarray(ref), -1)).mean()
    assert agree >= 0.9, f"top-1 agreement {agree:.3f}"
    ra = np.asarray(ref, np.float32)
    ga = np.asarray(got, np.float32)
    cos = (ra * ga).sum() / (np.linalg.norm(ra) * np.linalg.norm(ga) + 1e-9)
    assert cos > 0.999, cos


def test_bundle_quantize_decode_step_runs():
    """KV-cached greedy decode works against the quantized tree (the actual
    serving path: every decoder Dense reads int8 weights per step)."""
    from jiao_liao_asr.decode.whisper_generate import (
        greedy_generate,
    )
    from jiao_liao_asr.models.whisper import WhisperModel

    bundle = _tiny_whisper_bundle()
    qb = bundle.quantize()
    model = WhisperModel(bundle.config.whisper)
    rng = np.random.RandomState(4)
    mel = jnp.asarray(rng.randn(1, 80, 64).astype(np.float32))
    prompt = (1, 2)
    ref, rn = greedy_generate(model, bundle.params, mel, max_len=6, prompt=prompt)
    got, gn = greedy_generate(model, qb.params, mel, max_len=6, prompt=prompt)
    assert got.shape == ref.shape
    # int8 decode is a serving approximation: shapes/step count must match;
    # token-level agreement is asserted on the teacher-forced logits above
    assert int(gn[0]) >= 0


def test_bundle_quantize_beam_generate_runs():
    """Beam search against the quantized tree: gather_beams must reorder the
    int8 cross caches (int8 k/v + f32 per-position scale leaves, all
    batch-major — a scalar leaf in the cache dict would crash the
    take_along_axis gather here)."""
    from jiao_liao_asr.decode.whisper_generate import (
        beam_generate,
    )
    from jiao_liao_asr.models.whisper import WhisperModel

    bundle = _tiny_whisper_bundle()
    qb = bundle.quantize()
    model = WhisperModel(bundle.config.whisper)
    rng = np.random.RandomState(8)
    mel = jnp.asarray(rng.randn(2, 80, 64).astype(np.float32))
    gen, lens = beam_generate(
        model, qb.params, mel, beam_size=2, max_len=6, prompt=(1, 2)
    )
    assert gen.shape[0] == 2 and lens.shape == (2,)
    assert np.all(np.asarray(lens) >= 0)


def test_quantize_non_whisper_raises():
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import ExperimentConfig

    cfg = ExperimentConfig()
    cfg.ctc_model.d_model = 64
    cfg.ctc_model.num_layers = 1
    cfg.ctc_model.num_heads = 2
    cfg.ctc_model.mlp_dim = 128
    cfg.ctc_model.conv_channels = 16
    cfg.ctc_model.vocab_size = 16
    params = ModelBundle._init_params(cfg)
    from jiao_liao_asr.data.tokenizer import CharTokenizer

    b = ModelBundle(config=cfg, params=params, tokenizer=CharTokenizer([]))
    with pytest.raises(NotImplementedError):
        b.quantize()


def test_int8_self_cache_rows_written_quantized(monkeypatch):
    """decode_step on a quantized tree writes int8 self-cache rows whose
    dequantized values track the bf16 tree's rows (the projections are
    themselves int8, so agreement is approximate), with zero scales at
    unwritten positions. Head-major forced: int8 self caches engage at
    B >= HEAD_MAJOR_MIN_BATCH."""
    from jiao_liao_asr.models import layers as L
    from jiao_liao_asr.models.whisper import WhisperModel

    monkeypatch.setattr(L, "HEAD_MAJOR_MIN_BATCH", 1)
    bundle = _tiny_whisper_bundle()
    qb = bundle.quantize()
    model = WhisperModel(bundle.config.whisper)
    rng = np.random.RandomState(12)
    mel = jnp.asarray(rng.randn(1, 80, 64).astype(np.float32))
    tok = jnp.asarray([[3]], jnp.int32)

    def step(params):
        enc = model.apply({"params": params}, mel, method=model.encode)
        caches = model.apply(
            {"params": params}, 1, enc, 8, method=model.init_cache
        )
        _, new_caches = model.apply(
            {"params": params}, tok, jnp.int32(0), enc, caches,
            method=model.decode_step,
        )
        return new_caches["block_0"]["self"]

    sq = step(qb.params)
    sb = step(bundle.params)
    assert sq["k"].dtype == jnp.int8
    ks = np.asarray(sq["k_scale"], np.float32)
    assert np.all(ks[:, :, 0] > 0) and np.all(ks[:, :, 1:] == 0)
    deq = np.asarray(sq["k"], np.float32)[0, :, 0] * ks[0, :, 0][:, None]
    ref = np.asarray(sb["k"], np.float32)
    # bf16 tree may store self caches packed [B, T, d] or head-major;
    # normalize to [H, dh] at position 0
    H, dh = deq.shape
    ref0 = (ref[0, :, 0] if ref.ndim == 4 else ref[0, 0].reshape(H, dh))
    np.testing.assert_allclose(deq, ref0, atol=0.15, rtol=0.15)


def test_quantized_generate_with_int8_self_caches(monkeypatch):
    """Greedy AND beam generate run the full int8-SELF cache path (head-major
    forced): per-step row quantization, prefix-length attention over the
    int8 rows, and beam gathers over the 4-dim int8/scale self-cache leaves."""
    from jiao_liao_asr.decode.whisper_generate import (
        beam_generate,
        greedy_generate,
    )
    from jiao_liao_asr.models import layers as L
    from jiao_liao_asr.models.whisper import WhisperModel

    monkeypatch.setattr(L, "HEAD_MAJOR_MIN_BATCH", 1)
    bundle = _tiny_whisper_bundle()
    qb = bundle.quantize()
    model = WhisperModel(bundle.config.whisper)
    rng = np.random.RandomState(21)
    mel = jnp.asarray(rng.randn(2, 80, 64).astype(np.float32))
    gen, lens = greedy_generate(model, qb.params, mel, max_len=6, prompt=(1, 2))
    assert gen.shape[0] == 2 and np.all(np.asarray(lens) >= 0)
    gen_b, lens_b = beam_generate(
        model, qb.params, mel, beam_size=2, max_len=6, prompt=(1, 2)
    )
    assert gen_b.shape[0] == 2 and np.all(np.asarray(lens_b) >= 0)


def test_quantized_bundle_shards_and_transcribes():
    """quantize() -> shard() -> transcribe composes on the virtual mesh:
    the sharding rules must tolerate the int8 dense_q/scale and embedding_q
    leaves (replicating anything without a TP rule), and the sharded decode
    must run the quantized serving path end to end."""
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import (
        ExperimentConfig,
        WhisperConfig,
    )

    cfg = ExperimentConfig(
        model_family="whisper",
        whisper=WhisperConfig(
            vocab_size=64, d_model=64, encoder_layers=1, decoder_layers=1,
            num_heads=2, mlp_dim=128, max_source_positions=64,
            max_target_positions=16,
        ),
    )
    cfg.frontend.chunk_seconds = 1.28
    params = ModelBundle._init_params(cfg)
    bundle = ModelBundle(
        config=cfg, params=params, tokenizer=CharTokenizer(list("你好"))
    )
    sq = bundle.quantize().shard()
    wav = np.random.RandomState(0).randn(16000).astype(np.float32) * 0.1
    texts = sq.transcribe([wav])
    assert len(texts) == 1 and isinstance(texts[0], str)


@pytest.mark.parametrize("positions", [(0, 0), (3, 7), (11, 0), (5, 11)])
def test_int8_self_attention_step_matches_dequantized_reference(positions):
    """One MultiHeadAttention decode step over an int8 head-major self cache,
    each row at its own position (continuous batching): the step's K/V row
    is written quantized at that position and the query attends over
    positions 0..pos of the dequantized cache, padding beyond ignored."""
    from jiao_liao_asr.models.layers import MultiHeadAttention
    from jiao_liao_asr.models.module import Scope

    B, H, dh, Tc = 2, 2, 8, 12
    d = H * dh
    rng = np.random.RandomState(sum(positions) + 1)
    mha = MultiHeadAttention(H, d, jnp.float32)
    x = jnp.asarray(rng.randn(B, 1, d).astype(np.float32))
    params = {}
    mha(Scope(params, init_key=jax.random.PRNGKey(2)), x)
    kq, ks = Q.quantize_kv(rng.randn(B, H, Tc, dh).astype(np.float32))
    vq, vs = Q.quantize_kv(rng.randn(B, H, Tc, dh).astype(np.float32))
    cache = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    pos = jnp.asarray(positions, jnp.int32)
    out, new = mha(Scope(params), x, kv_cache=cache, cache_index=pos,
                   kv_lengths=pos + 1)

    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    xn = np.asarray(x, np.float64)[:, 0]
    q = (xn @ p["q_proj"]["dense"]["kernel"] + p["q_proj"]["dense"]["bias"])
    k_row = xn @ p["k_proj"]["dense"]["kernel"]
    v_row = xn @ p["v_proj"]["dense"]["kernel"] + p["v_proj"]["dense"]["bias"]
    kd = np.asarray(kq, np.float64) * np.asarray(ks)[..., None]
    vd = np.asarray(vq, np.float64) * np.asarray(vs)[..., None]
    want = np.zeros((B, d))
    for b, t in enumerate(positions):
        for name, row, deq in (("k", k_row, kd), ("v", v_row, vd)):
            rq, rs = Q.quantize_kv(row[b].reshape(H, 1, dh).astype(np.float32))
            got_rows = np.asarray(new[name], np.float64)[b, :, t]
            np.testing.assert_array_equal(got_rows, np.asarray(rq)[:, 0])
            deq[b, :, t] = np.asarray(rq, np.float64)[:, 0] * np.asarray(rs)
        qh = q[b].reshape(H, dh)
        s = np.einsum("hd,htd->ht", qh, kd[b, :, : t + 1]) / np.sqrt(dh)
        w = np.exp(s - s.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        want[b] = np.einsum("ht,htd->hd", w, vd[b, :, : t + 1]).reshape(d)
    want = want @ p["out_proj"]["dense"]["kernel"] + p["out_proj"]["dense"]["bias"]
    np.testing.assert_allclose(np.asarray(out)[:, 0], want, atol=1e-4, rtol=1e-4)
