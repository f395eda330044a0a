"""The attention wrapper (models/layers.dot_product_attention), the rule that
picks its implementation, the masks it describes, and TransformerBlock
against a numpy reference of the pre-LN block with and without adapters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import erf

from jiao_liao_asr.models import layers as L
from jiao_liao_asr.models.module import Scope
from jiao_liao_asr.utils.config import AdapterConfig

# ---------------------------------------------------------------------------
# numpy references
# ---------------------------------------------------------------------------


def np_mask(Tq, Tk, lengths=None, causal=False, window=None, mask=None, B=1):
    """[B, 1 or H, Tq, Tk] boolean mask from the structured forms."""
    qi = np.arange(Tq)[:, None]
    ki = np.arange(Tk)[None, :]
    m = np.ones((B, 1, Tq, Tk), bool)
    if causal:
        m &= (ki <= qi)[None, None]
    if window is not None:
        left, right = window
        if left >= 0:
            m &= (ki >= qi - left)[None, None]
        if right >= 0:
            m &= (ki <= qi + right)[None, None]
    if lengths is not None:
        m &= (ki[None] < np.asarray(lengths)[:, None, None])[:, None]
    if mask is not None:
        m = m & np.asarray(mask)
    return m


def np_attention(q, k, v, m):
    """float64 softmax attention over [B, T, H, dh] with a boolean mask."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(m, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def jnp_attention(q, k, v, m):
    """float32 attention in jax.numpy, for reference gradients."""
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = jnp.where(m, s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)


def qkv(seed, B, Tq, Tk, H, dh, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    return tuple(
        jnp.asarray(rng.randn(B, T, H, dh).astype(np.float32), dtype)
        for T in (Tq, Tk, Tk)
    )


# (name, Tq, Tk, lengths, causal, window, general mask?)
FORMS = [
    ("none", 9, 9, None, False, None, False),
    ("lengths", 9, 9, [9, 4], False, None, False),
    ("causal", 9, 9, None, True, None, False),
    ("lengths+causal", 9, 9, [9, 5], True, None, False),
    ("window(2,1)", 9, 9, None, False, (2, 1), False),
    ("window(3,0)", 9, 9, None, False, (3, 0), False),
    ("left-unbounded window+lengths", 9, 9, [9, 6], False, (-1, 2), False),
    ("general mask", 9, 9, None, False, None, True),
    ("general mask+lengths", 9, 9, [7, 9], False, None, True),
    ("cross lengths", 5, 11, [11, 3], False, None, False),
]


def form_args(form, B, H, seed=0):
    name, Tq, Tk, lengths, causal, window, general = form
    mask = None
    if general:
        rng = np.random.RandomState(seed + 7)
        mask = rng.rand(B, H, Tq, Tk) < 0.7
        mask[..., 0] = True  # every query keeps a key
    return name, Tq, Tk, lengths, causal, window, mask


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
def test_attention_matches_numpy_reference(form, dtype):
    B, H, dh = 2, 3, 16
    _, Tq, Tk, lengths, causal, window, mask = form_args(form, B, H)
    q, k, v = qkv(1, B, Tq, Tk, H, dh, dtype)
    got = L.dot_product_attention(
        q, k, v, None if mask is None else jnp.asarray(mask),
        kv_lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32),
        causal=causal, window=window,
    )
    assert got.shape == q.shape and got.dtype == q.dtype
    want = np_attention(q.astype(jnp.float32), k.astype(jnp.float32),
                        v.astype(jnp.float32),
                        np_mask(Tq, Tk, lengths, causal, window, mask, B))
    # float32: summation order only; bf16: the output's own rounding
    # (2^-8 relative) on top of bf16 probabilities
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol, rtol=tol)


GRAD_FORMS = [f for f in FORMS if f[0] in (
    "lengths", "lengths+causal", "window(2,1)", "general mask", "cross lengths")]


@pytest.mark.parametrize("form", GRAD_FORMS, ids=[f[0] for f in GRAD_FORMS])
def test_attention_gradients_match_reference(form):
    B, H, dh = 2, 2, 8
    _, Tq, Tk, lengths, causal, window, mask = form_args(form, B, H, seed=3)
    q, k, v = qkv(4, B, Tq, Tk, H, dh)
    probe = jnp.asarray(np.random.RandomState(5).randn(B, Tq, H, dh), jnp.float32)
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    jmask = None if mask is None else jnp.asarray(mask)
    m = jnp.asarray(np_mask(Tq, Tk, lengths, causal, window, mask, B))

    def chosen(q, k, v):
        out = L.dot_product_attention(q, k, v, jmask, kv_lengths=lens,
                                      causal=causal, window=window)
        return jnp.sum(out * probe)

    def reference(q, k, v):
        return jnp.sum(jnp_attention(q, k, v, m) * probe)

    with jax.default_matmul_precision("highest"):
        got = jax.grad(chosen, argnums=(0, 1, 2))(q, k, v)
        want = jax.grad(reference, argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("form", FORMS[:7], ids=[f[0] for f in FORMS[:7]])
def test_attention_mask_matches_numpy(form):
    _, Tq, Tk, lengths, causal, window, _ = form
    got = L.attention_mask(
        Tq, Tk, None if lengths is None else jnp.asarray(lengths), causal, window
    )
    if lengths is None and not causal and window is None:
        assert got is None
        return
    B = 1 if lengths is None else len(lengths)
    want = np_mask(Tq, Tk, lengths, causal, window, None, B)
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(got), want.shape), want)


def test_reference_attention_matches_numpy():
    q, k, v = qkv(8, 2, 6, 6, 2, 8)
    m = np_mask(6, 6, [6, 3], True, None, None, 2)
    with jax.default_matmul_precision("highest"):
        got = L.reference_attention(q, k, v, jnp.asarray(m))
    np.testing.assert_allclose(np.asarray(got), np_attention(q, k, v, m), atol=1e-5)


# ---------------------------------------------------------------------------
# The implementation rule
# ---------------------------------------------------------------------------

BF16, F16, F32 = jnp.bfloat16, jnp.float16, jnp.float32
RULE = [
    # (platform, dtype, head_dim, q_len, general_mask, window)
    (("cpu", BF16, 128, 750, False, None), "xla"),
    (("gpu", BF16, 128, 750, False, None), "cudnn"),
    (("gpu", F16, 64, 1500, False, None), "cudnn"),
    (("gpu", BF16, 8, 64, False, None), "cudnn"),
    (("gpu", F32, 64, 1500, False, None), "xla"),
    (("gpu", BF16, 12, 64, False, None), "xla"),
    (("gpu", BF16, 256, 64, False, None), "xla"),
    (("gpu", BF16, 64, 1, False, None), "xla"),
    (("gpu", BF16, 64, 64, True, None), "xla"),
    (("gpu", BF16, 64, 64, False, (16, 0)), "cudnn"),
    (("gpu", BF16, 64, 64, False, (16, 4)), "xla"),
    (("gpu", F16, 128, 750, False, (64, 0)), "cudnn"),
    (("gpu", BF16, 64, 64, True, (16, 0)), "xla"),
]


@pytest.mark.parametrize("args,want", RULE, ids=[
    f"{a[0]}-{jnp.dtype(a[1]).name}-dh{a[2]}-q{a[3]}-mask{int(a[4])}-win{a[5]}"
    for a, _ in RULE])
def test_attention_implementation_rule(args, want):
    platform, dtype, dh, q_len, general, window = args
    got = L.attention_implementation(
        dtype, dh, q_len=q_len, general_mask=general, window=window,
        platform=platform,
    )
    assert got == want


def test_attention_implementation_defaults_to_backend():
    assert L.attention_implementation(BF16, 128) == (
        "cudnn" if jax.default_backend() == "gpu" else "xla"
    )


@pytest.mark.parametrize("kwargs,form", [
    ({}, "none"),
    ({"kv_lengths": np.asarray([4, 3])}, "lengths"),
    ({"causal": True, "window": (2, 0)}, "causal+window"),
    ({"mask": np.ones((2, 1, 4, 4), bool)}, "mask"),
])
def test_attention_records_its_choice(kwargs, form):
    q, k, v = qkv(2, 2, 4, 4, 2, 8)
    with L.record_attention_choices() as seen:
        L.dot_product_attention(q, k, v, **kwargs)
        with L.record_attention_choices() as inner:
            L.dot_product_attention(q, k, v)
    assert seen == [
        (L.attention_implementation(q.dtype, 8), (2, 4, 2, 8), (2, 4, 2, 8), form)
    ]
    assert len(inner) == 1
    L.dot_product_attention(q, k, v)  # outside any recorder: nothing kept
    assert L._choices is None


def _mesh(shape, names=("data", "fsdp")):
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


DFM = ("data", "fsdp", "model")


@pytest.mark.parametrize("shape,names,B,H,want", [
    ((2, 2), ("data", "fsdp"), 4, 2, (("data", "fsdp"), None)),
    ((2, 2), ("data", "fsdp"), 2, 2, (("data",), None)),
    ((2, 2), ("data", "fsdp"), 3, 2, (None, None)),
    ((1, 2, 2), DFM, 4, 20, (("data", "fsdp"), "model")),
    ((2, 1, 2), DFM, 4, 3, (("data", "fsdp"), None)),
    ((1, 1, 4), DFM, 1, 4, (("data", "fsdp"), "model")),
])
def test_shard_axes(shape, names, B, H, want):
    assert L.shard_axes(_mesh(shape, names), B, H) == want


# (mesh shape, axis names, B, H, call kwargs)
MESH_CALLS = [
    ((2, 2), ("data", "fsdp"), 4, 2, "lengths"),
    ((2, 2), ("data", "fsdp"), 4, 2, "causal"),
    ((2, 2), ("data", "fsdp"), 4, 2, "mask+lengths"),
    ((1, 2, 2), DFM, 4, 2, "lengths"),
    ((1, 2, 2), DFM, 4, 2, "window"),
    ((2, 1, 2), DFM, 2, 4, "head mask"),
    ((2, 2), ("data", "fsdp"), 3, 2, "lengths"),
    ((1, 2, 2), DFM, 4, 3, "causal"),
]


@pytest.mark.parametrize("shape,names,B,H,form", MESH_CALLS, ids=[
    f"{'x'.join(map(str, c[0]))}-B{c[2]}-H{c[3]}-{c[4]}" for c in MESH_CALLS])
def test_attention_under_a_mesh_runs_per_shard(shape, names, B, H, form):
    """Traced under a mesh of several devices, attention runs on each
    device's batch and head block (shard_axes), with the value and the
    gradients of the unsharded call; an axis that does not divide its
    dimension is left out."""
    T, dh = 8, 8
    rng = np.random.RandomState(B * 10 + H)
    q, k, v = qkv(6, B, T, T, H, dh)
    kw = {}
    if "lengths" in form:
        kw["kv_lengths"] = jnp.asarray(rng.randint(1, T + 1, B), jnp.int32)
    if form == "causal":
        kw["causal"] = True
    if form == "window":
        kw["window"] = (2, 1)
    if "mask" in form:
        m = rng.rand(B, H if form == "head mask" else 1, T, T) < 0.7
        m[..., 0] = True
        kw["mask"] = jnp.asarray(m)
    probe = jnp.asarray(rng.randn(B, T, H, dh), jnp.float32)

    def f(q, k, v):
        return jnp.sum(L.dot_product_attention(q, k, v, **kw) * probe)

    want = jax.value_and_grad(f, argnums=(0, 1, 2))(q, k, v)
    mesh = _mesh(shape, names)
    with L.record_attention_choices() as seen, jax.set_mesh(mesh):
        got = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(q, k, v)
    b, h = L.shard_axes(mesh, B, H)
    nb = int(np.prod([mesh.shape[a] for a in b or ()]))
    nh = mesh.shape[h] if h else 1
    assert seen[0][1] == (B // nb, T, H // nh, dh)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_train_step_on_a_mesh_is_traced_under_it():
    """build_train_setup(..., mesh) traces its step under the mesh, so the
    step's attention runs on each device's block of the batch, and the step
    gives the loss of the same step on one device."""
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.parallel.mesh import shard_batch, shard_state
    from jiao_liao_asr.train.engine import build_train_setup, init_state
    from jiao_liao_asr.utils.config import (
        CTCModelConfig, ExperimentConfig, SpecAugmentConfig,
    )

    cfg = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(vocab_size=16, d_model=32, num_layers=1,
                                 num_heads=2, mlp_dim=64, conv_channels=16,
                                 dropout=0.0),
        specaugment=SpecAugmentConfig(enabled=False),
    )
    params = ModelBundle._init_params(cfg)
    rng = np.random.RandomState(0)
    host = {
        "audio": jnp.asarray(rng.randn(4, 8000).astype(np.float32) * 0.1),
        "audio_lengths": jnp.full((4,), 8000, jnp.int32),
        "labels": jnp.asarray(rng.randint(1, 16, (4, 5)).astype(np.int32)),
        "label_lengths": jnp.full((4,), 5, jnp.int32),
    }
    _, _, tx, step1 = build_train_setup(cfg, params)
    # the step donates its state: give it a copy of the params
    _, want = step1(init_state(cfg, tx, jax.tree_util.tree_map(jnp.copy, params)), host)
    mesh = _mesh((2, 2))
    _, _, tx, step = build_train_setup(cfg, params, mesh)
    state = shard_state(mesh, init_state(cfg, tx, params))
    with L.record_attention_choices() as seen:
        state, metrics = step(state, shard_batch(mesh, host))
    assert seen and {c[1][0] for c in seen} == {1}  # 4 rows over 4 devices
    # bf16 compute, summed in another order across devices
    np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]), rtol=1e-3)


# ---------------------------------------------------------------------------
# TransformerBlock against a numpy pre-LN block
# ---------------------------------------------------------------------------


def np_ln(p, x):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + 1e-5) * p["scale"] + p["bias"]


def np_dense(p, x, ad, use_bias=True):
    """A backbone Dense with its WF insert when the adapter is 'wf'."""
    y = x @ p["dense"]["kernel"]
    if use_bias:
        y = y + p["dense"]["bias"]
    if ad.kind == "wf":
        w = p["adapter_wf"]
        y = y + ad.scale * (((x @ w["a"]) * w["g"]) @ w["b"])
    return y


def np_gelu(x, form):
    if form == "tanh":
        return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x**3)))
    return 0.5 * x * (1 + erf(x / np.sqrt(2)))


def np_mha(p, x, kv, m, H, ad):
    B, Tq, d = x.shape
    Tk = kv.shape[1]
    q = np_dense(p["q_proj"], x, ad).reshape(B, Tq, H, -1)
    k = np_dense(p["k_proj"], kv, ad, use_bias=False).reshape(B, Tk, H, -1)
    v = np_dense(p["v_proj"], kv, ad).reshape(B, Tk, H, -1)
    o = np_attention(q, k, v, m).reshape(B, Tq, d)
    return np_dense(p["out_proj"], o, ad)


def np_slot(p, x, ad):
    if ad.kind != "bottleneck":
        return x
    b = p["adapter_bn"]
    z = np_gelu(np_ln(b["ln"], x) @ b["down"]["kernel"] + b["down"]["bias"], "erf")
    return x + ad.scale * (z @ b["up"]["kernel"] + b["up"]["bias"])


def np_block(p, x, m, ad, H, gelu_form, enc=None, enc_m=None):
    h = np_ln(p["self_attn_ln"], x)
    x = x + np_mha(p["self_attn"], h, h, m, H, ad)
    x = np_slot(p.get("post_attn_slot", {}), x, ad)
    if enc is not None:
        x = x + np_mha(p["cross_attn"], np_ln(p["cross_attn_ln"], x), enc, enc_m, H, ad)
    h = np_ln(p["mlp_ln"], x)
    h = np_gelu(np_dense(p["mlp"]["fc1"], h, ad), gelu_form)
    x = x + np_dense(p["mlp"]["fc2"], h, ad)
    return np_slot(p.get("post_mlp_slot", {}), x, ad)


BLOCK_FORMS = ["lengths", "causal", "window+lengths", "general mask", "causal+cross"]


@pytest.mark.parametrize("kind", ["none", "wf", "bottleneck"])
@pytest.mark.parametrize("form", BLOCK_FORMS)
def test_transformer_block_matches_numpy(kind, form):
    B, T, d, H, mlp, Te = 2, 10, 32, 4, 64, 7
    ad = AdapterConfig(kind=kind, wf_rank=4, bottleneck_dim=8, scale=0.5, dropout=0.0)
    cross = form == "causal+cross"
    blk = L.TransformerBlock(d, H, mlp, jnp.float32, adapter=ad,
                             cross_attention=cross, gelu_form="tanh")
    rng = np.random.RandomState(11)
    x = jnp.asarray(rng.randn(B, T, d).astype(np.float32))
    enc = jnp.asarray(rng.randn(B, Te, d).astype(np.float32)) if cross else None
    lengths = np.array([T, 6])
    kw, m = {}, None
    if form == "lengths":
        kw = {"kv_lengths": jnp.asarray(lengths)}
        m = np_mask(T, T, lengths, B=B)
    elif form in ("causal", "causal+cross"):
        kw = {"causal": True}
        m = np_mask(T, T, causal=True)
    elif form == "window+lengths":
        kw = {"kv_lengths": jnp.asarray(lengths), "window": (-1, 2)}
        m = np_mask(T, T, lengths, window=(-1, 2), B=B)
    else:
        mask = rng.rand(B, 1, T, T) < 0.6
        mask[..., 0] = True
        kw = {"mask": jnp.asarray(mask)}
        m = np_mask(T, T, mask=mask, B=B)
    enc_lengths = np.array([Te, 4])
    if cross:
        kw.update(enc=enc, enc_kv_lengths=jnp.asarray(enc_lengths))

    params = {}
    blk(Scope(params, init_key=jax.random.PRNGKey(0)), x, **kw)
    # move every param off its initial value, so zero-initialised adapter
    # projections and unit LN scales take part
    leaves, tree = jax.tree_util.tree_flatten(params)
    noise = [jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.2) + a
             for a in leaves]
    params = jax.tree_util.tree_unflatten(tree, noise)
    with jax.default_matmul_precision("highest"):
        got = blk(Scope(params), x, **kw)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    enc_m = np_mask(T, Te, enc_lengths, B=B) if cross else None
    want = np_block(p, np.asarray(x, np.float64), m, ad, H, "tanh",
                    None if enc is None else np.asarray(enc, np.float64), enc_m)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-4, rtol=2e-4)
