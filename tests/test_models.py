"""Model-layer tests: shapes, masking invariance, adapter injection and
param masking, Whisper forward/decode-step consistency."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.models.ctc_model import CTCEncoderModel
from jiao_liao_asr.models.whisper import WhisperModel
from jiao_liao_asr.models.adapters import param_is_adapter
from jiao_liao_asr.utils.config import (
    AdapterConfig,
    CTCModelConfig,
    WhisperConfig,
)

TINY = CTCModelConfig(
    vocab_size=20, d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
    conv_channels=32, dtype="float32", )


def _init_ctc(cfg, T=64, B=2):
    model = CTCEncoderModel(cfg)
    feats = jnp.zeros((B, cfg.num_mels, T), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), feats)["params"]
    return model, params


def test_ctc_shapes():
    model, params = _init_ctc(TINY)
    feats = jax.random.normal(jax.random.PRNGKey(1), (2, 80, 64))
    lp, lens = model.apply({"params": params}, feats, jnp.asarray([64, 40]))
    assert lp.shape == (2, 16, 20)
    assert list(np.asarray(lens)) == [16, 10]
    # log-softmax normalized
    assert np.allclose(np.exp(np.asarray(lp)).sum(-1), 1.0, atol=1e-4)


def test_ctc_padding_invariance():
    """Valid outputs must not depend on padded frames."""
    model, params = _init_ctc(TINY, T=64)
    feats = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 80, 64)))
    a = model.apply({"params": params}, jnp.asarray(feats), jnp.asarray([40]))[0]
    feats2 = feats.copy()
    feats2[:, :, 40:] = 7.7  # garbage in the padding
    b = model.apply({"params": params}, jnp.asarray(feats2), jnp.asarray([40]))[0]
    valid = 10  # ceil(ceil(40/2)/2)
    # conv subsampling has kernel overlap at the boundary; interior must match
    assert np.abs(np.asarray(a)[:, : valid - 1] - np.asarray(b)[:, : valid - 1]).max() < 1e-4


@pytest.mark.parametrize("kind,expect_names", [
    ("bottleneck", ["adapter_bn"]),
    ("att", ["adapter_att"]),
    ("wf", ["adapter_wf"]),
])
def test_adapter_injection_and_mask(kind, expect_names):
    cfg = CTCModelConfig(
        vocab_size=20, d_model=64, num_layers=1, num_heads=4, mlp_dim=128,
        conv_channels=32, dtype="float32", adapter=AdapterConfig(kind=kind, bottleneck_dim=16, wf_rank=4),
    )
    model, params = _init_ctc(cfg)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = ["/".join(str(getattr(k, "key", k)) for k in kp) for kp, _ in flat]
    hits = [p for p in paths if any(e in p for e in expect_names)]
    assert hits, f"no adapter params injected for {kind}: {paths}"
    # adapter mask must select exactly those
    n_adapter = sum(
        1 for kp, _ in flat
        if param_is_adapter(tuple(str(getattr(k, "key", k)) for k in kp))
    )
    assert n_adapter == len(hits)


def test_adapters_identity_at_init():
    """Zero-initialized up/out projections => injection starts as identity."""
    base_cfg = TINY
    _, base_params = _init_ctc(base_cfg)
    feats = jax.random.normal(jax.random.PRNGKey(3), (1, 80, 64))
    base_model = CTCEncoderModel(base_cfg)
    base_out = base_model.apply({"params": base_params}, feats)[0]
    for kind in ["bottleneck", "att", "wf"]:
        cfg = CTCModelConfig(
            vocab_size=20, d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
            conv_channels=32, dtype="float32", adapter=AdapterConfig(kind=kind),
        )
        model = CTCEncoderModel(cfg)
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64)))["params"]
        out = model.apply({"params": params}, feats)[0]
        assert np.abs(np.asarray(out) - np.asarray(base_out)).max() < 1e-4, kind


WTINY = WhisperConfig(
    vocab_size=100, d_model=64, encoder_layers=2, decoder_layers=2,
    num_heads=4, mlp_dim=128, max_target_positions=32, dtype="float32",
)


def test_whisper_forward_shapes():
    model = WhisperModel(WTINY)
    mel = jnp.zeros((2, 80, 100))
    toks = jnp.zeros((2, 7), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), mel, toks)["params"]
    logits = model.apply({"params": params}, mel, toks)
    assert logits.shape == (2, 7, 100)


def test_whisper_decode_step_matches_forward():
    """Teacher-forced logits at position p == decode_step logits with cache."""
    model = WhisperModel(WTINY)
    mel = jax.random.normal(jax.random.PRNGKey(1), (1, 80, 100))
    toks = jnp.asarray([[5, 9, 17, 3]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), mel, toks)["params"]
    full = model.apply({"params": params}, mel, toks)  # [1, 4, V]

    enc = model.apply({"params": params}, mel, method=model.encode)
    caches = model.apply({"params": params}, 1, enc, method=model.init_cache)
    for p in range(4):
        step_logits, caches = model.apply(
            {"params": params},
            toks[:, p : p + 1],
            jnp.int32(p),
            enc,
            caches,
            method=model.decode_step,
        )
        assert np.abs(np.asarray(step_logits[0]) - np.asarray(full[0, p])).max() < 1e-3, p


@pytest.mark.parametrize("kind", ["att", "bottleneck", "wf"])
def test_whisper_decode_step_matches_forward_with_adapters(kind):
    """Decode parity must hold with NONZERO adapter weights — in particular
    the AttAdapter, whose slot keeps its own KV cache so step-wise decode
    attends over the same causal prefix as the teacher-forced forward."""
    cfg = WhisperConfig(
        vocab_size=100, d_model=64, encoder_layers=1, decoder_layers=2,
        num_heads=4, mlp_dim=128, max_target_positions=32, dtype="float32",
        adapter=AdapterConfig(kind=kind, bottleneck_dim=8, wf_rank=4,
                              att_num_heads=2, att_key_dim=8, dropout=0.0),
    )
    model = WhisperModel(cfg)
    mel = jax.random.normal(jax.random.PRNGKey(1), (2, 80, 100))
    toks = jnp.asarray([[5, 9, 17, 3], [2, 11, 7, 19]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), mel, toks)["params"]
    # adapters init as identity (zeroed out-projections): randomize them so
    # divergence between trained fn and decoded fn would be visible
    keys = jax.random.split(jax.random.PRNGKey(7), 1000)
    counter = [0]

    def perturb(kp, x):
        path = tuple(str(getattr(k, "key", k)) for k in kp)
        if param_is_adapter(path):
            counter[0] += 1
            return 0.3 * jax.random.normal(keys[counter[0]], x.shape, x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, params)
    assert counter[0] > 0

    full = model.apply({"params": params}, mel, toks)  # [2, 4, V]
    enc = model.apply({"params": params}, mel, method=model.encode)
    caches = model.apply({"params": params}, 2, enc, method=model.init_cache)
    for p in range(4):
        step_logits, caches = model.apply(
            {"params": params},
            toks[:, p : p + 1],
            jnp.int32(p),
            enc,
            caches,
            method=model.decode_step,
        )
        err = np.abs(np.asarray(step_logits) - np.asarray(full[:, p])).max()
        assert err < 1e-3, (kind, p, err)


def test_whisper_decode_step_att_adapter_head_major(monkeypatch):
    """AttAdapter decode under HEAD-MAJOR backbone caches: the slot caches
    must share the self-cache horizon, because decode_step's key mask is
    sized to the self-cache shape."""
    from jiao_liao_asr.models import layers as L

    monkeypatch.setattr(L, "HEAD_MAJOR_MIN_BATCH", 1)
    cfg = WhisperConfig(
        vocab_size=100, d_model=64, encoder_layers=1, decoder_layers=2,
        num_heads=4, mlp_dim=128, max_target_positions=32, dtype="float32",
        adapter=AdapterConfig(kind="att", att_num_heads=2, att_key_dim=8,
                              dropout=0.0),
    )
    model = WhisperModel(cfg)
    mel = jax.random.normal(jax.random.PRNGKey(1), (2, 80, 100))
    toks = jnp.asarray([[5, 9], [2, 11]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), mel, toks)["params"]
    keys = jax.random.split(jax.random.PRNGKey(7), 1000)
    counter = [0]

    def perturb(kp, x):
        path = tuple(str(getattr(k, "key", k)) for k in kp)
        if param_is_adapter(path):
            counter[0] += 1
            return 0.3 * jax.random.normal(keys[counter[0]], x.shape, x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, params)
    assert counter[0] > 0
    full = model.apply({"params": params}, mel, toks)
    enc = model.apply({"params": params}, mel, method=model.encode)
    caches = model.apply({"params": params}, 2, enc, method=model.init_cache)
    assert caches["block_0"]["self"]["k"].ndim == 4
    t_self = caches["block_0"]["self"]["k"].shape[-2]
    assert caches["block_0"]["slots"]["post_attn"]["k"].shape[1] == t_self
    for p in range(2):
        step_logits, caches = model.apply(
            {"params": params}, toks[:, p : p + 1], jnp.int32(p), enc, caches,
            method=model.decode_step,
        )
        err = np.abs(np.asarray(step_logits) - np.asarray(full[:, p])).max()
        assert err < 1e-3, (p, err)


def test_whisper_remat_matches_no_remat():
    """WhisperConfig.remat (jax.checkpoint each ENCODER block — the 30 s
    window's memory plan at large batch) must not change loss or
    grads. Guards the r4 fix: the flag used to be silently ignored by
    WhisperEncoder."""
    import dataclasses

    mel = jax.random.normal(jax.random.PRNGKey(1), (2, 80, 100))
    toks = jnp.asarray([[5, 9, 17, 3], [2, 8, 1, 6]], jnp.int32)

    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(WTINY, remat=remat, dropout=0.1)
        model = WhisperModel(cfg)
        variables = model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(2)},
            mel, toks, deterministic=False,
        )

        def loss(v):
            lg = model.apply(
                v, mel, toks, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(3)},
            )
            return jnp.sum(lg.astype(jnp.float32) ** 2)

        outs.append((float(loss(variables)), jax.grad(loss)(variables)))

    (l0, g0), (l1, g1) = outs
    assert abs(l0 - l1) < 1e-4 * max(1.0, abs(l0))
    d = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()), g0, g1
    )
    rel = max(jax.tree_util.tree_leaves(d))
    assert rel < 1e-2, rel
