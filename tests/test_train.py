"""Training engine tests (SURVEY.md §4.4): loss decreases on a tiny corpus,
adapter-only masking freezes the backbone, checkpoints round-trip, grad
accumulation equivalence, multi-dialect stage schedule runs."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.train.engine import (
    adapter_mask,
    batch_to_device,
    build_train_setup,
    init_state,
    make_optimizer,
    make_schedule,
)
from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.utils.config import (
    AdapterConfig,
    CTCModelConfig,
    ExperimentConfig,
    OptimizerConfig,
    SpecAugmentConfig,
)

TINY_EXP = ExperimentConfig(
    model_family="ctc",
    ctc_model=CTCModelConfig(
        vocab_size=32, d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
        conv_channels=32, dtype="float32", dropout=0.0,
    ),
    specaugment=SpecAugmentConfig(enabled=False),
)


def _tiny_batch(rng, B=4, samples=8000, V=32, S=6):
    return {
        "audio": jnp.asarray(rng.randn(B, samples).astype(np.float32) * 0.1),
        "audio_lengths": jnp.asarray(np.full((B,), samples, np.int32)),
        "labels": jnp.asarray(rng.randint(2, V, (B, S)).astype(np.int32)),
        "label_lengths": jnp.asarray(np.full((B,), S, np.int32)),
    }


def test_loss_decreases(rng):
    cfg = dataclasses.replace(TINY_EXP)
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=3e-3, warmup_steps=5, total_steps=60, schedule="constant"
    )
    params = ModelBundle._init_params(cfg)
    model, loss_fn, tx, step = build_train_setup(cfg, params)
    state = init_state(cfg, tx, params)
    batch = _tiny_batch(rng)
    losses = []
    for _ in range(40):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::8]
    assert np.isfinite(losses).all()


def test_adapter_only_freezes_backbone(rng):
    cfg = dataclasses.replace(TINY_EXP)
    cfg.ctc_model = dataclasses.replace(
        cfg.ctc_model, adapter=AdapterConfig(kind="wf", wf_rank=4)
    )
    cfg.train = dataclasses.replace(cfg.train, train_adapters_only=True)
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-2, warmup_steps=0, total_steps=10, schedule="constant"
    )
    params = ModelBundle._init_params(cfg)
    model, loss_fn, tx, step = build_train_setup(cfg, params)
    state = init_state(cfg, tx, params)
    batch = _tiny_batch(rng)
    p0 = jax.tree_util.tree_map(np.asarray, state.params)
    for _ in range(3):
        state, _ = step(state, batch)
    mask = adapter_mask(params)
    flat0 = jax.tree_util.tree_leaves_with_path(p0)
    flat1 = dict(
        (jax.tree_util.keystr(kp), v)
        for kp, v in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, state.params)
        )
    )
    flatm = dict(
        (jax.tree_util.keystr(kp), v)
        for kp, v in jax.tree_util.tree_leaves_with_path(mask)
    )
    changed_adapter = frozen_ok = adapter_count = 0
    for kp, v0 in flat0:
        key = jax.tree_util.keystr(kp)
        v1 = flat1[key]
        if flatm[key]:
            adapter_count += 1
            if not np.allclose(v0, v1):
                changed_adapter += 1
        else:
            assert np.array_equal(v0, v1), f"frozen param changed: {key}"
            frozen_ok += 1
    assert adapter_count > 0 and changed_adapter > 0 and frozen_ok > 0


def test_grad_accum_matches_big_batch(rng):
    """MultiSteps(k) over k micro-batches == one step on the concat batch
    (same grads when loss is a mean over examples with equal weights)."""
    opt = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=10, schedule="constant",
        grad_clip_norm=1e9, weight_decay=0.0,
    )
    # NB: dataclasses.replace is shallow — build each path's config with its
    # own TrainConfig/OptimizerConfig so one can't mutate the other.
    cfg = dataclasses.replace(
        TINY_EXP, train=dataclasses.replace(TINY_EXP.train, optimizer=opt)
    )
    params = ModelBundle._init_params(cfg)
    b1 = _tiny_batch(np.random.RandomState(1))
    b2 = _tiny_batch(np.random.RandomState(2))

    # accumulated path
    acc_cfg = dataclasses.replace(
        cfg,
        train=dataclasses.replace(
            cfg.train, optimizer=dataclasses.replace(opt, grad_accum_steps=2)
        ),
    )
    _, _, tx_a, step_a = build_train_setup(acc_cfg, params)
    st_a = init_state(acc_cfg, tx_a, params)
    st_a, _ = step_a(st_a, b1)
    st_a, _ = step_a(st_a, b2)

    # big-batch path (fresh params: the accum path donated the first tree)
    params_b = ModelBundle._init_params(cfg)
    big = {k: jnp.concatenate([b1[k], b2[k]]) for k in b1}
    _, _, tx_b, step_b = build_train_setup(cfg, params_b)
    st_b = init_state(cfg, tx_b, params_b)
    st_b, _ = step_b(st_b, big)

    da = jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(), st_a.params, st_b.params)
    assert max(jax.tree_util.tree_leaves(da)) < 1e-5


def test_schedules_shapes():
    cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    for name in ["cosine", "linear", "constant", "noam"]:
        s = make_schedule(dataclasses.replace(cfg, schedule=name))
        v0, vw, vend = float(s(0)), float(s(10)), float(s(99))
        assert np.isfinite([v0, vw, vend]).all()
        if name in ("cosine", "linear"):
            assert vw == pytest.approx(1e-3, rel=1e-2)
            assert vend < vw


def test_checkpoint_roundtrip(tmp_path, rng):
    from jiao_liao_asr.train.checkpoints import (
        TrainCheckpointer,
        load_adapter_only,
        save_adapter_only,
    )

    cfg = dataclasses.replace(TINY_EXP)
    cfg.ctc_model = dataclasses.replace(
        cfg.ctc_model, adapter=AdapterConfig(kind="bottleneck", bottleneck_dim=8)
    )
    params = ModelBundle._init_params(cfg)
    _, _, tx, step = build_train_setup(cfg, params)
    state = init_state(cfg, tx, params)
    state, _ = step(state, _tiny_batch(rng))

    ck = TrainCheckpointer(str(tmp_path / "ck"), keep=2)
    ck.save(1, state, {"data_iter": {"epoch": 0, "cursor": 3}})
    step_n, restored, extra = ck.restore(state)
    assert step_n == 1
    assert extra["data_iter"]["cursor"] == 3
    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(),
        restored.params, state.params,
    )
    assert max(jax.tree_util.tree_leaves(d)) == 0.0

    # adapter-only artifact round-trip
    p = tmp_path / "adapter.npz"
    save_adapter_only(str(p), state.params)
    fresh = ModelBundle._init_params(cfg)
    merged = load_adapter_only(str(p), fresh)
    mask = adapter_mask(state.params)
    ok = jax.tree_util.tree_map(
        lambda m, a, b: (np.allclose(a, b) if m else True),
        mask, merged, state.params,
    )
    assert all(jax.tree_util.tree_leaves(ok))


def test_remat_matches_no_remat(rng):
    """jax.checkpoint on blocks: identical loss/params, less live memory."""
    cfg = dataclasses.replace(TINY_EXP)
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=3, schedule="constant"
    )
    batch = _tiny_batch(rng)

    params = ModelBundle._init_params(cfg)
    _, _, tx, step = build_train_setup(cfg, params)
    st = init_state(cfg, tx, params)
    st1, m1 = step(st, batch)

    cfg_r = dataclasses.replace(
        cfg, ctc_model=dataclasses.replace(cfg.ctc_model, remat=True)
    )
    params2 = ModelBundle._init_params(cfg_r)
    _, _, tx2, step2 = build_train_setup(cfg_r, params2)
    st2 = init_state(cfg_r, tx2, params2)
    st2, m2 = step2(st2, batch)

    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(),
        st1.params, st2.params,
    )
    # remat re-runs the forward with XLA free to re-fuse, so accumulation
    # order (and hence f32 rounding) can shift a few ulps vs the no-remat
    # step; 1e-4 still catches any real gradient defect (those land >1e-2)
    assert max(jax.tree_util.tree_leaves(d)) < 1e-4
