"""Distributed tests on the 8-device CPU mesh (SURVEY.md §4.3): sharded
train step == single-device step, FSDP param sharding really shards, and
the graft entry dryrun passes."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.parallel.mesh import (
    batch_sharding,
    build_mesh,
    param_sharding,
    replicated,
)
from jiao_liao_asr.train.engine import (
    build_train_setup,
    init_state,
)
from jiao_liao_asr.utils.config import (
    CTCModelConfig,
    ExperimentConfig,
    MeshConfig,
    OptimizerConfig,
    SpecAugmentConfig,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual CPU devices"
)

CFG = ExperimentConfig(
    model_family="ctc",
    ctc_model=CTCModelConfig(
        vocab_size=32, d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
        conv_channels=32, dtype="float32", dropout=0.0,
    ),
    specaugment=SpecAugmentConfig(enabled=False),
)


def _batch(rng, B=8, samples=8000, V=32, S=6):
    return {
        "audio": rng.randn(B, samples).astype(np.float32) * 0.1,
        "audio_lengths": np.full((B,), samples, np.int32),
        "labels": rng.randint(2, V, (B, S)).astype(np.int32),
        "label_lengths": np.full((B,), S, np.int32),
    }


def test_mesh_shapes():
    mesh = build_mesh(MeshConfig(fsdp_axis=2), jax.devices())
    assert dict(mesh.shape) == {"data": 4, "fsdp": 2, "model": 1}
    mesh1 = build_mesh(MeshConfig(), jax.devices()[:1])
    assert dict(mesh1.shape) == {"data": 1, "fsdp": 1, "model": 1}


def test_dp_matches_single_device(rng):
    """Loss + updated params identical (tol) between replicated 8-way DP and
    single-device execution — the DDP-parity test the reference can't run
    without a cluster (SURVEY §4.3)."""
    cfg = dataclasses.replace(CFG)
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=5, schedule="constant"
    )
    params = ModelBundle._init_params(cfg)
    batch_host = _batch(rng)

    # single device
    _, _, tx, step = build_train_setup(cfg, params)
    st = init_state(cfg, tx, params)
    st1, m1 = step(st, {k: jnp.asarray(v) for k, v in batch_host.items()})

    # 8-way DP (re-init: the jitted step donates its input state buffers)
    params2 = ModelBundle._init_params(cfg)
    mesh = build_mesh(MeshConfig(), jax.devices())
    _, _, tx2, step2 = build_train_setup(cfg, params2, mesh)
    st2 = init_state(cfg, tx2, params2)
    rsh = replicated(mesh)
    bsh = batch_sharding(mesh)
    st2 = jax.device_put(st2, rsh)
    dbatch = {k: jax.device_put(v, bsh) for k, v in batch_host.items()}
    st2, m2 = step2(st2, dbatch)

    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(), st1.params, st2.params
    )
    # f32 reduction order differs once the batch is split across devices;
    # one adam step at lr=1e-3 keeps honest parity under 1e-4.
    assert max(jax.tree_util.tree_leaves(d)) < 1e-4


def test_fsdp_param_sharding_applies(rng):
    mesh = build_mesh(MeshConfig(fsdp_axis=2), jax.devices())
    params = ModelBundle._init_params(CFG)
    shardings = param_sharding(mesh, params)
    sharded = jax.tree_util.tree_map(jax.device_put, params, shardings)
    # at least one large param actually sharded over fsdp
    found = False
    for leaf in jax.tree_util.tree_leaves(sharded):
        spec = leaf.sharding.spec
        if any(s == "fsdp" for s in spec):
            found = True
            # addressable shard is half the param
            shard = leaf.addressable_shards[0].data
            assert shard.size == leaf.size // 2
    assert found


def test_fsdp_step_matches_single_device(rng):
    cfg = dataclasses.replace(CFG)
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=5, schedule="constant"
    )
    params = ModelBundle._init_params(cfg)
    batch_host = _batch(rng)

    _, _, tx, step = build_train_setup(cfg, params)
    st = init_state(cfg, tx, params)
    st1, m1 = step(st, {k: jnp.asarray(v) for k, v in batch_host.items()})

    params2 = ModelBundle._init_params(cfg)  # first step donated `params`
    mesh = build_mesh(MeshConfig(fsdp_axis=2), jax.devices())
    _, _, tx2, step2 = build_train_setup(cfg, params2, mesh)
    st2 = init_state(cfg, tx2, params2)
    psh = param_sharding(mesh, st2.params)
    st2 = st2.replace(
        params=jax.tree_util.tree_map(jax.device_put, st2.params, psh),
        opt_state=jax.device_put(st2.opt_state, replicated(mesh)),
        step=jax.device_put(st2.step, replicated(mesh)),
        rng=jax.device_put(st2.rng, replicated(mesh)),
    )
    bsh = batch_sharding(mesh)
    st2, m2 = step2(st2, {k: jax.device_put(v, bsh) for k, v in batch_host.items()})
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(), st1.params, st2.params
    )
    assert max(jax.tree_util.tree_leaves(d)) < 1e-4


def test_graft_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
