"""Mesh-integrated production training:

* run_experiment/train_loop build the mesh from config.mesh, shard every
  batch over ('data','fsdp'), and FSDP+ZeRO-shard params AND optimizer state
* the sharded loop reproduces single-device loss trajectories
* run_stages checkpoints per stage and survives kill-and-resume
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

# the slowest module in the suite (~2.5 min of XLA:CPU mesh compiles);
# run with JL_HEAVY=1 / -m heavy before committing parallel/train changes
pytestmark = pytest.mark.heavy
from jax.sharding import PartitionSpec as P

from jiao_liao_asr.data import CharTokenizer, Manifest, ManifestRow
from jiao_liao_asr.frontend.audio_io import write_wav
from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.parallel.mesh import (
    build_mesh,
    build_mesh_for_batch,
    opt_state_sharding,
    param_sharding,
    shard_state,
)
from jiao_liao_asr.train.engine import (
    build_train_setup,
    init_state,
    train_loop,
)
from jiao_liao_asr.utils.config import (
    AdapterConfig,
    CTCModelConfig,
    DataConfig,
    DialectStage,
    ExperimentConfig,
    MeshConfig,
    OptimizerConfig,
    SpecAugmentConfig,
)


def _cfg(batch=8, steps=4, adapters=False):
    cfg = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=24, d_model=64, num_layers=1, num_heads=4, mlp_dim=128,
            conv_channels=32, dtype="float32", dropout=0.0,
            adapter=AdapterConfig(kind="wf", wf_rank=4) if adapters else AdapterConfig(),
        ),
        specaugment=SpecAugmentConfig(enabled=False),
        data=DataConfig(batch_size=batch, bucket_boundaries_seconds=(1.5,),
                        min_audio_seconds=0.1, max_text_len=8),
    )
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=steps, schedule="constant"
    )
    cfg.train.train_adapters_only = adapters
    return cfg


def _corpus(tmp_path, rng, n=8):
    rows = []
    texts = ["你好", "世界", "胶辽", "官话", "语音", "识别", "大海", "山东"]
    for i in range(n):
        wav = (rng.randn(int(16000 * 1.0)) * 0.1).astype(np.float32)
        p = tmp_path / f"r{i}.wav"
        write_wav(p, wav, 16000)
        rows.append(ManifestRow(str(p), texts[i % len(texts)], 1.0, "jiaoliao"))
    return Manifest(rows)


def test_build_mesh_for_batch_auto_sizing():
    # batch 8 on 8 devices: full data parallelism
    m = build_mesh_for_batch(MeshConfig(), 8)
    assert m.shape["data"] == 8
    # batch 2: sub-mesh so sharding divides
    m = build_mesh_for_batch(MeshConfig(), 2)
    assert m.shape["data"] == 2
    # fsdp=2 claims its devices; data shrinks to divide batch 4
    m = build_mesh_for_batch(MeshConfig(fsdp_axis=2), 4)
    assert m.shape["fsdp"] == 2 and m.shape["data"] == 2
    # explicit data_axis is honored verbatim
    m = build_mesh_for_batch(MeshConfig(data_axis=4), 2)
    assert m.shape["data"] == 4


def test_opt_state_zero_sharding():
    """Adam mu/nu leaves carry the same fsdp spec as their params."""
    cfg = _cfg()
    mesh = build_mesh(MeshConfig(fsdp_axis=2), jax.devices()[:4])
    params = ModelBundle._init_params(cfg)
    _, _, tx, _ = build_train_setup(cfg, params, mesh)
    state = init_state(cfg, tx, params)
    psh = param_sharding(mesh, state.params)
    osh = opt_state_sharding(mesh, state.opt_state)

    def specs(tree):
        return {
            tuple(str(k) for k in kp): s.spec
            for kp, s in jax.tree_util.tree_flatten_with_path(tree)[0]
        }

    pspecs = specs(psh)
    n_sharded_params = sum(1 for s in pspecs.values() if "fsdp" in str(s))
    assert n_sharded_params > 0, "no param picked up an fsdp spec"
    ospecs = specs(osh)
    n_sharded_opt = sum(1 for s in ospecs.values() if "fsdp" in str(s))
    # Adam keeps mu and nu per param: at least 2x the sharded-param count
    assert n_sharded_opt >= 2 * n_sharded_params, (n_sharded_opt, n_sharded_params)

    # and shard_state actually applies them
    state = shard_state(mesh, state)
    flat = jax.tree_util.tree_flatten_with_path(state.opt_state)[0]
    applied = sum(
        1 for _, leaf in flat
        if hasattr(leaf, "sharding") and "fsdp" in str(getattr(leaf.sharding, "spec", ""))
    )
    assert applied >= 2 * n_sharded_params


def test_train_loop_mesh_matches_single_device(tmp_path, rng):
    """The production loop on the full 8-CPU ('data','fsdp') mesh reproduces
    the single-device loss trajectory (the DDP-parity requirement)."""
    manifest = _corpus(tmp_path, rng)
    results = {}
    for name, mesh_cfg in [
        ("single", MeshConfig(data_axis=1)),
        ("dp8", MeshConfig()),  # auto: data=8
        ("dp_fsdp", MeshConfig(fsdp_axis=2)),  # data=4, fsdp=2 + ZeRO
        # 3D: TP now rides the production loop via shard_state ->
        # fsdp_tp_sharding (r4 verdict item 4)
        ("dp_fsdp_tp", MeshConfig(data_axis=2, fsdp_axis=2, model_axis=2)),
    ]:
        cfg = _cfg(batch=8, steps=4, adapters=True)
        cfg.mesh = mesh_cfg
        cfg.train.checkpoint_dir = str(tmp_path / f"ck_{name}")
        tok = CharTokenizer.build(manifest.texts())
        cfg.ctc_model.vocab_size = len(tok)
        params = ModelBundle._init_params(cfg)
        state, info = train_loop(cfg, manifest, tok, params)
        results[name] = (np.asarray(state.params["ctc_head"]["kernel"]),
                         info["last_metrics"]["loss"])
        if name == "dp_fsdp_tp":
            # the TP run must actually shard over 'model' — a silently
            # replicated "TP" run would still pass the loss check
            model_sharded = sum(
                1 for leaf in jax.tree_util.tree_leaves(state.params)
                if "model" in str(getattr(getattr(leaf, "sharding", None),
                                          "spec", ""))
            )
            assert model_sharded > 0, "no param sharded over 'model'"
    for name in ["dp8", "dp_fsdp", "dp_fsdp_tp"]:
        assert abs(results[name][1] - results["single"][1]) < 1e-4, name
        assert np.abs(results[name][0] - results["single"][0]).max() < 1e-4, name


def test_run_stages_checkpoints_and_resumes(tmp_path, rng):
    """2-stage transfer schedule: killed mid-run via SIGTERM, then resumed —
    final params match an uninterrupted run exactly."""
    manifest_a = _corpus(tmp_path / "a", rng, n=4)
    manifest_b = _corpus(tmp_path / "b", rng, n=4)
    ma, mb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    from jiao_liao_asr.data import write_manifest

    write_manifest(manifest_a.rows, ma)
    write_manifest(manifest_b.rows, mb)

    def stage_cfg(ckpt_dir):
        cfg = _cfg(batch=2, steps=0, adapters=True)
        cfg.stages = (
            DialectStage(name="neighbor", manifests=(ma,), steps=3,
                         train_adapters_only=False),
            DialectStage(name="target", manifests=(mb,), steps=3,
                         train_adapters_only=True),
        )
        cfg.train.checkpoint_dir = ckpt_dir
        cfg.train.checkpoint_every_steps = 1
        return cfg

    from jiao_liao_asr.train.schedules import run_stages

    # uninterrupted reference
    cfg = stage_cfg(str(tmp_path / "ck_full"))
    params_full, tok, hist = run_stages(cfg)
    assert len(hist) == 2

    # interrupted in a subprocess: SIGTERM mid-run -> checkpoint-and-exit
    ck_dir = str(tmp_path / "ck_int")
    script = textwrap.dedent(f"""
        import jax
        jax.config.update("jax_platforms", "cpu")
        import sys
        sys.path.insert(0, {str(os.getcwd())!r})
        from tests.test_mesh_train import _cfg
        from jiao_liao_asr.train.schedules import run_stages
        from jiao_liao_asr.utils.config import DialectStage
        cfg = _cfg(batch=2, steps=0, adapters=True)
        cfg.stages = (
            DialectStage(name="neighbor", manifests=({ma!r},), steps=3,
                         train_adapters_only=False),
            DialectStage(name="target", manifests=({mb!r},), steps=3,
                         train_adapters_only=True),
        )
        cfg.train.checkpoint_dir = {ck_dir!r}
        cfg.train.checkpoint_every_steps = 1
        print("READY", flush=True)
        run_stages(cfg)
        print("DONE", flush=True)
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    proc = subprocess.Popen(
        [sys.executable, "-c", script], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    # wait for the READY marker (imports/jax init can take minutes on a
    # loaded host — a fixed sleep raced it and flaked), THEN give the run
    # a bounded head start before the kill
    seen = []
    deadline = time.time() + 300
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        if "READY" in line:
            break
    assert any("READY" in l for l in seen), "".join(seen)[-2000:]
    time.sleep(15)  # somewhere mid-schedule (compile + a few steps)
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    rest, _ = proc.communicate(timeout=240)
    out = "".join(seen) + (rest or "")

    # resume to completion in-process
    cfg2 = stage_cfg(ck_dir)
    params_res, _, _ = run_stages(cfg2, resume=True)

    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(),
        params_full, params_res,
    )
    assert max(jax.tree_util.tree_leaves(d)) == 0.0, "stage resume diverged"
