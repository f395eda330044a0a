"""Subprocess worker for tests/test_multihost.py: one SPMD process.

Runs the PRODUCTION train_loop (mesh build -> shard_state -> per-process
data sharding -> jitted step -> npz checkpoint) on an 8-device global mesh
split across `nproc` processes x (8/nproc) local CPU devices each, and
prints per-step losses as JSON on the last line. The same script with
nproc=1 is the single-process reference run the test compares against
(SURVEY §4.3 distributed-tests-without-a-cluster).

Usage: python multihost_worker.py <workdir> <nproc> <pid> <port> [--resume]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    workdir, nproc, pid, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    resume = "--resume" in sys.argv
    local_devices = 8 // nproc
    # REPLACE any inherited device-count flag (the test process's conftest
    # exports count=8; each worker needs exactly 8/nproc local devices)
    flags = [
        f
        for f in os.environ.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f
    ]
    flags.append(f"--xla_force_host_platform_device_count={local_devices}")
    os.environ["XLA_FLAGS"] = " ".join(flags)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        from jiao_liao_asr.parallel.multihost import initialize

        initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc,
            process_id=pid,
        )
    assert len(jax.devices()) == 8, f"want 8 global devices, got {len(jax.devices())}"

    from jiao_liao_asr.data.manifest import read_manifest
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.train.engine import (
        build_tokenizer_for,
        train_loop,
    )
    from jiao_liao_asr.utils.config import (
        AdapterConfig,
        CTCModelConfig,
        ExperimentConfig,
        MeshConfig,
    )

    config = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            d_model=64,
            num_layers=2,
            num_heads=4,
            mlp_dim=128,
            conv_channels=32,
            adapter=AdapterConfig(kind="wf", wf_rank=4),
        ),
        mesh=MeshConfig(fsdp_axis=2, model_axis=1),
    )
    config.data.train_manifest = os.path.join(workdir, "train.jsonl")
    config.data.batch_size = 8
    config.data.bucket_boundaries_seconds = [2.0]
    config.frontend.chunk_seconds = 2.0
    config.specaugment.enabled = False
    config.augment.enabled = False
    config.train.train_adapters_only = True
    config.train.optimizer.total_steps = 6 if resume else 4
    config.train.checkpoint_every_steps = 2
    config.train.log_every_steps = 1
    config.train.checkpoint_dir = os.path.join(workdir, f"ckpt_np{nproc}")
    config.train.metrics_path = os.path.join(workdir, f"metrics_np{nproc}.jsonl")

    manifest = read_manifest(config.data.train_manifest)
    tokenizer = build_tokenizer_for(config, manifest)
    params = ModelBundle._init_params(config, seed=0)

    # logger=None: train_loop creates the jsonl MetricsLogger on the primary
    # only — the test also asserts non-primary processes wrote nothing
    state, info = train_loop(config, manifest, tokenizer, params, resume=resume)
    if pid == 0:
        losses = [
            rec["loss"]
            for rec in map(json.loads, open(config.train.metrics_path))
            if "loss" in rec
        ]
    else:
        losses = [info["last_metrics"].get("loss", float("nan"))]
    print(
        "RESULT "
        + json.dumps(
            {
                "pid": pid,
                "losses": losses,
                "final_step": int(jax.device_get(state.step)),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
