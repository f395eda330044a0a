"""Multi-host (multi-process) SPMD runtime (SURVEY.md C19/§5.8).

The reference's one distributed mode is multi-process DDP: `accelerate
launch` spawns one process per GPU and torch.distributed/NCCL all-reduces
gradients (/root/reference/requirements.txt:1,75). The equivalent here is
JAX multi-controller SPMD: every host runs the SAME program,
`jax.distributed.initialize` wires the processes into one runtime, the mesh
spans ALL hosts' devices, and each host feeds only its local shard of every
global batch (`jax.make_array_from_process_local_data`). Collectives are
compiled XLA ops — no communicator to manage in user code.

Launch: coordinator address + process count + process id via arguments or
JL_COORDINATOR / JL_NUM_PROCESSES / JL_PROCESS_ID env vars. On the CPU backend, cross-process collectives need the gloo
    implementation, configured here before backend init.

Division of labor once initialized:
  * data: BatchIterator computes the SAME global epoch plan on every host
    (seeded shuffle) and collates only rows [p*B/np, (p+1)*B/np) of each
    global batch (data/pipeline.py).
  * step: parallel.mesh.shard_batch assembles the global array from local
    shards; shard_state places params/opt-state with FSDP+ZeRO shardings
    across all hosts' devices.
  * IO: metrics/extra.json/gc are primary-process-only; the checkpoint
    gather is multihost-collective (train/checkpoints.py).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Must run before any backend use; args or JL_* env vars supply the
    topology.
    """
    if jax.distributed.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("JL_COORDINATOR")
    if num_processes is None and os.environ.get("JL_NUM_PROCESSES"):
        num_processes = int(os.environ["JL_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JL_PROCESS_ID"):
        process_id = int(os.environ["JL_PROCESS_ID"])
    # CPU backend: cross-process collectives require gloo (a config knob,
    # not a wheel — bundled with jaxlib). Harmless on other backends.
    try:
        if jax.config.jax_platforms == "cpu" or os.environ.get("JAX_PLATFORMS") == "cpu":
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    """True on the process that owns host-side IO (metrics, manifest-level
    checkpoint metadata, retention gc) — the DDP rank-0 equivalent."""
    return jax.process_index() == 0


def barrier(tag: str = "jl_barrier") -> None:
    """Block until every process reaches this point (no-op single-process).

    Used around checkpoint retention gc so the primary never deletes a
    directory another host is still writing.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(tag)
