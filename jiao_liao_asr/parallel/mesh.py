"""Device mesh + sharding rules (SURVEY.md §5.8).

Axes:
  data  — batch sharding (the reference's DDP equivalent; gradient psum
          falls out of pjit instead of an NCCL all-reduce)
  fsdp  — parameter/optimizer sharding for large backbones (ZeRO-3-style;
          absent in the reference, an addition per SURVEY §2.3)
  model — tensor parallelism for whisper-large matmuls (optional)

Collectives ride ICI within a slice; the mesh builder orders axes so `data`
maps to the slowest-varying (DCN-adjacent) dimension when multi-slice.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.config import MeshConfig


def build_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'fsdp', 'model') mesh over the available devices.

    data_axis=-1 means "all devices not claimed by fsdp/model".
    """
    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    fsdp = max(cfg.fsdp_axis, 1)
    model = max(cfg.model_axis, 1)
    if n % (fsdp * model) != 0:
        raise ValueError(f"{n} devices not divisible by fsdp*model={fsdp * model}")
    data = cfg.data_axis if cfg.data_axis > 0 else n // (fsdp * model)
    if data * fsdp * model != n:
        raise ValueError(
            f"mesh {data}x{fsdp}x{model} != {n} devices; fix MeshConfig"
        )
    arr = np.asarray(devices).reshape(data, fsdp, model)
    return Mesh(arr, cfg.axis_names)


def build_mesh_for_batch(
    cfg: Optional[MeshConfig], batch_size: int, devices: Optional[Sequence] = None
) -> Mesh:
    """Build a mesh whose ('data','fsdp') product divides the batch size.

    With data_axis=-1 (auto), the data axis is the largest device count whose
    product with fsdp divides batch_size — so small debug batches run on a
    sub-mesh instead of erroring, while production batches (divisible by the
    device count) use every chip. An explicit data_axis is honored verbatim.
    """
    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else jax.devices())
    fsdp = max(cfg.fsdp_axis, 1)
    model = max(cfg.model_axis, 1)
    if cfg.data_axis > 0:
        need = cfg.data_axis * fsdp * model
        if need > len(devices):
            raise ValueError(
                f"mesh needs {need} devices but only {len(devices)} available"
            )
        return build_mesh(cfg, devices[:need])
    avail = len(devices) // (fsdp * model)
    data = 1
    for d in range(avail, 0, -1):
        if batch_size % (d * fsdp) == 0:
            data = d
            break
    import dataclasses

    sub = devices[: data * fsdp * model]
    return build_mesh(dataclasses.replace(cfg, data_axis=data), sub)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over 'data' (and 'fsdp' for the input
    pipeline, since fsdp groups also consume distinct batch shards)."""
    return NamedSharding(mesh, P(("data", "fsdp")))


def _fsdp_rule(mesh: Mesh):
    """Shape -> NamedSharding rule for FSDP leaves.

    Policy: shard the largest axis of every >=2D array over 'fsdp' when its
    size is divisible by the axis length (XLA re-gathers per-layer); smaller
    arrays replicate. The rule is a pure function of the leaf SHAPE, which is
    what lets optimizer state (Adam mu/nu mirror the param shapes) pick up
    byte-identical shardings without any tree-structure bookkeeping.
    """
    fsdp_n = mesh.shape["fsdp"]
    repl = NamedSharding(mesh, P())

    def rule(p):
        if getattr(p, "ndim", 0) < 2 or fsdp_n == 1:
            return repl
        shape = p.shape
        axis = int(np.argmax(shape))
        if shape[axis] % fsdp_n == 0:
            spec = [None] * p.ndim
            spec[axis] = "fsdp"
            return NamedSharding(mesh, P(*spec))
        return repl

    return rule


def param_sharding(mesh: Mesh, params: Any) -> Any:
    """Parameter sharding rules for the production loop: FSDP largest-axis
    sharding (see _fsdp_rule); when the mesh carries a real 'model' axis,
    Megatron TP column/row rules (parallel/tp_rules.py) take precedence
    where they match, FSDP fills in the rest — so train_loop on a
    model_axis>1 MeshConfig runs genuine tensor parallelism, not silent
    replication."""
    if mesh.shape.get("model", 1) > 1:
        from .tp_rules import fsdp_tp_sharding

        return fsdp_tp_sharding(mesh, params)
    return jax.tree_util.tree_map(_fsdp_rule(mesh), params)


def opt_state_sharding(mesh: Mesh, opt_state: Any) -> Any:
    """ZeRO-style optimizer-state sharding (SURVEY §2.3 "FSDP-style
    param+optimizer sharding").

    Adam mu/nu (and MultiSteps grad accumulators) are param-shaped, so the
    shape-deterministic _fsdp_rule assigns them exactly the sharding of the
    param they track; scalar counts and schedule state replicate. Adam state
    is 2x params — this is the main memory win for large-v3 fine-tunes.
    On a TP mesh the path-suffix TP rules apply equally (mu/nu paths embed
    the param path), keeping optimizer shards aligned with their params.
    """
    if mesh.shape.get("model", 1) > 1:
        from .tp_rules import fsdp_tp_sharding

        return fsdp_tp_sharding(mesh, opt_state)
    return jax.tree_util.tree_map(_fsdp_rule(mesh), opt_state)


def _is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans devices this process cannot address —
    multi-host SPMD, where plain device_put of host data is illegal."""
    return jax.process_count() > 1 and any(
        d.process_index != jax.process_index() for d in mesh.devices.flat
    )


def _put_global(x: Any, sharding: NamedSharding) -> Any:
    """device_put that also works when `sharding` spans other hosts.

    Multi-host: the full host value (identical on every process — seeded
    init / restored checkpoint) is placed shard-by-shard on the local
    devices via make_array_from_callback; XLA never moves it over DCN.
    """
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        # already a global array (e.g. stage N+1 reusing stage N's sharded
        # params): placed correctly -> no-op; otherwise let device_put
        # compile the resharding collective
        return x if x.sharding == sharding else jax.device_put(x, sharding)
    arr = np.asarray(x)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def shard_state(mesh: Mesh, state: Any) -> Any:
    """Place a TrainState with FSDP param+opt sharding, replicating scalars
    (step, rng). The single entry point production training uses; handles
    single- and multi-process meshes (every process holds the same host
    values, each placing only its addressable shards)."""
    put = jax.tree_util.tree_map
    return state.replace(
        params=put(lambda x, s: _put_global(x, s), state.params,
                   param_sharding(mesh, state.params)),
        opt_state=put(lambda x, s: _put_global(x, s), state.opt_state,
                      opt_state_sharding(mesh, state.opt_state)),
        step=_put_global(state.step, replicated(mesh)),
        rng=_put_global(state.rng, replicated(mesh)),
    )


def shard_batch(mesh: Mesh, batch: Any, global_rows: Optional[int] = None) -> Any:
    """Device-put a host batch with leading-axis sharding.

    Single-process: device_put with ('data','fsdp') sharding; ragged batches
    (leading dim not divisible by the data axes) fall back to replication —
    still correct, just without DP speedup for that batch.

    Multi-process (SURVEY C19 — the reference's multi-process DDP): each
    host passes its LOCAL slice of the global batch plus `global_rows`, the
    full cross-process batch size; jax.make_array_from_process_local_data
    assembles the global sharded array. Arrays whose leading dim equals
    `global_rows` (the ragged fallback, where every host collated the full
    batch) replicate instead.
    """
    sh = batch_sharding(mesh)
    n = mesh.shape["data"] * mesh.shape["fsdp"]
    repl = replicated(mesh)

    if _is_multiprocess(mesh):
        nproc = jax.process_count()
        gr = global_rows

        def put_mp(x):
            x = np.asarray(x)
            is_shard = (
                x.ndim >= 1
                and gr is not None
                and x.shape[0] * nproc == gr
                and gr % n == 0
            )
            return jax.make_array_from_process_local_data(
                sh if is_shard else repl, x
            )

        return jax.tree_util.tree_map(put_mp, batch)

    def put(x):
        divisible = getattr(x, "ndim", 0) >= 1 and x.shape[0] % n == 0
        return jax.device_put(x, sh if divisible else repl)

    return jax.tree_util.tree_map(put, batch)
