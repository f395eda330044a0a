"""Tensor-parallel sharding rules for the transformer backbones.

The reference has no TP (SURVEY.md §2.3 — DDP only); this is the
extension for whisper-large-v3 scale: Megatron-style column/row sharding of
the attention and MLP matmuls over the mesh 'model' axis, expressed purely
as parameter shardings — XLA's SPMD partitioner propagates them through the
jitted step and inserts the all-reduces (no hand-written collectives).

Rules (path-suffix matched on the param tree):
  q/k/v_proj kernel [d_in, d_out]   -> P(fsdp?, 'model')   (column)
  out_proj   kernel [d_in, d_out]   -> P('model', None)    (row)
  fc1        kernel [d, mlp]        -> P(None, 'model')    (column)
  fc2        kernel [mlp, d]        -> P('model', None)    (row)
  fc1 / qkv  bias                   -> P('model')
  embed_tokens.embedding [V, d]     -> P('model', None)    (vocab shard)
  everything else                   -> replicated (or fsdp via mesh.py)
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_COLUMN_KERNELS = ("q_proj", "k_proj", "v_proj", "fc1")
_ROW_KERNELS = ("out_proj", "fc2")


def _path_strs(kp) -> list:
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]


def tp_param_sharding(mesh: Mesh, params: Any) -> Any:
    """NamedSharding tree implementing the rules above. Axes whose size
    doesn't divide the 'model' axis length fall back to replication."""
    tp = mesh.shape["model"]

    def rule(kp, p):
        keys = _path_strs(kp)
        # non-array leaves (optax MaskedNode, schedule scalars) replicate —
        # the rule also runs over OPTIMIZER state (mu/nu carry the param
        # path as a suffix), where such leaves are routine
        nd = getattr(p, "ndim", 0)
        shape = getattr(p, "shape", ())
        if tp == 1 or nd == 0:
            return NamedSharding(mesh, P())
        # locate the owning module name (…/<module>/dense/kernel)
        mod = ""
        for k in keys:
            if k in _COLUMN_KERNELS + _ROW_KERNELS:
                mod = k
        leaf = keys[-1]
        if leaf == "kernel" and nd == 2:
            if mod in _COLUMN_KERNELS and shape[1] % tp == 0:
                return NamedSharding(mesh, P(None, "model"))
            if mod in _ROW_KERNELS and shape[0] % tp == 0:
                return NamedSharding(mesh, P("model", None))
        if leaf == "bias" and mod in _COLUMN_KERNELS and shape[0] % tp == 0:
            return NamedSharding(mesh, P("model"))
        if leaf == "embedding" and nd == 2 and shape[0] % tp == 0:
            return NamedSharding(mesh, P("model", None))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(rule, params)


def apply_tp(mesh: Mesh, params: Any) -> Any:
    """device_put the params with TP shardings."""
    sh = tp_param_sharding(mesh, params)
    return jax.tree_util.tree_map(jax.device_put, params, sh)


def fsdp_tp_sharding(mesh: Mesh, params: Any) -> Any:
    """Combined rules for large backbones: TP (Megatron column/row) where a
    rule matches, FSDP largest-axis sharding otherwise — the whisper-large-v3
    layout (SURVEY §2.3). A TP'd kernel additionally FSDP-shards its
    replicated axis when divisible, so weights scale with BOTH axes."""
    from .mesh import _fsdp_rule

    tp = tp_param_sharding(mesh, params)
    fsdp_n = mesh.shape["fsdp"]
    base = _fsdp_rule(mesh)

    def merge(p, tpsh):
        nd = getattr(p, "ndim", 0)
        spec = tuple(tpsh.spec) + (None,) * (nd - len(tpsh.spec))
        if all(s is None for s in spec):
            return base(p)
        if fsdp_n > 1 and nd >= 2:
            # shard the largest non-TP axis over fsdp too
            free = [i for i, s in enumerate(spec) if s is None]
            if free:
                ax = max(free, key=lambda i: p.shape[i])
                if p.shape[ax] % fsdp_n == 0:
                    spec = tuple(
                        "fsdp" if i == ax else s for i, s in enumerate(spec)
                    )
        return NamedSharding(mesh, P(*spec))

    return jax.tree_util.tree_map(merge, params, tp)
