"""Parameters as plain nested dicts, layers as functions over a `Scope`.

Every layer is a function (or a dataclass whose `__call__` is one) that takes
a `Scope` first. The scope holds the layer's own subtree of the param dict;
`scope.child(name)` descends one level, and `scope.param(name, init, shape)`
reads a leaf, creating it only while the model is being initialised. One
code path therefore both builds the param tree (`Module.init`) and runs the
model (`Module.apply`), and the tree's key paths are exactly the names the
code passes to `child` and `param`. `whisper_import.py`, the adapter masks
(`train/engine.py`) and the tensor-parallel rules (`parallel/tp_rules.py`)
all address params by those paths.

The numerics follow the usual conventions for mixed precision: params are
stored in float32 and cast to the compute dtype at use; LayerNorm statistics
are taken in float32.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Initializer = Callable[..., jnp.ndarray]
lecun_normal = jax.nn.initializers.lecun_normal
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones
normal = jax.nn.initializers.normal
variance_scaling = jax.nn.initializers.variance_scaling


class Scope:
    """A view of one subtree of the param dict, plus the random streams.

    `init_key` is set only while initialising: then missing params are
    created (each from the init key folded with a hash of its path, so a
    param's initial value does not depend on call order). `rngs` maps a
    stream name ("dropout") to a key; `make_rng` derives a key from it, the
    scope's path and how often that path has asked, so the keys a layer
    draws do not depend on what else ran (or was rematerialized) before."""

    def __init__(
        self,
        params: Dict[str, Any],
        *,
        init_key=None,
        rngs: Optional[Dict[str, Any]] = None,
        path: Tuple[str, ...] = (),
        counters: Optional[Dict[Tuple[str, ...], int]] = None,
    ):
        self.params = params
        self.init_key = init_key
        self.rngs = rngs or {}
        self.path = path
        self._counters = counters if counters is not None else {}

    @property
    def initializing(self) -> bool:
        return self.init_key is not None

    def child(self, name: str) -> "Scope":
        if self.initializing:
            sub = self.params.setdefault(name, {})
        else:
            try:
                sub = self.params[name]
            except KeyError:
                raise KeyError(f"missing params {'/'.join(self.path + (name,))}")
        return Scope(
            sub, init_key=self.init_key, rngs=self.rngs,
            path=self.path + (name,), counters=self._counters,
        )

    def has(self, name: str) -> bool:
        return name in self.params

    def param(
        self,
        name: str,
        init: Initializer,
        shape: Sequence[int],
        dtype=jnp.float32,
    ) -> jnp.ndarray:
        if name in self.params:
            return self.params[name]
        if not self.initializing:
            raise KeyError(f"missing param {'/'.join(self.path + (name,))}")
        key = jax.random.fold_in(self.init_key, _path_hash(self.path + (name,)))
        value = init(key, tuple(shape), dtype)
        self.params[name] = value
        return value

    def make_rng(self, stream: str = "dropout"):
        if stream not in self.rngs:
            raise ValueError(
                f"no {stream!r} key: pass rngs={{{stream!r}: key}} to apply"
            )
        n = self._counters.get(self.path, 0) + 1
        self._counters[self.path] = n
        key = jax.random.fold_in(self.rngs[stream], _path_hash(self.path))
        return jax.random.fold_in(key, n)


def _path_hash(path: Tuple[str, ...]) -> int:
    return zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF


def _prune_empty(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune_empty(v)
            if not v:
                continue
        out[k] = v
    return out


class Module:
    """Base for the model classes: `init` builds {"params": tree}, `apply`
    runs a forward method over a given tree. Forward methods take a Scope
    first; `method=` names one (a bound or unbound method, or its name)."""

    def _method(self, method) -> Callable:
        if method is None:
            return self.__call__
        name = method if isinstance(method, str) else method.__name__
        return getattr(self, name)

    def init(self, rngs, *args, method=None, **kwargs) -> Dict[str, Any]:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        params: Dict[str, Any] = {}
        scope = Scope(params, init_key=rngs["params"], rngs=rngs)
        self._method(method)(scope, *args, **kwargs)
        return {"params": _prune_empty(params)}

    def apply(self, variables, *args, method=None, rngs=None, **kwargs):
        scope = Scope(variables["params"], rngs=rngs)
        return self._method(method)(scope, *args, **kwargs)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def dense(
    s: Scope,
    x: jnp.ndarray,
    features: int,
    dtype=jnp.float32,
    use_bias: bool = True,
    kernel_init: Initializer = lecun_normal(),
) -> jnp.ndarray:
    """x [..., d_in] @ kernel [d_in, features] (+ bias), in `dtype`."""
    kernel = s.param("kernel", kernel_init, (x.shape[-1], features))
    y = jax.lax.dot_general(
        x.astype(dtype), kernel.astype(dtype), (((x.ndim - 1,), (0,)), ((), ()))
    )
    if use_bias:
        y = y + s.param("bias", zeros, (features,)).astype(dtype)
    return y


def layer_norm(s: Scope, x: jnp.ndarray, dtype=jnp.float32, eps: float = 1e-5):
    """LayerNorm over the last axis: statistics in float32, output in dtype."""
    d = x.shape[-1]
    scale = s.param("scale", ones, (d,))
    bias = s.param("bias", zeros, (d,))
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(dtype)


def conv1d(
    s: Scope,
    x: jnp.ndarray,
    features: int,
    kernel_size: int,
    stride: int = 1,
    padding: Tuple[int, int] = (0, 0),
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Channels-last 1-D convolution: x [B, T, C_in] -> [B, T', features];
    kernel [kernel_size, C_in, features] plus bias."""
    kernel = s.param("kernel", lecun_normal(), (kernel_size, x.shape[-1], features))
    bias = s.param("bias", zeros, (features,))
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), kernel.astype(dtype), (stride,), (padding,),
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    return y + bias.astype(dtype)


def dropout(
    s: Scope, x: jnp.ndarray, rate: float, deterministic: bool
) -> jnp.ndarray:
    if deterministic or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(s.make_rng("dropout"), keep, x.shape)
    return jnp.where(mask, x / keep, jnp.zeros_like(x))


def remat_call(s: Scope, fn: Callable, x: jnp.ndarray, *args) -> jnp.ndarray:
    """fn(s, x, *args) with its activations recomputed on the backward pass
    (jax.checkpoint). `x` and the array leaves of `args` are the traced
    inputs; everything else in `args` is static. The dropout stream enters
    as an explicit key; keys derive from paths (Scope.make_rng), so the
    masks are the ones the same call draws without remat."""
    if s.initializing:
        return fn(s, x, *args)
    key = s.rngs.get("dropout")
    leaves, treedef = jax.tree_util.tree_flatten(
        args, is_leaf=lambda a: a is None
    )
    is_arr = [isinstance(a, jax.Array) for a in leaves]
    arrays = [a for a, t in zip(leaves, is_arr) if t]

    def pure(params, key, x, arrays):
        it = iter(arrays)
        full = [next(it) if t else a for a, t in zip(leaves, is_arr)]
        inner = Scope(
            params, rngs={"dropout": key} if key is not None else None,
            path=s.path,
        )
        return fn(inner, x, *jax.tree_util.tree_unflatten(treedef, full))

    return jax.checkpoint(pure)(s.params, key, x, arrays)
