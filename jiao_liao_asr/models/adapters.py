"""Adapter family: bottleneck baseline, WFAdapter, AttAdapter.

The reference paper's contribution (README.md:1): two novel adapters —
"WFAdapter (adapter with weight factorization)" and "AttAdapter (adapter
with attention)" — injected into a frozen pretrained backbone for
multi-dialect knowledge transfer, compared against conventional bottleneck
adapters. No peft in the reference lockfile => they are hand-written modules
(SURVEY.md C9-C11). Design notes:

* ``WFAdapter`` is a *fused low-rank insert*: the effective weight is
  W + A @ diag(g) @ B, evaluated as x@W + ((x@A)*g)@B so the frozen W matmul
  stays a single large GEMM and the insert adds two skinny matmuls — no
  materialized W', no extra device-memory copy of the backbone weight.
* ``AttAdapter`` is a small residual attention block (few heads, low key
  dim) over the layer-normalized hidden states.
* ``BottleneckAdapter`` is the conventional down-project -> nonlinearity ->
  up-project residual adapter.

All adapter params live under a scope name prefixed ``adapter_`` so the
training engine can derive the frozen-backbone/trainable mask purely from
the param tree (train/engine.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..utils.config import AdapterConfig  # re-export for models/__init__
from .module import Scope, dense, dropout, layer_norm, lecun_normal, ones, zeros

ADAPTER_PREFIX = "adapter_"


def param_is_adapter(path: tuple) -> bool:
    """True if a param path (tuple of str keys) belongs to an adapter."""
    return any(isinstance(k, str) and k.startswith(ADAPTER_PREFIX) for k in path)


def bottleneck_adapter(
    s: Scope, cfg: AdapterConfig, h: jnp.ndarray, dtype, deterministic: bool
) -> jnp.ndarray:
    """Conventional adapter: h + scale * up(act(down(LN(h)))) (SURVEY C11)."""
    z = layer_norm(s.child("ln"), h, dtype)
    z = dense(s.child("down"), z, cfg.bottleneck_dim, dtype)
    z = jax.nn.gelu(z, approximate=False)
    z = dropout(s, z, cfg.dropout, deterministic)
    # zero-initialised up-projection: the adapter starts as the identity
    z = dense(s.child("up"), z, h.shape[-1], dtype, kernel_init=zeros)
    return h + cfg.scale * z


def wf_adapter(
    s: Scope,
    cfg: AdapterConfig,
    x: jnp.ndarray,
    frozen_out: jnp.ndarray,
    features: int,
    dtype,
) -> jnp.ndarray:
    """Weight-factorized adapter: a fused low-rank insert on a frozen Dense.

    Called with the *input* of a backbone Dense layer and its frozen output;
    adds ((x @ A) * g) @ B, i.e. the effective weight becomes
    W + A @ diag(g) @ B with A in R^{d_in x r}, g in R^r, B in R^{r x d_out}.
    g is the weight-factorization gate: per-rank learned scales that let the
    model modulate each factor's contribution across dialects. B is
    zero-initialized so injection starts as the identity.
    """
    r = cfg.wf_rank
    a = s.param("a", lecun_normal(), (x.shape[-1], r))
    g = s.param("g", ones, (r,))
    b = s.param("b", zeros, (r, features))
    z = jnp.dot(x, a.astype(dtype))
    z = z * g.astype(dtype)
    z = jnp.dot(z, b.astype(dtype))
    return frozen_out + cfg.scale * z


def att_adapter(
    s: Scope,
    cfg: AdapterConfig,
    h: jnp.ndarray,
    dtype,
    mask: Optional[jnp.ndarray] = None,
    deterministic: bool = True,
    kv_cache: Optional[dict] = None,
    cache_index: Optional[jnp.ndarray] = None,
):
    """Attention adapter: h + scale * out(MHA(LN(h))) with small head count
    and key dim — the paper's "adapter with attention" (README.md:1).

    Supports KV-cached incremental decode exactly like the backbone
    self-attention (kv_cache dict + cache_index), so the decoded function is
    the trained function: during teacher-forced training the adapter attends
    over the causal prefix, and during decode it attends over cached
    positions 0..pos rather than only the current token.
    """
    from .layers import dot_product_attention, update_cache_rows

    H, dk = cfg.att_num_heads, cfg.att_key_dim
    z = layer_norm(s.child("ln"), h, dtype)
    # one merged [d, 3*H*dk] projection feeds q/k/v: the adapter's matmuls
    # are small enough that three separate launches cost more than one
    qkv = dense(s.child("qkv_proj"), z, 3 * H * dk, dtype)
    q, k, v = jnp.split(qkv, 3, axis=-1)
    new_cache = None
    if kv_cache is not None:
        k = update_cache_rows(kv_cache["k"], k, cache_index, 1)
        v = update_cache_rows(kv_cache["v"], v, cache_index, 1)
        new_cache = {"k": k, "v": v}
    B, Tq = q.shape[0], q.shape[1]
    Tk = k.shape[1]
    out = dot_product_attention(
        q.reshape(B, Tq, H, dk),
        k.reshape(B, Tk, H, dk),
        v.reshape(B, Tk, H, dk),
        mask,
    )
    out = out.reshape(B, Tq, H * dk)
    out = dense(s.child("out_proj"), out, h.shape[-1], dtype, kernel_init=zeros)
    out = dropout(s, out, cfg.dropout, deterministic)
    y = h + cfg.scale * out
    if kv_cache is not None:
        return y, new_cache
    return y


def adapter_slot(
    s: Scope,
    cfg: AdapterConfig,
    h: jnp.ndarray,
    dtype,
    mask: Optional[jnp.ndarray] = None,
    deterministic: bool = True,
    kv_cache: Optional[dict] = None,
    cache_index: Optional[jnp.ndarray] = None,
):
    """Injection point placed after attention / MLP sublayers.

    Dispatches on cfg.kind; `kind='wf'` is handled inside wf_dense instead
    (it must wrap a Dense, not follow it), so a WF config makes this slot a
    no-op for the residual stream. Returns (h, kv_cache) when a cache is
    given, else h.
    """
    if cfg.kind == "bottleneck":
        out = bottleneck_adapter(
            s.child(f"{ADAPTER_PREFIX}bn"), cfg, h, dtype, deterministic
        )
        return (out, kv_cache) if kv_cache is not None else out
    if cfg.kind == "att":
        return att_adapter(
            s.child(f"{ADAPTER_PREFIX}att"), cfg, h, dtype, mask, deterministic,
            kv_cache=kv_cache, cache_index=cache_index,
        )
    return (h, kv_cache) if kv_cache is not None else h


def wf_dense(
    s: Scope,
    x: jnp.ndarray,
    features: int,
    cfg: Optional[AdapterConfig] = None,
    dtype=jnp.bfloat16,
    use_bias: bool = True,
) -> jnp.ndarray:
    """Dense layer with an optional fused WFAdapter low-rank insert.

    The backbone kernel lives under "dense"; when cfg.kind == 'wf', the
    adapter params ride alongside it under "adapter_wf". An int8-quantized
    serving tree (ModelBundle.quantize) replaces "dense" with "dense_q":
    int8 kernel + per-output-channel f32 scales, bias unquantized.
    """
    if s.has("dense_q"):
        from ..ops.quant import int8_matmul

        dq = s.params["dense_q"]
        y = int8_matmul(x.astype(dtype), dq["kernel_q"], dq["scale"])
        if use_bias:
            y = y + dq["bias"].astype(dtype)
    else:
        y = dense(s.child("dense"), x, features, dtype, use_bias=use_bias)
    if cfg is not None and cfg.kind == "wf":
        y = wf_adapter(s.child(f"{ADAPTER_PREFIX}wf"), cfg, x, y, features, dtype)
    return y
