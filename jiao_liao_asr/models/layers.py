"""Shared transformer building blocks.

* params float32, compute bfloat16, logits float32
* pre-LN residual blocks (matches both Whisper and SB transformer recipes)
* attention goes through `jax.nn.dot_product_attention`: cuDNN's fused
  attention where the call's dtype, head dim and mask form allow it, XLA's
  otherwise (`attention_implementation` is the rule)
* static shapes everywhere; padding communicated via lengths or masks

Reference parity targets: WhisperEncoder/Decoder block structure
(SURVEY.md C7) and SpeechBrain TransformerASR encoder (SURVEY.md C8).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import AdapterConfig
from .adapters import adapter_slot, wf_dense
from .module import Scope, dense, dropout, layer_norm


# decode KV-cache layout switch (models/whisper.py / models/joint.py
# init_cache): head-major [B, H, T, dh] at batch >= this, packed [B, T, d]
# below. Which layout pays at which batch on the GPU is not measured yet.
HEAD_MAJOR_MIN_BATCH = 16


def sinusoidal_positions(length: int, dim: int, dtype=jnp.float32) -> jnp.ndarray:
    """Standard interleaved sin/cos table [length, dim] (Whisper layout:
    first half sin, second half cos)."""
    assert dim % 2 == 0
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return jnp.asarray(
        np.concatenate([np.sin(t), np.cos(t)], axis=1), dtype=dtype
    )


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


# The list that traced attention calls report their choice to while
# record_attention_choices() is active; None otherwise (nothing is kept).
_choices: Optional[list] = None


@contextlib.contextmanager
def record_attention_choices():
    """Collect (implementation, q shape, k shape, mask form) of every
    attention call traced inside the block; under a mesh the shapes are one
    device's block. Calls served from the jit cache are not traced, so they
    report nothing."""
    global _choices
    outer, _choices = _choices, []
    try:
        yield _choices
    finally:
        _choices = outer


def attention_implementation(
    dtype,
    head_dim: int,
    *,
    q_len: int = 2,
    general_mask: bool = False,
    window: Optional[Tuple[int, int]] = None,
    platform: Optional[str] = None,
) -> str:
    """Which `jax.nn.dot_product_attention` implementation a call takes.

    "cudnn" (cuDNN's fused flash attention, forward and backward) needs a
    GPU, half-precision inputs, a head dim that is a multiple of 8 and at
    most 128, and a mask that cuDNN builds itself: key lengths, causal, or
    a left-only window. A general boolean mask, or a window that reaches to
    the right, takes "xla". So does a single query row (a KV-cached decode
    step): it reads the keys once either way, as XLA's fused reductions do
    on the head-major cache path. `platform` defaults to JAX's default
    backend."""
    platform = platform or jax.default_backend()
    if platform != "gpu":
        return "xla"
    if jnp.dtype(dtype) not in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16)):
        return "xla"
    if head_dim % 8 or head_dim > 128 or q_len == 1:
        return "xla"
    if general_mask:
        return "xla"
    if window is not None and window[1] != 0:
        return "xla"
    return "cudnn"


def shard_axes(mesh, batch: int, heads: int):
    """(batch axes, head axis) that split one attention call over `mesh`:
    the axes other than 'model' over the batch, as many as their product
    divides it, and 'model' over the heads when it divides them. Attention
    is independent across both, so each device computes its block alone."""
    sizes = dict(mesh.shape)
    batch_axes, n = [], 1
    for a in mesh.axis_names:
        if a != "model" and batch % (n * sizes[a]) == 0:
            batch_axes.append(a)
            n *= sizes[a]
    head_axis = "model" if "model" in sizes and heads % sizes["model"] == 0 else None
    return tuple(batch_axes) or None, head_axis


def dot_product_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    kv_lengths: Optional[jnp.ndarray] = None,
    causal: bool = False,
    window: Optional[Tuple[int, int]] = None,
) -> jnp.ndarray:
    """[B, T, H, dh] attention, softmax in float32.

    mask: general boolean mask broadcastable to [B, H, Tq, Tk], True =
    attend. kv_lengths: [B] (or scalar) valid-key counts. causal: query i
    sees keys <= i. window: (left, right) band around each query, -1 =
    unbounded on that side. Lengths, causal and window may be combined with
    each other and with a mask; a mask sends the call to the XLA path.

    Traced under a mesh of several devices (`jax.set_mesh`: the train
    engine's step on a mesh, a sharded ModelBundle), the call runs per
    shard in `jax.shard_map`, split over batch and heads (`shard_axes`):
    each device attends over its own contiguous block, as on one device."""
    B, Tq, H, dh = q.shape
    Tk = k.shape[1]
    if kv_lengths is not None:
        kv_lengths = jnp.broadcast_to(jnp.asarray(kv_lengths, jnp.int32), (B,))
    if window is not None:
        left, right = window
        window = (Tk if left < 0 else left, Tk if right < 0 else right)
    impl = attention_implementation(
        q.dtype, dh, q_len=Tq, general_mask=mask is not None, window=window,
    )
    form = "mask" if mask is not None else "+".join(
        n for n, on in (("lengths", kv_lengths is not None), ("causal", causal),
                        ("window", window is not None)) if on
    ) or "none"

    def attend(q, k, v, mask, kv_lengths):
        if _choices is not None:
            _choices.append((impl, tuple(q.shape), tuple(k.shape), form))
        return jax.nn.dot_product_attention(
            q, k, v, mask=mask, is_causal=causal,
            key_value_seq_lengths=kv_lengths, local_window_size=window,
            implementation=impl,
        ).astype(q.dtype)

    mesh = jax.sharding.get_abstract_mesh()
    if mesh.size <= 1:
        return attend(q, k, v, mask, kv_lengths)
    P = jax.sharding.PartitionSpec
    b, h = shard_axes(mesh, B, H)
    if mask is not None:
        mask = mask.reshape((1,) * (4 - mask.ndim) + mask.shape)
    # check_vma=False: cuDNN attention's backward rule returns values with
    # no varying-axes type, which the check refuses
    return jax.shard_map(
        attend, mesh=mesh, check_vma=False,
        in_specs=(P(b, None, h),) * 3 + (
            None if mask is None else P(
                b if mask.shape[0] == B else None, h if mask.shape[1] == H else None
            ),
            None if kv_lengths is None else P(b),
        ),
        out_specs=P(b, None, h),
    )(q, k, v, mask, kv_lengths)


def reference_attention(q, k, v, mask=None) -> jnp.ndarray:
    """Plain einsum attention with an explicit boolean mask: the reference
    that the chosen implementation is checked against."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = jnp.einsum(
        "bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * scale
    if mask is not None:
        logits = jnp.where(mask, logits, jnp.finfo(jnp.float32).min)
    probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    return jnp.einsum(
        "bhqk,bkhd->bqhd", probs, v, preferred_element_type=jnp.float32
    ).astype(q.dtype)


def attention_mask(
    q_len: int,
    k_len: int,
    kv_lengths: Optional[jnp.ndarray] = None,
    causal: bool = False,
    window: Optional[Tuple[int, int]] = None,
) -> Optional[jnp.ndarray]:
    """The boolean [B or 1, 1, Tq, Tk] mask that (kv_lengths, causal,
    window) describe; None when they describe no masking."""
    if kv_lengths is None and not causal and window is None:
        return None
    qi = jnp.arange(q_len)[:, None]
    ki = jnp.arange(k_len)[None, :]
    m = jnp.ones((q_len, k_len), bool)
    if causal:
        m &= ki <= qi
    if window is not None:
        left, right = window
        if left >= 0:
            m &= ki >= qi - left
        if right >= 0:
            m &= ki <= qi + right
    m = m[None, None]
    if kv_lengths is not None:
        m = m & length_mask(jnp.atleast_1d(jnp.asarray(kv_lengths)), k_len)
    return m


def update_cache_rows(
    cache: jnp.ndarray, new: jnp.ndarray, index, time_axis: int
) -> jnp.ndarray:
    """Write one decode step's K/V rows into a cache at position `index`.

    `index` scalar -> lax.dynamic_update_slice (every batch row shares the
    position: the offline generate loops in decode/whisper_generate.py).
    `index` [B] vector -> per-row scatter: continuous-batching serving
    (serve/engine.py), where each slot sits at its OWN decode position
    because utterances join the batch mid-flight.

    Handles packed [B, T, ...] caches (time_axis=1), head-major
    [B, H, T, dh] caches and their [B, H, T] scale planes (time_axis=2).
    `new`'s time axis must have length 1 (one decode step)."""
    new = new.astype(cache.dtype)
    index = jnp.asarray(index, jnp.int32)
    if index.ndim == 0:
        starts = tuple(
            index if a == time_axis else 0 for a in range(cache.ndim)
        )
        return jax.lax.dynamic_update_slice(cache, new, starts)
    B = cache.shape[0]
    rows = jnp.arange(B)
    if time_axis == 1:
        return cache.at[rows, index].set(jnp.squeeze(new, 1))
    if time_axis == 2:
        H = cache.shape[1]
        return cache.at[rows[:, None], jnp.arange(H)[None, :], index[:, None]].set(
            jnp.squeeze(new, 2)
        )
    raise ValueError(f"unsupported cache time_axis {time_axis}")


def _key_mask(Tk: int, kv_lens, mask) -> jnp.ndarray:
    """[B or 1, 1 or H, Tq or 1, Tk] key validity for the decode paths:
    from threaded lengths when given, else from a mask (False-padded out to
    the cache horizon)."""
    if kv_lens is not None:
        return jnp.arange(Tk)[None, None, None, :] < kv_lens[:, None, None, None]
    return jnp.pad(mask, ((0, 0),) * 3 + ((0, Tk - mask.shape[-1]),))


def _int8_cache_attention(qh, kq, ks, vq, vs, kv_lens, mask, dtype):
    """Decode-step attention over int8 head-major caches (ops/quant.quantize_kv).

    qh [B, H, Tq, dh]; kq/vq int8 [B, H, Tk, dh]; ks/vs f32 [B, H, Tk]
    per-position scales. Scales commute with both contractions:
    logits[t] = (q . K[t]) * ks[t]; out = (p * vs) @ V, so the int8 rows are
    read as they are and the scales fold in elementwise.

    Validity: `kv_lens` [B] int32 valid-key counts, or None with `mask` a
    key-validity mask broadcastable to [B, H, Tq, Tk]. Both None = all Tk
    keys valid."""
    B, H, Tq, dh = qh.shape
    Tk = kq.shape[2]
    if kv_lens is None and mask is None:
        kv_lens = jnp.full((B,), Tk, jnp.int32)
    if kv_lens is not None:
        kv_lens = jnp.broadcast_to(jnp.asarray(kv_lens, jnp.int32), (B,))
    scale = 1.0 / np.sqrt(dh)
    s = (
        jnp.sum(
            qh[:, :, :, None, :].astype(jnp.float32)
            * kq[:, :, None, :, :].astype(jnp.float32),
            axis=-1,
        )
        * ks[:, :, None, :]
        * scale
    )  # [B, H, Tq, Tk] f32
    s = jnp.where(_key_mask(Tk, kv_lens, mask), s, jnp.finfo(jnp.float32).min)
    p = jax.nn.softmax(s, axis=-1)
    pv = p * vs[:, :, None, :]
    o = jnp.sum(
        pv[:, :, :, :, None] * vq[:, :, None, :, :].astype(jnp.float32), axis=3
    )  # [B, H, Tq, dh]
    return o.astype(dtype)


@dataclass(frozen=True)
class MultiHeadAttention:
    """MHA with optional cross-attention inputs and KV-cache decode step.

    Bias conventions are Whisper's (q/out/v biased, k unbiased) so imported
    reference weights map 1:1; harmless for from-scratch CTC training.
    """

    num_heads: int
    d_model: int
    dtype: jnp.dtype = jnp.bfloat16
    dropout: float = 0.0
    adapter: Optional[AdapterConfig] = None

    def __call__(
        self,
        s: Scope,
        x: jnp.ndarray,
        kv: Optional[jnp.ndarray] = None,
        mask: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
        kv_cache: Optional[dict] = None,
        cache_index: Optional[jnp.ndarray] = None,
        return_kv: bool = False,
        kv_lengths: Optional[jnp.ndarray] = None,
        causal: bool = False,
        window: Optional[Tuple[int, int]] = None,
        qk_sink: Optional[list] = None,
    ):
        """mask: a general boolean key mask; kv_lengths / causal / window:
        the structured forms, which the fused attention builds itself. The
        decode-cache paths take kv_lengths when given and the mask
        otherwise. qk_sink: a list that receives (q, k) of this call — the
        cross-attention capture of decode/align.py."""
        dh = self.d_model // self.num_heads
        H = self.num_heads
        kv_in = x if kv is None else kv
        wf = self.adapter if (self.adapter and self.adapter.kind == "wf") else None

        def proj(name, inp, use_bias=True):
            return wf_dense(
                s.child(name), inp, self.d_model, wf, self.dtype, use_bias
            )

        if return_kv:
            # cache-precompute mode: just the K/V projections of `kv_in`
            return {
                "k": proj("k_proj", kv_in, use_bias=False),
                "v": proj("v_proj", kv_in),
            }
        q = proj("q_proj", x)
        B, Tq = q.shape[0], q.shape[1]
        new_cache = None
        if kv_cache is not None and kv_cache["k"].ndim == 4:
            # head-major decode cache [B, H, T_cache, dh]
            qh = q.reshape(B, Tq, H, dh).transpose(0, 2, 1, 3)
            if kv is not None:
                # cross-attention: reuse the precomputed encoder K/V
                new_cache = kv_cache
            else:
                k = proj("k_proj", kv_in, use_bias=False)
                v = proj("v_proj", kv_in)
                kh = k.reshape(B, Tq, H, dh).transpose(0, 2, 1, 3)
                vh = v.reshape(B, Tq, H, dh).transpose(0, 2, 1, 3)
                if "k_scale" in kv_cache:
                    # int8 self cache: quantize the step's new rows per key
                    # position and update cache + scales in place
                    from ..ops.quant import quantize_kv

                    kq_new, ks_new = quantize_kv(kh)
                    vq_new, vs_new = quantize_kv(vh)
                    new_cache = {
                        "k": update_cache_rows(kv_cache["k"], kq_new, cache_index, 2),
                        "k_scale": update_cache_rows(
                            kv_cache["k_scale"], ks_new, cache_index, 2
                        ),
                        "v": update_cache_rows(kv_cache["v"], vq_new, cache_index, 2),
                        "v_scale": update_cache_rows(
                            kv_cache["v_scale"], vs_new, cache_index, 2
                        ),
                    }
                else:
                    new_cache = {
                        "k": update_cache_rows(kv_cache["k"], kh, cache_index, 2),
                        "v": update_cache_rows(kv_cache["v"], vh, cache_index, 2),
                    }
            Tk = new_cache["k"].shape[2]
            if kv_lengths is not None:
                kv_lens = jnp.broadcast_to(jnp.asarray(kv_lengths, jnp.int32), (B,))
            elif mask is None:
                kv_lens = jnp.full(
                    (B,), min(kv.shape[1], Tk) if kv is not None else Tk, jnp.int32
                )
            else:
                kv_lens = None  # mask-only: lengths are never inferred from it
            if "k_scale" in new_cache:
                o = _int8_cache_attention(
                    qh, new_cache["k"], new_cache["k_scale"],
                    new_cache["v"], new_cache["v_scale"],
                    kv_lens, mask, self.dtype,
                )
            else:
                k4, v4 = new_cache["k"], new_cache["v"]
                sc = jnp.einsum(
                    "bhqd,bhkd->bhqk", qh, k4, preferred_element_type=jnp.float32
                ) / np.sqrt(dh)
                sc = jnp.where(
                    _key_mask(Tk, kv_lens, mask), sc, jnp.finfo(jnp.float32).min
                )
                p = jax.nn.softmax(sc, axis=-1).astype(self.dtype)
                o = jnp.einsum(
                    "bhqk,bhkd->bhqd", p, v4, preferred_element_type=jnp.float32
                ).astype(self.dtype)
            out = o.transpose(0, 2, 1, 3).reshape(B, Tq, self.d_model)
        else:
            if kv_cache is not None and kv is not None:
                # cross-attention during decode: reuse precomputed encoder K/V
                k, v = kv_cache["k"], kv_cache["v"]
                new_cache = kv_cache
            else:
                k = proj("k_proj", kv_in, use_bias=False)
                v = proj("v_proj", kv_in)
                if kv_cache is not None:
                    # self-attention decode step: write k/v at cache_index
                    k = update_cache_rows(kv_cache["k"], k, cache_index, 1)
                    v = update_cache_rows(kv_cache["v"], v, cache_index, 1)
                    new_cache = {"k": k, "v": v}
            if qk_sink is not None:
                qk_sink.append((q, k))
            Tk = k.shape[1]
            if kv_lengths is not None and mask is not None and mask.shape[-2] == 1:
                # a one-row key mask beside threaded lengths says the same
                # thing (callers that build a mask from lengths thread both)
                mask = None
            out = dot_product_attention(
                q.reshape(B, Tq, H, dh),
                k.reshape(B, Tk, H, dh),
                v.reshape(B, Tk, H, dh),
                mask, kv_lengths=kv_lengths, causal=causal, window=window,
            ).reshape(B, Tq, self.d_model)
        out = proj("out_proj", out)
        out = dropout(s, out, self.dropout, deterministic)
        if new_cache is not None:
            return out, new_cache
        return out


@dataclass(frozen=True)
class MLP:
    d_model: int
    mlp_dim: int
    dtype: jnp.dtype = jnp.bfloat16
    dropout: float = 0.0
    adapter: Optional[AdapterConfig] = None
    # 'erf' = exact GELU (Whisper: HF-checkpoint logit parity pins it);
    # 'tanh' = tanh-form GELU (the flagship family's trained form)
    gelu_form: str = "erf"

    def __call__(
        self, s: Scope, x: jnp.ndarray, deterministic: bool = True
    ) -> jnp.ndarray:
        wf = self.adapter if (self.adapter and self.adapter.kind == "wf") else None
        h = wf_dense(s.child("fc1"), x, self.mlp_dim, wf, self.dtype)
        h = jax.nn.gelu(h, approximate=self.gelu_form == "tanh")
        h = dropout(s, h, self.dropout, deterministic)
        return wf_dense(s.child("fc2"), h, self.d_model, wf, self.dtype)


@dataclass(frozen=True)
class TransformerBlock:
    """Pre-LN block: LN, attention, residual, [LN, cross-attention,
    residual,] LN, MLP, residual — with adapter slots after the attention
    and MLP sublayers."""

    d_model: int
    num_heads: int
    mlp_dim: int
    dtype: jnp.dtype = jnp.bfloat16
    dropout: float = 0.0
    adapter: Optional[AdapterConfig] = None
    cross_attention: bool = False
    gelu_form: str = "erf"  # see MLP.gelu_form

    def _mha(self):
        return MultiHeadAttention(
            self.num_heads, self.d_model, self.dtype, self.dropout, self.adapter
        )

    def precompute_cross(self, s: Scope, enc: jnp.ndarray) -> dict:
        """K/V of the cross-attention for a given encoder output — used once
        per utterance to build the decode cache."""
        return self._mha()(s.child("cross_attn"), enc, kv=enc, return_kv=True)

    def __call__(
        self,
        s: Scope,
        x: jnp.ndarray,
        mask: Optional[jnp.ndarray] = None,
        enc: Optional[jnp.ndarray] = None,
        enc_mask: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
        self_cache: Optional[dict] = None,
        cross_cache: Optional[dict] = None,
        cache_index: Optional[jnp.ndarray] = None,
        slot_caches: Optional[dict] = None,
        kv_lengths: Optional[jnp.ndarray] = None,
        enc_kv_lengths: Optional[jnp.ndarray] = None,
        causal: bool = False,
        window: Optional[Tuple[int, int]] = None,
        cross_qk: Optional[list] = None,
    ):
        """Self-attention validity comes as a general `mask`, or as the
        structured `kv_lengths` / `causal` / `window`; cross-attention as
        `enc_mask` or `enc_kv_lengths`. Returns x, or (x, self_cache,
        cross_cache, slot_caches) on the KV-cached decode path."""
        ad = self.adapter or AdapterConfig()
        cached = self_cache is not None or cross_cache is not None
        h = layer_norm(s.child("self_attn_ln"), x, self.dtype)
        attn_out = self._mha()(
            s.child("self_attn"), h, mask=mask, deterministic=deterministic,
            kv_cache=self_cache, cache_index=cache_index,
            kv_lengths=kv_lengths, causal=causal, window=window,
        )
        if self_cache is not None:
            attn_out, self_cache = attn_out
        x = x + attn_out
        slot_mask = mask
        if ad.kind == "att" and slot_mask is None:
            # the attention adapter takes an explicit mask
            slot_mask = attention_mask(
                x.shape[1], x.shape[1], kv_lengths, causal, window
            )
        x, slot_caches = self._slot(
            s, "post_attn", ad, ad.after_attention, x, slot_mask, deterministic,
            slot_caches, cache_index,
        )
        if self.cross_attention:
            h = layer_norm(s.child("cross_attn_ln"), x, self.dtype)
            cross_out = self._mha()(
                s.child("cross_attn"), h, kv=enc, mask=enc_mask,
                deterministic=deterministic, kv_cache=cross_cache,
                kv_lengths=enc_kv_lengths, qk_sink=cross_qk,
            )
            if cross_cache is not None:
                cross_out, cross_cache = cross_out
            x = x + cross_out
        h = layer_norm(s.child("mlp_ln"), x, self.dtype)
        x = x + MLP(
            self.d_model, self.mlp_dim, self.dtype, self.dropout,
            self.adapter, gelu_form=self.gelu_form,
        )(s.child("mlp"), h, deterministic=deterministic)
        x, slot_caches = self._slot(
            s, "post_mlp", ad, ad.after_mlp, x, slot_mask, deterministic,
            slot_caches, cache_index,
        )
        if cached:
            return x, self_cache, cross_cache, slot_caches
        return x

    def _slot(self, s, where, ad, enabled, x, mask, deterministic, slot_caches,
              cache_index):
        if ad.kind not in ("bottleneck", "att") or not enabled:
            # "wf" adapters live inside the projections, not in a slot
            return x, slot_caches
        scope = s.child(f"{where}_slot")
        if slot_caches is None:
            return adapter_slot(scope, ad, x, self.dtype, mask, deterministic), None
        # KV-cached AttAdapter during incremental decode: the slot attends
        # over cached positions 0..pos, matching training
        x, c = adapter_slot(
            scope, ad, x, self.dtype, mask, deterministic,
            kv_cache=slot_caches[where], cache_index=cache_index,
        )
        return x, dict(slot_caches, **{where: c})


def length_mask(lengths: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """[B] lengths -> [B, 1, 1, max_len] attention mask (True = valid)."""
    valid = jnp.arange(max_len)[None, :] < lengths[:, None]
    return valid[:, None, None, :]


def banded_length_mask(
    lengths: jnp.ndarray,
    max_len: int,
    left: int,
    right: int,
) -> jnp.ndarray:
    """Length mask restricted to a (left, right) context band around each
    query: [B, 1, T, T], True where key j is valid AND q-left <= j <= q+right
    (-1 = unbounded on that side). The encoders pass the band to attention
    as (kv_lengths, window); this dense form is its reference."""
    return attention_mask(max_len, max_len, lengths, window=(left, right))
