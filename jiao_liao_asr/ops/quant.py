"""Weight-only int8 quantization for memory-bound autoregressive decode.

Whisper AR decode streams the ENTIRE decoder weight tree from device memory
every token. Halving the weight bytes halves that term, so a
per-output-channel symmetric int8 representation of the decoder Dense
kernels can buy tokens/s at small batch with no retraining.

Per-output-channel scales commute out of the contraction
(x @ (wq * s[None, :]) == (x @ wq) * s), so the matmul runs on the int8
weights converted to bf16 and applies the scale once at the end. Whether
XLA fuses that convert into the GEMM's operand read, or materializes a bf16
copy of the weights per step, is for the compiled HLO on the card to say.

Replaces (beyond-parity) the reference's fp16-only inference stack
(/root/reference/requirements.txt:75 — torch 2.1 cu118, no quantization
pins). Serving entry point: ModelBundle.quantize() (models/bundle.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

def quantize_int8(w: jnp.ndarray):
    """Per-output-channel symmetric int8: w [d_in, d_out] float ->
    (q int8 [d_in, d_out], scale f32 [d_out]) with w ~= q * scale[None, :].
    Channels that are exactly zero keep scale 0 (dequantize to 0)."""
    w = jnp.asarray(w, jnp.float32)
    amax = jnp.max(jnp.abs(w), axis=0)
    scale = amax / 127.0
    safe = jnp.where(scale > 0, scale, 1.0)
    q = jnp.clip(jnp.round(w / safe[None, :]), -127, 127).astype(jnp.int8)
    return q, scale


def quantize_kv(a: jnp.ndarray):
    """Per-position int8 for KV caches: a [..., T, dh] -> (q int8 same
    shape, scale f32 [..., T]) with a ~= q * scale[..., None]. Both
    attention contractions commute with a per-KEY-POSITION scale:
    logits[t] = (q_vec . K[t]) * sk[t] and out = (probs * sv) @ V, so the
    decode step reads int8 rows and folds the scales in elementwise
    (models/layers._int8_cache_attention)."""
    a = jnp.asarray(a)
    amax = jnp.max(jnp.abs(a.astype(jnp.float32)), axis=-1)
    scale = amax / 127.0
    safe = jnp.where(scale > 0, scale, 1.0)
    q = jnp.clip(
        jnp.round(a.astype(jnp.float32) / safe[..., None]), -127, 127
    ).astype(jnp.int8)
    return q, scale


def int8_tied_logits(x: jnp.ndarray, q_vd: jnp.ndarray, scale_v: jnp.ndarray):
    """Logits against a ROW-major int8 embedding table.

    x [R, D], q_vd int8 [V, D] (the tied embedding layout, quantized per
    vocab row), scale_v f32 [V]. Returns f32 [R, V] == x @ dequant(q_vd).T.
    Dequantizes to bf16 (no bigger than the bf16 table the quantization
    replaces); accumulation stays f32. Mirrors whisper's tied embedding
    head (HF modeling_whisper proj_out shares embed_tokens)."""
    w = (q_vd.astype(jnp.float32) * scale_v[:, None].astype(jnp.float32)).astype(
        jnp.bfloat16
    )
    return jax.lax.dot_general(
        x.astype(jnp.bfloat16), w, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def int8_matmul(x: jnp.ndarray, q: jnp.ndarray, scale: jnp.ndarray):
    """y = x @ dequant(q, scale). x [..., d_in] bf16/f32; q int8
    [d_in, d_out]; scale f32 [d_out]. Returns x.dtype."""
    y = jax.lax.dot_general(
        x.astype(jnp.bfloat16), q.astype(jnp.bfloat16),
        (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return (y * scale).astype(x.dtype)
