"""Whisper encoder-decoder backbone (SURVEY.md C7).

Structure matches the reference's transformers WhisperForConditionalGeneration
(verified in SURVEY: encoder = Conv1d(k3,p1) + Conv1d(k3,s2,p1) subsample ->
3000->1500 positions, fixed sinusoidal encoder positions, pre-LN blocks;
decoder = learned positions, causal self-attn + cross-attn blocks; logits
tied to the token embedding). Weight import from HF safetensors lives in
whisper_import.py; adapters inject exactly as in the CTC backbone.

Decode: bf16 compute, KV caches updated with dynamic_update_slice inside a
lax.while_loop (no per-step host sync — SURVEY §7 hard-part 5); the cache
layout is batch-conditional (init_cache): packed [B, T_max, d_model] at
small batch, head-major [B, H, T_max, dh] at batch >=
layers.HEAD_MAJOR_MIN_BATCH.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.config import WhisperConfig
from .layers import TransformerBlock, length_mask, sinusoidal_positions
from .module import (
    Module, Scope, conv1d, layer_norm, normal, remat_call, variance_scaling,
)


@dataclass(frozen=True)
class TiedEmbedding:
    """Whisper's tied token embedding + output head (the reference's HF
    WhisperForConditionalGeneration shares proj_out with embed_tokens).

    Params {embedding [V, D] f32}; lookups cast rows to `dtype`, `attend`
    takes logits against the same table in `dtype`. int8 serving mode: when
    ModelBundle.quantize() has replaced the subtree with {embedding_q int8
    [V, D], scale f32 [V]} (per-vocab-row symmetric), lookups gather int8
    rows and dequantize per token, and attend runs
    ops/quant.int8_tied_logits over the row-major table."""

    num_embeddings: int
    features: int
    dtype: Any = jnp.bfloat16

    def __call__(self, s: Scope, tokens: jnp.ndarray) -> jnp.ndarray:
        if s.has("embedding_q"):
            p = s.params
            rows = jnp.take(p["embedding_q"], tokens, axis=0).astype(jnp.float32)
            sc = jnp.take(p["scale"], tokens, axis=0).astype(jnp.float32)
            return (rows * sc[..., None]).astype(self.dtype)
        emb = s.param(
            "embedding",
            variance_scaling(1.0, "fan_in", "normal", out_axis=0),
            (self.num_embeddings, self.features),
        )
        return jnp.take(emb, tokens, axis=0).astype(self.dtype)

    def attend(self, s: Scope, x: jnp.ndarray) -> jnp.ndarray:
        """Logits against the (tied) table; x [..., D]."""
        if s.has("embedding_q"):
            from ..ops.quant import int8_tied_logits

            lead = x.shape[:-1]
            out = int8_tied_logits(
                x.reshape(-1, x.shape[-1]), s.params["embedding_q"], s.params["scale"]
            )
            return out.reshape(*lead, self.num_embeddings)
        emb = s.params["embedding"]
        return jnp.dot(x.astype(self.dtype), emb.T.astype(self.dtype))


def _tree_quantized(node) -> bool:
    if not isinstance(node, dict):
        return False
    return "dense_q" in node or any(_tree_quantized(v) for v in node.values())


def build_decode_caches(
    blocks,
    batch: int,
    enc: jnp.ndarray,
    t_cache: int,
    num_heads: int,
    d_model: int,
    dtype,
    adapter,
    layout: Optional[str] = None,
    int8: bool = False,
) -> Dict:
    """Per-layer decode caches for a decoder stack. `blocks` is a list of
    (name, block scope, TransformerBlock).

    Each entry holds zeroed self caches sized to the decode horizon
    `t_cache` and the cross-attention K/V precomputed ONCE from the encoder
    output (skipping the per-step [B, T_enc, d] projections is worth ~2
    matmuls x layers per generated token).

    Layout: head-major [B, H, T, dh] at batch >= HEAD_MAJOR_MIN_BATCH (or
    layout="head_major"), packed [B, T, d] below (or layout="packed": the
    serving engine admits utterances one at a time into a batch-`slots`
    cache, so its batch=1 caches take the layout of the slot count).

    int8 (a quantized serving tree): cross caches are stored int8 with
    per-position scales, head-major at every batch; at head-major batch the
    self caches are int8 too, their rows quantized as decode writes them."""
    from . import layers as _layers  # late lookup: patchable in tests

    H = num_heads
    dh = d_model // H
    if layout is None:
        head_major = batch >= _layers.HEAD_MAJOR_MIN_BATCH
    elif layout in ("packed", "head_major"):
        head_major = layout == "head_major"
    else:
        raise ValueError(f"unknown cache layout {layout!r}")
    caches = {}
    for name, bs, blk in blocks:
        cross = blk.precompute_cross(bs, enc)
        if head_major or int8:
            t_enc = cross["k"].shape[1]
            cross = {
                n: a.reshape(batch, t_enc, H, dh).transpose(0, 2, 1, 3)
                for n, a in cross.items()
            }
        if int8:
            from ..ops.quant import quantize_kv

            kq, ks = quantize_kv(cross["k"])
            vq, vs = quantize_kv(cross["v"])
            cross = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
        self_shape = (
            (batch, H, t_cache, dh) if head_major else (batch, t_cache, d_model)
        )
        if int8 and head_major:
            # zero scales: unwritten rows dequantize to 0, like the bf16 init
            self_cache = {
                "k": jnp.zeros(self_shape, jnp.int8),
                "k_scale": jnp.zeros(self_shape[:-1], jnp.float32),
                "v": jnp.zeros(self_shape, jnp.int8),
                "v_scale": jnp.zeros(self_shape[:-1], jnp.float32),
            }
        else:
            self_cache = {
                "k": jnp.zeros(self_shape, dtype),
                "v": jnp.zeros(self_shape, dtype),
            }
        entry = {"self": self_cache, "cross": cross}
        if adapter.kind == "att":
            # AttAdapter slots carry their own KV caches so decode attends
            # over the same prefix the trained function saw
            ad_dim = adapter.att_num_heads * adapter.att_key_dim
            entry["slots"] = {
                sl: {
                    "k": jnp.zeros((batch, t_cache, ad_dim), dtype),
                    "v": jnp.zeros((batch, t_cache, ad_dim), dtype),
                }
                for sl in ("post_attn", "post_mlp")
            }
        caches[name] = entry
    return caches


def cached_decode_blocks(
    blocks, x, pos, enc, caches, enc_lengths
) -> Tuple[jnp.ndarray, Dict]:
    """Run a decoder stack for one KV-cached step. `pos` is a scalar (every
    row decodes in lockstep) or a [B] vector (continuous-batching serving:
    each slot at its own position)."""
    t_cache = caches[blocks[0][0]]["self"]["k"].shape[-2]
    if pos.ndim == 0:
        kmask = jnp.arange(t_cache)[None, None, None, :] <= pos
    else:
        kmask = jnp.arange(t_cache)[None, None, None, :] <= pos[:, None, None, None]
    enc_mask = (
        length_mask(enc_lengths, enc.shape[1]) if enc_lengths is not None else None
    )
    new_caches = {}
    for name, bs, blk in blocks:
        x, self_c, cross_c, slot_c = blk(
            bs, x, mask=kmask, enc=enc, enc_mask=enc_mask, deterministic=True,
            self_cache=caches[name]["self"],
            cross_cache=caches[name].get("cross"),
            cache_index=pos,
            slot_caches=caches[name].get("slots"),
            # keys 0..pos are valid (kmask is kept for the adapter slots)
            kv_lengths=pos + 1,
            enc_kv_lengths=enc_lengths,
        )
        new_caches[name] = {"self": self_c, "cross": cross_c}
        if slot_c is not None:
            new_caches[name]["slots"] = slot_c
    return x, new_caches


@dataclass(frozen=True)
class WhisperEncoder:
    cfg: WhisperConfig

    def __call__(
        self,
        s: Scope,
        mel: jnp.ndarray,  # [B, num_mels, T]
        deterministic: bool = True,
    ) -> jnp.ndarray:
        cfg = self.cfg
        dtype = jnp.dtype(cfg.dtype)
        x = mel.transpose(0, 2, 1).astype(dtype)  # [B, T, M]
        with jax.named_scope("conv_subsample"):
            x = conv1d(s.child("conv1"), x, cfg.d_model, 3, 1, (1, 1), dtype)
            x = jax.nn.gelu(x, approximate=False)
            x = conv1d(s.child("conv2"), x, cfg.d_model, 3, 2, (1, 1), dtype)
            x = jax.nn.gelu(x, approximate=False)
        t = x.shape[1]
        if t > cfg.max_source_positions:
            raise ValueError(
                f"{t} encoder positions > max_source_positions="
                f"{cfg.max_source_positions} (Whisper's fixed receptive "
                "field, SURVEY §5.7); chunk the audio to 30 s"
            )
        x = x + sinusoidal_positions(t, cfg.d_model, dtype)[None]
        block = TransformerBlock(
            cfg.d_model, cfg.num_heads, cfg.mlp_dim, dtype, cfg.dropout,
            cfg.adapter if cfg.adapter.kind != "none" else None,
        )

        def run(bs, h):
            return block(bs, h, deterministic=deterministic)

        for i in range(cfg.encoder_layers):
            bs = s.child(f"block_{i}")
            # remat: recompute each encoder block on the backward pass; the
            # 30 s window's per-block activations dominate fine-tune memory
            x = remat_call(bs, run, x) if cfg.remat else run(bs, x)
        return layer_norm(s.child("ln_post"), x, dtype)


@dataclass(frozen=True)
class WhisperDecoder:
    cfg: WhisperConfig

    @property
    def _dtype(self):
        return jnp.dtype(self.cfg.dtype)

    def _embed(self) -> TiedEmbedding:
        return TiedEmbedding(self.cfg.vocab_size, self.cfg.d_model, self._dtype)

    def _positions(self, s: Scope) -> jnp.ndarray:
        return s.param(
            "embed_positions", normal(0.02),
            (self.cfg.max_target_positions, self.cfg.d_model),
        )

    def _blocks(self, s: Scope):
        cfg = self.cfg
        blk = TransformerBlock(
            cfg.d_model, cfg.num_heads, cfg.mlp_dim, self._dtype, cfg.dropout,
            cfg.adapter if cfg.adapter.kind != "none" else None,
            cross_attention=True,
        )
        return [
            (f"block_{i}", s.child(f"block_{i}"), blk)
            for i in range(cfg.decoder_layers)
        ]

    def __call__(
        self,
        s: Scope,
        tokens: jnp.ndarray,  # [B, S]
        enc: jnp.ndarray,  # [B, T, d]
        enc_lengths: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
        cross_qk: Optional[Dict[int, list]] = None,
    ) -> jnp.ndarray:
        """Teacher-forced logits [B, S, V]. cross_qk: {layer: []} lists that
        receive that layer's cross-attention (q, k) (decode/align.py)."""
        dtype = self._dtype
        B, S = tokens.shape
        x = self._embed()(s.child("embed_tokens"), tokens)
        x = x + self._positions(s)[:S].astype(dtype)[None]
        for i, (_, bs, blk) in enumerate(self._blocks(s)):
            x = blk(bs, x, enc=enc, deterministic=deterministic, causal=True,
                    enc_kv_lengths=enc_lengths,
                    cross_qk=None if cross_qk is None else cross_qk.get(i))
        x = layer_norm(s.child("ln"), x, dtype)
        # tied output projection (Whisper convention)
        return self._embed().attend(s.child("embed_tokens"), x.astype(jnp.float32))

    def init_cache(
        self,
        s: Scope,
        batch: int,
        enc: jnp.ndarray,
        max_len: Optional[int] = None,
        layout: Optional[str] = None,
    ) -> Dict:
        """Decode caches (build_decode_caches). T_cache = min(max_len,
        max_target_positions): the self caches are re-read end to end every
        decode step, so they are sized to the decode horizon rather than the
        448-position ceiling (decode_step derives its key mask from the
        cache shape)."""
        cfg = self.cfg
        t_cache = cfg.max_target_positions
        if max_len is not None:
            t_cache = min(max_len, t_cache)
        return build_decode_caches(
            self._blocks(s), batch, enc, t_cache, cfg.num_heads, cfg.d_model,
            self._dtype, cfg.adapter, layout, int8=_tree_quantized(s.params),
        )

    def decode_step(
        self,
        s: Scope,
        token: jnp.ndarray,  # [B, 1]
        pos: jnp.ndarray,  # int32 position: scalar, or [B] per-slot vector
        enc: jnp.ndarray,
        caches: Dict,
        enc_lengths: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, Dict]:
        """One KV-cached decode step; every position-dependent op (pos-embed
        lookup, key mask, cache row writes) is per-row when `pos` is [B]."""
        cfg = self.cfg
        dtype = self._dtype
        pos = jnp.asarray(pos, jnp.int32)
        x = self._embed()(s.child("embed_tokens"), token)
        table = self._positions(s)
        if pos.ndim == 0:
            x = x + jax.lax.dynamic_slice(table, (pos, 0), (1, cfg.d_model)).astype(
                dtype
            )[None]
        else:
            x = x + jnp.take(table, pos, axis=0).astype(dtype)[:, None, :]
        x, new_caches = cached_decode_blocks(
            self._blocks(s), x, pos, enc, caches, enc_lengths
        )
        x = layer_norm(s.child("ln"), x, dtype)
        logits = self._embed().attend(s.child("embed_tokens"), x.astype(jnp.float32))
        return logits[:, 0], new_caches


@dataclass(frozen=True)
class WhisperModel(Module):
    """Teacher-forced forward: (mel, tokens) -> logits [B, S, V]."""

    cfg: WhisperConfig

    def __call__(
        self,
        s: Scope,
        mel: jnp.ndarray,
        tokens: jnp.ndarray,
        enc_lengths: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> jnp.ndarray:
        enc = self.encode(s, mel, deterministic=deterministic)
        return self.decode(s, tokens, enc, enc_lengths, deterministic=deterministic)

    def encode(self, s: Scope, mel: jnp.ndarray, deterministic: bool = True) -> jnp.ndarray:
        with jax.named_scope("encoder"):
            return WhisperEncoder(self.cfg)(s.child("encoder"), mel, deterministic)

    def decode(self, s: Scope, tokens, enc, enc_lengths=None,
               deterministic: bool = True, cross_qk=None):
        with jax.named_scope("decoder"):
            return WhisperDecoder(self.cfg)(
                s.child("decoder"), tokens, enc, enc_lengths, deterministic,
                cross_qk=cross_qk,
            )

    def decode_step(self, s: Scope, token, pos, enc, caches, enc_lengths=None):
        with jax.named_scope("decode_step"):
            return WhisperDecoder(self.cfg).decode_step(
                s.child("decoder"), token, pos, enc, caches, enc_lengths
            )

    def init_cache(
        self,
        s: Scope,
        batch: int,
        enc: jnp.ndarray,
        max_len: Optional[int] = None,
        layout: Optional[str] = None,
    ) -> Dict:
        return WhisperDecoder(self.cfg).init_cache(
            s.child("decoder"), batch, enc, max_len, layout
        )
