"""Conv-subsampled transformer encoder with CTC head — the flagship model.

Counterpart of the reference's SpeechBrain-style transformer-CTC acoustic
model (SURVEY.md C8; BASELINE configs[0-1]): two stride-2 1-D convs
subsample the 100 Hz log-mel frames 4x (3000 -> 750 positions at 30 s), then
a pre-LN transformer encoder and a linear CTC head over the character vocab.
Adapters (WFAdapter / AttAdapter / bottleneck) inject per AdapterConfig.

Design: bf16 compute, f32 params and logits; optional jax.checkpoint on
blocks for long-schedule fine-tunes; all shapes static (padded/bucketed
inputs, lengths carried separately).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.config import CTCModelConfig
from .layers import TransformerBlock, sinusoidal_positions
from .module import Module, Scope, conv1d, dropout, layer_norm, lecun_normal, remat_call, zeros


def conv_subsample(
    s: Scope, x: jnp.ndarray, d_model: int, channels: int, dtype, factor: int = 4
) -> jnp.ndarray:
    """log2(factor) stride-2 Conv1d + GELU: [B, T, mels] -> [B, T//factor,
    d_model]. factor=4 (the SB-recipe default) gives the conv1/conv2 stack;
    other powers of two scale the stack."""
    n = max(factor, 2).bit_length() - 1
    if (1 << n) != factor:
        raise ValueError(f"subsample_factor must be a power of 2, got {factor}")
    for i in range(n):
        feats = d_model if i == n - 1 else channels
        x = conv1d(s.child(f"conv{i + 1}"), x, feats, 3, 2, (1, 1), dtype)
        x = jax.nn.gelu(x, approximate=False)
    return x


def subsampled_lengths(lengths: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Ceil-division length propagation through the stride-2 convs (pad=1)."""
    while factor > 1:
        lengths = (lengths + 1) // 2
        factor //= 2
    return lengths


def attention_window(cfg) -> Optional[Tuple[int, int]]:
    """(left, right) encoder attention band, or None for full context."""
    L, R = cfg.attention_left_context, cfg.attention_right_context
    return (L, R) if (L >= 0 or R >= 0) else None


def encoder_block(cfg, dtype, cross_attention: bool = False) -> TransformerBlock:
    return TransformerBlock(
        cfg.d_model, cfg.num_heads, cfg.mlp_dim, dtype, cfg.dropout,
        cfg.adapter if cfg.adapter.kind != "none" else None,
        cross_attention=cross_attention, gelu_form=cfg.gelu_form,
    )


def run_encoder_blocks(
    s: Scope, cfg, x, lengths, deterministic: bool, prefix: str = "block_"
) -> jnp.ndarray:
    """The encoder's transformer stack: key padding as lengths and an
    optional band as a window, so attention builds its own mask."""
    block = encoder_block(cfg, jnp.dtype(cfg.dtype))
    window = attention_window(cfg)

    def run(bs, h, lens):
        return block(bs, h, deterministic=deterministic, kv_lengths=lens,
                     window=window)

    for i in range(cfg.num_layers):
        bs = s.child(f"{prefix}{i}")
        if cfg.remat:
            # rematerialize each block on the backward pass (long fine-tune
            # schedules on big batches; SURVEY §1.b runtime notes)
            x = remat_call(bs, run, x, lengths)
        else:
            x = run(bs, x, lengths)
    return x


@dataclass(frozen=True)
class CTCHead:
    """Dense head: compute-dtype operands, f32-accumulated logits. Params
    {"kernel" [d, V], "bias" [V]}."""

    features: int
    dtype: jnp.dtype = jnp.bfloat16

    def __call__(self, s: Scope, x: jnp.ndarray) -> jnp.ndarray:
        kernel = s.param("kernel", lecun_normal(), (x.shape[-1], self.features))
        bias = s.param("bias", zeros, (self.features,))
        y = jax.lax.dot_general(
            x.astype(self.dtype),
            kernel.astype(self.dtype),
            (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return y + bias

    def argmax_ids(self, s: Scope, x: jnp.ndarray) -> jnp.ndarray:
        """Greedy decode: argmax of the logits (log_softmax is monotonic)."""
        return jnp.argmax(self(s, x), axis=-1).astype(jnp.int32)


@dataclass(frozen=True)
class CTCEncoderModel(Module):
    """Returns (log_probs [B, T', V] float32, output lengths [B])."""

    cfg: CTCModelConfig

    def __call__(
        self,
        s: Scope,
        features: jnp.ndarray,  # [B, num_mels, T] log-mel
        feature_lengths: Optional[jnp.ndarray] = None,  # [B] valid frames
        deterministic: bool = True,
        head_mode: str = "log_probs",  # "log_probs" | "argmax_ids" (static)
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        cfg = self.cfg
        dtype = jnp.dtype(cfg.dtype)
        B, M, T = features.shape
        if T > cfg.max_frames:
            raise ValueError(
                f"input has {T} frames > max_frames={cfg.max_frames}; raise "
                "CTCModelConfig.max_frames or chunk the audio"
            )
        if feature_lengths is None:
            feature_lengths = jnp.full((B,), T, dtype=jnp.int32)

        x = features.transpose(0, 2, 1).astype(dtype)  # [B, T, M]
        with jax.named_scope("conv_subsample"):
            x = conv_subsample(
                s.child("subsample"), x, cfg.d_model, cfg.conv_channels, dtype,
                cfg.subsample_factor,
            )
        t_out = x.shape[1]
        out_lengths = subsampled_lengths(feature_lengths, cfg.subsample_factor)

        if cfg.position_mode == "sinusoidal":
            x = x + sinusoidal_positions(t_out, cfg.d_model, dtype)[None, :, :]
        elif cfg.position_mode != "none":
            # "none": shift-invariant encoder (the conv subsampler carries
            # local order) — required for sliding-window streaming to match
            # training (serve/streaming.py)
            raise ValueError(f"unknown position_mode {cfg.position_mode!r}")
        x = dropout(s, x, cfg.dropout, deterministic)
        x = run_encoder_blocks(s, cfg, x, out_lengths, deterministic)
        x = layer_norm(s.child("final_ln"), x, dtype)
        head = CTCHead(cfg.vocab_size, dtype)
        with jax.named_scope("ctc_head"):
            if head_mode == "argmax_ids":
                return head.argmax_ids(s.child("ctc_head"), x), out_lengths
            if head_mode != "log_probs":
                raise ValueError(f"unknown head_mode {head_mode!r}")
            logits = head(s.child("ctc_head"), x)
            # log-softmax in f32 (CTC loss numerics, SURVEY §7 hard-part 2)
            return jax.nn.log_softmax(logits, axis=-1), out_lengths
