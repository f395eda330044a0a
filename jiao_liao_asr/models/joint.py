"""Joint CTC/attention transformer ASR model (SURVEY.md C8).

The reference's SpeechBrain pin ships the TransformerASR recipe family:
a conv-subsampled transformer encoder trained with BOTH a CTC head and an
attention (transformer) decoder under the hybrid loss
``ctc_weight * CTC + (1 - ctc_weight) * CE`` (speechbrain's classic
joint CTC/attention training, /root/reference/requirements.txt:71). This is
the counterpart here: the encoder trunk matches CTCEncoderModel (same
blocks, bf16 compute), the decoder mirrors the
Whisper-style causal/cross-attention stack with KV-cached
``lax.while_loop`` decoding, and both heads share one encoder pass.

Token conventions: the CharTokenizer CTC blank (id 0) doubles as the
attention decoder's sos/eos — blank never appears inside label sequences,
so <0> ... tokens ... <0> is unambiguous and the two heads share one vocab.

Decoding (decode/joint_generate.py): attention greedy / beam with optional
CTC joint rescoring of finished hypotheses (ctc_weight * CTC prefix score +
attention log-prob), mirroring SpeechBrain's joint decoding semantics in a
statically-shaped, single-program form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.config import JointModelConfig
from .ctc_model import (
    CTCHead, conv_subsample, encoder_block, run_encoder_blocks, subsampled_lengths,
)
from .layers import sinusoidal_positions
from .module import Module, Scope, layer_norm
from .whisper import TiedEmbedding, build_decode_caches, cached_decode_blocks


@dataclass(frozen=True)
class JointCTCAttentionModel(Module):
    """Hybrid CTC + attention model over one shared encoder.

    __call__ returns (ctc_log_probs [B,T',V], enc_lengths [B],
    dec_logits [B,S,V]) for the joint loss; `encode`/`init_cache`/
    `decode_step` expose the KV-cached AR decode interface used by
    decode/joint_generate.py.
    """

    cfg: JointModelConfig

    @property
    def _dtype(self):
        return jnp.dtype(self.cfg.dtype)

    def _embed(self) -> TiedEmbedding:
        return TiedEmbedding(self.cfg.vocab_size, self.cfg.d_model, self._dtype)

    def _dec_blocks(self, s: Scope):
        # decoder blocks stay un-rematted: target sequences are short
        blk = encoder_block(self.cfg, self._dtype, cross_attention=True)
        return [
            (f"dec_block_{i}", s.child(f"dec_block_{i}"), blk)
            for i in range(self.cfg.decoder_layers)
        ]

    # ---------------------------------------------------------------- encode
    def encode(
        self,
        s: Scope,
        features: jnp.ndarray,  # [B, num_mels, T] log-mel
        feature_lengths: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        cfg = self.cfg
        dtype = self._dtype
        B, M, T = features.shape
        if T > cfg.max_frames:
            raise ValueError(
                f"input has {T} frames > max_frames={cfg.max_frames}; raise "
                "JointModelConfig.max_frames or chunk the audio"
            )
        if feature_lengths is None:
            feature_lengths = jnp.full((B,), T, dtype=jnp.int32)
        x = features.transpose(0, 2, 1).astype(dtype)
        x = conv_subsample(
            s.child("subsample"), x, cfg.d_model, cfg.conv_channels, dtype,
            cfg.subsample_factor,
        )
        t_out = x.shape[1]
        out_lengths = subsampled_lengths(feature_lengths, cfg.subsample_factor)
        if cfg.position_mode == "sinusoidal":
            x = x + sinusoidal_positions(t_out, cfg.d_model, dtype)[None]
        elif cfg.position_mode != "none":
            raise ValueError(f"unknown position_mode {cfg.position_mode!r}")
        x = run_encoder_blocks(
            s, cfg, x, out_lengths, deterministic, prefix="enc_block_"
        )
        return layer_norm(s.child("enc_ln"), x, dtype), out_lengths

    # ------------------------------------------------------------- CTC branch
    def ctc_log_probs(self, s: Scope, enc: jnp.ndarray) -> jnp.ndarray:
        head = CTCHead(self.cfg.vocab_size, self._dtype)
        return jax.nn.log_softmax(head(s.child("ctc_head"), enc), axis=-1)

    def ctc_argmax_ids(self, s: Scope, enc: jnp.ndarray) -> jnp.ndarray:
        head = CTCHead(self.cfg.vocab_size, self._dtype)
        return head.argmax_ids(s.child("ctc_head"), enc)

    # -------------------------------------------------------- attention branch
    def decode_teacher(
        self,
        s: Scope,
        tokens: jnp.ndarray,  # [B, S]
        enc: jnp.ndarray,
        enc_lengths: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ) -> jnp.ndarray:
        cfg = self.cfg
        dtype = self._dtype
        B, S = tokens.shape
        if S > cfg.max_target_positions:
            raise ValueError(
                f"{S} target positions > max_target_positions="
                f"{cfg.max_target_positions}"
            )
        x = self._embed()(s.child("embed_tokens"), tokens)
        x = x + sinusoidal_positions(S, cfg.d_model, dtype)[None]
        for _, bs, blk in self._dec_blocks(s):
            x = blk(bs, x, enc=enc, deterministic=deterministic, causal=True,
                    enc_kv_lengths=enc_lengths)
        x = layer_norm(s.child("dec_ln"), x, dtype)
        # tied output projection (shared input/output embedding)
        return self._embed().attend(s.child("embed_tokens"), x.astype(jnp.float32))

    # ------------------------------------------------------------- joint call
    def __call__(
        self,
        s: Scope,
        features: jnp.ndarray,
        feature_lengths: Optional[jnp.ndarray] = None,
        tokens: Optional[jnp.ndarray] = None,
        deterministic: bool = True,
    ):
        enc, out_lengths = self.encode(s, features, feature_lengths, deterministic)
        ctc_lp = self.ctc_log_probs(s, enc)
        dec_logits = None
        if tokens is not None:
            dec_logits = self.decode_teacher(
                s, tokens, enc, out_lengths, deterministic
            )
        return ctc_lp, out_lengths, dec_logits

    # ------------------------------------------------------- KV-cached decode
    def init_cache(
        self, s: Scope, batch: int, enc: jnp.ndarray, max_len: Optional[int] = None
    ) -> Dict:
        """Zeroed self caches sized to the decode horizon + cross K/V
        precomputed once per utterance (models/whisper.build_decode_caches)."""
        cfg = self.cfg
        t_cache = cfg.max_target_positions
        if max_len is not None:
            t_cache = min(max_len, t_cache)
        return build_decode_caches(
            self._dec_blocks(s), batch, enc, t_cache, cfg.num_heads, cfg.d_model,
            self._dtype, cfg.adapter,
        )

    def decode_step(
        self,
        s: Scope,
        token: jnp.ndarray,  # [B, 1]
        pos: jnp.ndarray,  # scalar int32
        enc: jnp.ndarray,
        caches: Dict,
        enc_lengths: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, Dict]:
        cfg = self.cfg
        dtype = self._dtype
        pos = jnp.asarray(pos, jnp.int32)
        x = self._embed()(s.child("embed_tokens"), token)
        pos_table = sinusoidal_positions(cfg.max_target_positions, cfg.d_model, dtype)
        x = x + jax.lax.dynamic_slice(pos_table, (pos, 0), (1, cfg.d_model))[None]
        x, new_caches = cached_decode_blocks(
            self._dec_blocks(s), x, pos, enc, caches, enc_lengths
        )
        x = layer_norm(s.child("dec_ln"), x, dtype)
        logits = self._embed().attend(s.child("embed_tokens"), x.astype(jnp.float32))
        return logits[:, 0], new_caches
