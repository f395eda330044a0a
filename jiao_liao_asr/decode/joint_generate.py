"""Decoding for the joint CTC/attention model (SURVEY.md C8).

SpeechBrain's TransformerASR inference runs an attention (S2S) beam search,
optionally mixing in CTC scores (joint decoding). Form:

* greedy     — the shared `lax.while_loop` AR loop over the precomputed
               encoder output (decode/whisper_generate.greedy_from_enc) with
               sos/eos = the CTC blank id (models/joint.py convention).
* beam       — the shared device beam (beam_from_enc) + length penalty.
* joint beam — the device beam returns ALL K hypotheses; each is rescored
               with the CTC branch's exact sequence log-probability
               (ops/ctc_loss on the already-computed CTC log-probs — one
               batched forward pass, no re-encode), and the winner maximizes
               ctc_weight * logP_ctc + (1 - ctc_weight) * logP_att, both
               length-normalized. A statically-shaped approximation of
               SpeechBrain's per-step joint scorer: candidate pruning is
               attention-driven, final ranking is joint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .whisper_generate import beam_from_enc, greedy_from_enc


def joint_greedy(
    model,
    params,
    feats: jnp.ndarray,  # [B, mels, T]
    feat_lengths: Optional[jnp.ndarray] = None,
    max_len: int = 64,
    bos_eos_id: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Attention-branch greedy decode -> (tokens [B, max_len-1], lengths)."""
    enc, enc_lengths = model.apply(
        {"params": params}, feats, feat_lengths, method=model.encode
    )
    return greedy_from_enc(
        model, params, enc, enc_lengths, max_len=max_len,
        prompt=(bos_eos_id,), eot_id=bos_eos_id,
    )


def joint_beam(
    model,
    params,
    feats: jnp.ndarray,
    feat_lengths: Optional[jnp.ndarray] = None,
    beam_size: int = 4,
    max_len: int = 64,
    length_penalty: float = 1.0,
    ctc_weight: Optional[float] = None,
    bos_eos_id: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Attention beam with CTC joint rescoring.

    ctc_weight=None uses model.cfg.ctc_weight; 0.0 disables the CTC term
    (pure attention beam). Returns (tokens [B, L], lengths [B])."""
    if ctc_weight is None:
        ctc_weight = model.cfg.ctc_weight
    enc, enc_lengths = model.apply(
        {"params": params}, feats, feat_lengths, method=model.encode
    )
    gen, lengths, att_scores = beam_from_enc(
        model, params, enc, enc_lengths, beam_size=beam_size, max_len=max_len,
        prompt=(bos_eos_id,), eot_id=bos_eos_id,
    )
    B, K, L = gen.shape
    norm = jnp.maximum(lengths, 1).astype(jnp.float32) ** length_penalty
    att_norm = att_scores / norm
    if ctc_weight > 0.0:
        from ..ops.ctc_loss import ctc_loss

        ctc_lp = model.apply({"params": params}, enc, method=model.ctc_log_probs)
        Tq = ctc_lp.shape[1]
        # score all K hypotheses of all B utterances in one batched CTC pass
        lp_rep = jnp.repeat(ctc_lp, K, axis=0)  # [B*K, T, V]
        len_rep = jnp.repeat(enc_lengths, K, axis=0)
        labels = gen.reshape(B * K, L)
        lab_lens = lengths.reshape(B * K)
        nll = ctc_loss(
            lp_rep, len_rep, labels, lab_lens, blank_id=bos_eos_id
        )  # [B*K] total -logP_ctc(hyp)
        # empty hypotheses get -inf CTC support only if truly impossible;
        # guard the normalization, not the score
        ctc_norm = (-nll).reshape(B, K) / norm
        joint = ctc_weight * ctc_norm + (1.0 - ctc_weight) * att_norm
    else:
        joint = att_norm
    best = jnp.argmax(joint, axis=1)
    gen_best = jnp.take_along_axis(gen, best[:, None, None], axis=1)[:, 0]
    len_best = jnp.take_along_axis(lengths, best[:, None], axis=1)[:, 0]
    return gen_best, len_best
