"""CTC-draft speculative greedy decoding for the joint CTC/attention model.

An acceleration of the attention branch's AR greedy decode
(beyond-reference extension; the reference's SpeechBrain pin decodes the
TransformerASR family token-by-token, /root/reference/requirements.txt:71).

The idea: the joint model (models/joint.py) already computes, from ONE
encoder pass, a non-autoregressive transcript — the CTC branch's greedy
collapse. Because both heads share the encoder and the vocab (the CTC blank
doubles as sos/eos), that transcript is a high-acceptance DRAFT for the
attention decoder. Verification is a single teacher-forced decoder forward
over the whole draft (`decode_teacher`) — L positions in parallel through
one set of GEMMs — instead of L sequential `decode_step` dispatches.

Why this is the right shape for serving: at serving batch sizes the AR
decode loop is memory-bound — every step re-reads the full decoder weights to
produce ONE token per row. A teacher-forced pass reads the weights ONCE for
all L positions, so each verification pass costs roughly one AR step of memory
traffic while confirming (and extending by at least) one token per row —
and typically confirming most of the draft at once.

Algorithm (iterated parallel verification; statically shaped):

  tokens[0] = sos; tokens[1:] = CTC-collapsed draft, eos-padded
  repeat (lax.while_loop, <= max_len-1 passes):
    pred  = argmax(decode_teacher(tokens))         # pred[i] follows tokens[:i+1]
    m     = first position >= n_acc with tokens[m+1] != pred[m]
    tokens[m+1] <- pred[m]                         # the true greedy token
    n_acc <- m + 1                                 # positions 1..n_acc verified
  until every row has a verified eos or n_acc reaches max_len-1

Exactness: position i's teacher-forced logits depend only on tokens[:i+1]
(causal mask: masked positions contribute exp(-inf)*v = 0 bitwise regardless
of later-token edits), so verified prefixes never need re-checking, every
pass advances each unfinished row by >= 1 token, and the final sequence is
exactly the greedy decode *under the decode_teacher scoring path*. The
KV-cached `decode_step` path computes the same math over cache-shaped
operands; tests assert text-level agreement with `joint_greedy`.

Worst case (useless draft, e.g. an untrained CTC head): max_len-1 passes,
each a full-length forward — correct but slower than the AR loop. The
acceptance rate of a *trained* joint model makes the trade: CTC and
attention greedy agree on most tokens, so a handful of passes replace
hundreds of steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .ctc import ctc_greedy_collapse


def joint_spec_greedy(
    model,
    params,
    feats: jnp.ndarray,  # [B, mels, T]
    feat_lengths: Optional[jnp.ndarray] = None,
    max_len: int = 64,
    bos_eos_id: int = 0,
    return_passes: bool = False,
):
    """CTC-draft speculative greedy decode -> (tokens [B, max_len-1],
    lengths [B][, verification passes]). Output conventions match
    decode/joint_generate.joint_greedy."""
    enc, enc_lengths = model.apply(
        {"params": params}, feats, feat_lengths, method=model.encode
    )
    frame_ids = model.apply({"params": params}, enc, method=model.ctc_argmax_ids)
    draft, draft_lens = ctc_greedy_collapse(frame_ids, enc_lengths, bos_eos_id)
    return spec_greedy_from_enc(
        model, params, enc, enc_lengths, draft, draft_lens,
        max_len=max_len, bos_eos_id=bos_eos_id, return_passes=return_passes,
    )


def spec_greedy_from_enc(
    model,
    params,
    enc: jnp.ndarray,  # [B, T, d] encoder output
    enc_lengths: Optional[jnp.ndarray],
    draft: jnp.ndarray,  # [B, Ld] draft token ids (no eos inside)
    draft_lens: jnp.ndarray,  # [B]
    *,
    max_len: int = 64,
    bos_eos_id: int = 0,
    return_passes: bool = False,
):
    """Verify an arbitrary draft against the attention decoder's greedy
    path. Exposed separately so tests can inject known drafts and so other
    drafters (an n-gram LM, a smaller model) can reuse the verifier."""
    B = enc.shape[0]
    L = int(max_len)
    G = L - 1  # generated positions; gen = tokens[:, 1:]
    eos = jnp.int32(bos_eos_id)

    tokens0 = jnp.full((B, L), eos, jnp.int32)  # position 0 = sos (same id)
    k = min(draft.shape[1], G)
    if k > 0:
        dmask = jnp.arange(k)[None, :] < jnp.minimum(draft_lens, k)[:, None]
        tokens0 = tokens0.at[:, 1 : 1 + k].set(
            jnp.where(dmask, draft[:, :k].astype(jnp.int32), eos)
        )
    pos = jnp.arange(G)[None, :]

    def body(carry):
        tokens, n_acc, done, passes = carry
        logits = model.apply(
            {"params": params}, tokens, enc, enc_lengths,
            method=model.decode_teacher,
        )  # [B, L, V]
        pred = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        guess = tokens[:, 1:]  # [B, G]
        prop = pred[:, :G]  # prop[:, g] is the greedy token after tokens[:, :g+1]
        mism = (guess != prop) & (pos >= n_acc[:, None])
        has_m = jnp.any(mism, axis=1)
        m = jnp.where(has_m, jnp.argmax(mism, axis=1), G)  # [B]
        new_gen = jnp.where(pos == m[:, None], prop, guess)
        new_gen = jnp.where(done[:, None], guess, new_gen)
        new_n = jnp.where(done, n_acc, jnp.minimum(m + 1, G))
        ver_eos = jnp.any((new_gen == eos) & (pos < new_n[:, None]), axis=1)
        new_done = done | ver_eos | (new_n >= G)
        tokens = jnp.concatenate([tokens[:, :1], new_gen], axis=1)
        return tokens, new_n, new_done, passes + 1

    def cond(carry):
        _, _, done, passes = carry
        return (~jnp.all(done)) & (passes < G)

    tokens, _, _, passes = jax.lax.while_loop(
        cond,
        body,
        (
            tokens0,
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool),
            jnp.int32(0),
        ),
    )
    gen = tokens[:, 1:]
    is_eot = gen == eos
    first = jnp.argmax(is_eot, axis=1)
    lengths = jnp.where(jnp.any(is_eot, axis=1), first, G)
    # stale draft tokens can sit past a verified eos; blank them so the
    # padded array (not just the length-sliced text) is canonical
    gen = jnp.where(pos >= lengths[:, None], eos, gen)
    if return_passes:
        return gen, lengths, passes
    return gen, lengths
