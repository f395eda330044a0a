"""CTC decoding: on-device greedy collapse and prefix beam search.

Greedy (SURVEY 3.2 CTC path): argmax per frame -> collapse repeats -> drop
blanks. Runs fully on device with static shapes: the collapse is a
mask+sort compaction, so batched inference needs no host round-trip until
the final id->text lookup.

Prefix beam search: fixed-width device beam over (blank, non-blank) prefix
probabilities — a statically shaped answer to the inherently ragged host-side searcher
(SURVEY §7 hard-part 3). The host searcher supports external-LM shallow
fusion (decode/lm.py) — an extension beyond the reference's scope
(no kenlm/pyctcdecode in its lockfile).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def ctc_greedy_collapse(
    tokens: jnp.ndarray,  # [B, T] argmax ids
    lengths: jnp.ndarray,  # [B] valid frames
    blank_id: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Collapse repeats + remove blanks on device.

    Returns (ids [B, T] left-packed with blank_id padding, out_lengths [B]).
    """
    B, T = tokens.shape
    pos = jnp.arange(T)[None, :]
    valid = pos < lengths[:, None]
    prev = jnp.concatenate([jnp.full((B, 1), -1, tokens.dtype), tokens[:, :-1]], axis=1)
    keep = valid & (tokens != blank_id) & (tokens != prev)
    # left-pack kept tokens: target index = cumsum(keep) - 1
    idx = jnp.cumsum(keep, axis=1) - 1
    out_lengths = jnp.sum(keep, axis=1)
    out = jnp.full((B, T), blank_id, tokens.dtype)
    # scatter: out[b, idx[b,t]] = tokens[b,t] where keep
    bidx = jnp.arange(B)[:, None].repeat(T, axis=1)
    scatter_idx = jnp.where(keep, idx, T)  # dump dropped tokens past the end
    out = jnp.zeros((B, T + 1), tokens.dtype).at[bidx, scatter_idx].set(tokens)[:, :T]
    return out, out_lengths


def ctc_collapse_with_times(
    frame_ids: np.ndarray,  # [T] per-frame argmax ids (host)
    length: int,
    blank_id: int = 0,
) -> List[Tuple[int, int, int]]:
    """Host-side greedy collapse that keeps the frame alignment.

    Returns [(token_id, start_frame, end_frame_exclusive)] with the SAME
    emission rule as ctc_greedy_collapse (emit when id != blank and
    id != previous frame's id), where a token's span is its run of
    consecutive equal frames. Frame -> seconds is the encoder frame period
    (hop_length * subsample_factor / sample_rate, 40 ms at the flagship
    config). Beyond-reference surface: timestamps need the pre-collapse
    frames, so this runs where the ids land on host (transcribe_timed,
    streaming commits) rather than in the fused device collapse."""
    out: List[Tuple[int, int, int]] = []
    prev = -1
    for t in range(int(length)):
        tid = int(frame_ids[t])
        if tid != blank_id and tid != prev:
            out.append((tid, t, t + 1))
        elif tid != blank_id and out and out[-1][0] == tid:
            # continuing the emitted token's run: extend its span
            out[-1] = (tid, out[-1][1], t + 1)
        prev = tid
    return out


def ctc_greedy_decode(
    log_probs: jnp.ndarray,  # [B, T, V]
    lengths: jnp.ndarray,  # [B]
    blank_id: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy CTC decode -> (packed ids [B, T], lengths [B]), on device."""
    tokens = jnp.argmax(log_probs, axis=-1).astype(jnp.int32)
    return ctc_greedy_collapse(tokens, lengths, blank_id)


# ---------------------------------------------------------------------------
# Prefix beam search (device, fixed beam width)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("beam_size", "blank_id", "topk_tokens"))
def ctc_prefix_beam_search(
    log_probs: jnp.ndarray,  # [B, T, V]
    lengths: jnp.ndarray,  # [B]
    beam_size: int = 8,
    blank_id: int = 0,
    topk_tokens: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized CTC prefix beam search with static shapes.

    State per beam: packed prefix [T_out], last token, log p_blank / log
    p_nonblank. Each step expands beams with {blank, repeat-last, top-k new
    tokens}, merges identical prefixes approximately by (hash, last-token)
    signature, and reselects the top `beam_size`.

    Returns (ids [B, max_out], lengths [B]) of the best beam. With
    beam_size=1 this equals greedy decode.
    """
    B, T, V = log_probs.shape
    K = beam_size
    topk_tokens = min(topk_tokens, V)
    max_out = T

    NEG = -1e30
    # beams: prefixes [B, K, max_out], prefix_len [B, K], pb, pnb [B, K]
    prefixes0 = jnp.zeros((B, K, max_out), jnp.int32)
    plen0 = jnp.zeros((B, K), jnp.int32)
    pb0 = jnp.full((B, K), NEG).at[:, 0].set(0.0)  # only beam 0 alive
    pnb0 = jnp.full((B, K), NEG)
    # rolling hash for prefix-identity merging
    hash0 = jnp.zeros((B, K), jnp.uint32)
    HASH_MUL = jnp.uint32(1000003)

    def step(carry, t):
        prefixes, plen, pb, pnb, ph = carry
        lp = log_probs[:, t, :]  # [B, V]
        lp_blank = lp[:, blank_id]  # [B]
        # blank is never an *extension* token (it has its own same-prefix
        # candidate); mask it out of the top-k proposal set
        lp_ext = lp.at[:, blank_id].set(NEG)
        topv, topi = jax.lax.top_k(lp_ext, topk_tokens)  # [B, k]

        p_total = jnp.logaddexp(pb, pnb)  # [B, K]
        last = jnp.take_along_axis(
            prefixes, jnp.maximum(plen - 1, 0)[..., None], axis=2
        )[..., 0]  # [B, K]
        has_last = plen > 0

        # --- expansion 0: emit blank (prefix unchanged)
        new_pb_same = p_total + lp_blank[:, None]  # -> pb of same prefix
        # --- expansion 1: repeat last token (prefix unchanged, from pnb only)
        lp_last = jnp.take_along_axis(lp[:, None, :].repeat(K, 1), last[..., None], 2)[
            ..., 0
        ]
        new_pnb_same = jnp.where(has_last, pnb + lp_last, NEG)

        # --- expansions 2..: append token v (top-k)
        # from pb: always allowed; from pnb: only if v != last
        tokv = topi[:, None, :].repeat(K, 1)  # [B, K, k]
        tokp = topv[:, None, :].repeat(K, 1)
        same_as_last = (tokv == last[..., None]) & has_last[..., None]
        from_any = jnp.logaddexp(pb[..., None], jnp.where(same_as_last, NEG, pnb[..., None]))
        ext_pnb = from_any + tokp  # [B, K, k]

        # Assemble candidate set: K*(k+1) extended + K same-prefix
        # same-prefix candidates (keep prefix): score pair (new_pb_same, new_pnb_same)
        cand_pb = jnp.concatenate(
            [new_pb_same[..., None], jnp.full_like(ext_pnb, NEG)], axis=2
        )  # [B, K, k+1]
        cand_pnb = jnp.concatenate([new_pnb_same[..., None], ext_pnb], axis=2)
        # candidate prefix metadata
        cand_append = jnp.concatenate(
            [jnp.full((B, K, 1), -1, jnp.int32), tokv], axis=2
        )  # -1 = no append
        # candidate hash / length / last for merging
        app = cand_append
        new_hash = ph[..., None] * HASH_MUL + (app.astype(jnp.uint32) + 1)
        cand_hash = jnp.where(app >= 0, new_hash, ph[..., None])
        cand_len = jnp.where(app >= 0, plen[..., None] + 1, plen[..., None])

        # flatten [B, K*(k+1)]
        def fl(x):
            return x.reshape(B, -1)

        cpb, cpnb, chash, clen, capp = map(fl, (cand_pb, cand_pnb, cand_hash, cand_len, cand_append))
        src_beam = jnp.arange(K)[None, :, None].repeat(B, 0).repeat(topk_tokens + 1, 2).reshape(B, -1)

        # merge duplicates by hash: for each candidate, sum probs of equal
        # hashes; keep first occurrence, kill the rest
        eq = chash[:, :, None] == chash[:, None, :]  # [B, C, C]
        first_occ = jnp.argmax(eq, axis=2) == jnp.arange(eq.shape[1])[None, :]
        # merged totals live ONLY on the first occurrence; duplicates are
        # killed outright, else a wide beam re-admits them with full scores
        # and the next step double-counts the prefix
        ctot_pb = jnp.where(first_occ, _masked_logsumexp(cpb, eq), NEG)
        ctot_pnb = jnp.where(first_occ, _masked_logsumexp(cpnb, eq), NEG)
        score = jnp.logaddexp(ctot_pb, ctot_pnb)

        # respect sequence length: past the end, freeze beams (no update)
        active = t < lengths  # [B]

        top_score, top_idx = jax.lax.top_k(score, K)  # [B, K]
        g = lambda x: jnp.take_along_axis(x, top_idx, axis=1)
        n_pb, n_pnb, n_hash, n_len = g(ctot_pb), g(ctot_pnb), g(chash), g(clen)
        n_app = g(capp)
        n_src = g(src_beam)
        # gather source prefixes and append
        n_pref = jnp.take_along_axis(
            prefixes, n_src[..., None].repeat(max_out, 2), axis=1
        )
        write_pos = jnp.take_along_axis(plen, n_src, axis=1)
        onehot = jax.nn.one_hot(write_pos, max_out, dtype=jnp.bool_)
        do_app = (n_app >= 0)[..., None] & onehot
        n_pref = jnp.where(do_app, n_app[..., None], n_pref)

        # freeze if inactive
        keep = lambda new, old: jnp.where(active[:, None], new, old)
        prefixes = jnp.where(active[:, None, None], n_pref, prefixes)
        return (
            prefixes,
            keep(n_len, plen),
            keep(n_pb, pb),
            keep(n_pnb, pnb),
            jnp.where(active[:, None], n_hash, ph),
        ), None

    (prefixes, plen, pb, pnb, _), _ = jax.lax.scan(
        step, (prefixes0, plen0, pb0, pnb0, hash0), jnp.arange(T)
    )
    best = jnp.argmax(jnp.logaddexp(pb, pnb), axis=1)  # [B]
    ids = jnp.take_along_axis(prefixes, best[:, None, None].repeat(max_out, 2), 1)[:, 0]
    out_len = jnp.take_along_axis(plen, best[:, None], 1)[:, 0]
    return ids, out_len


def _masked_logsumexp(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """logsumexp over axis 2 of x[:, None, :] where mask [B, C, C]."""
    xm = jnp.where(mask, x[:, None, :], -1e30)
    m = jnp.max(xm, axis=2)
    return m + jnp.log(jnp.sum(jnp.exp(xm - m[..., None]), axis=2) + 1e-37)


# ---------------------------------------------------------------------------
# Prefix beam search (host, numpy) — exact semantics, zero compile cost
# ---------------------------------------------------------------------------


def ctc_prefix_beam_search_host(
    log_probs: np.ndarray,  # [B, T, V] (host)
    lengths: np.ndarray,  # [B]
    beam_size: int = 8,
    blank_id: int = 0,
    topk_tokens: int = 16,
    lm=None,
    lm_weight: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Classic dict-based prefix beam search on host.

    Same semantics as the device version (sum over alignments per collapsed
    prefix, exact duplicate merging) at zero XLA-compile cost — the default
    for offline CTC beam decoding; the device version exists for serving
    pipelines that cannot leave the chip (SURVEY §7 hard-part 3).

    lm + lm_weight > 0 enables kenlm-style shallow fusion (decode/lm.py):
    every prefix *extension* additionally pays lm_weight * logP_LM(v|prefix).
    The acoustic-only path is bit-identical to lm=None.
    """
    log_probs = np.asarray(log_probs)
    lengths = np.asarray(lengths)
    B, T, V = log_probs.shape
    k_tok = min(topk_tokens, V - 1)
    out_ids = np.zeros((B, T), np.int32)
    out_len = np.zeros((B,), np.int32)
    NEG = -1e30
    fuse = lm is not None and lm_weight > 0.0
    for b in range(B):
        beams = {(): (0.0, NEG)}  # prefix -> (log p_blank, log p_nonblank)
        for t in range(int(lengths[b])):
            lp = log_probs[b, t]
            lp_ext = lp.copy()
            lp_ext[blank_id] = NEG  # blank is never an extension token
            top = np.argpartition(-lp_ext, min(k_tok, V - 1))[:k_tok]
            nxt: dict = {}

            def acc(prefix, pb, pnb):
                opb, opnb = nxt.get(prefix, (NEG, NEG))
                nxt[prefix] = (np.logaddexp(opb, pb), np.logaddexp(opnb, pnb))

            for prefix, (pb, pnb) in beams.items():
                p_tot = np.logaddexp(pb, pnb)
                acc(prefix, p_tot + lp[blank_id], NEG)  # emit blank
                if prefix:
                    acc(prefix, NEG, pnb + lp[prefix[-1]])  # repeat last
                for v in top:
                    v = int(v)
                    if v == blank_id:
                        continue
                    if prefix and v == prefix[-1]:
                        src = pb  # after a blank only
                    else:
                        src = p_tot
                    bonus = lm_weight * lm.logp(prefix, v) if fuse else 0.0
                    acc(prefix + (v,), NEG, src + lp[v] + bonus)
            beams = dict(
                sorted(
                    nxt.items(),
                    key=lambda kv: -np.logaddexp(kv[1][0], kv[1][1]),
                )[:beam_size]
            )
        best = max(beams.items(), key=lambda kv: np.logaddexp(kv[1][0], kv[1][1]))[0]
        out_ids[b, : len(best)] = best
        out_len[b] = len(best)
    return out_ids, out_len


# ---------------------------------------------------------------------------
# Prefix beam search (native C++, device-pruned) — the production beam path
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "blank_id"))
def ctc_topk_posteriors(
    log_probs: jnp.ndarray,  # [B, T, V]
    k: int,
    blank_id: int = 0,
):
    """Device-side pruning for the native beam: per frame, the top-k
    EXTENSION log-probs/ids (blank masked out) plus the blank log-prob.
    Only [B,T,k]+[B,T] leaves the chip instead of the full [B,T,V] rows.

    k << V uses lax.approx_max_k — the aggregate reduction
    (O(V) per frame) — instead of exact top_k, which lowers to a full
    variadic sort of the vocab axis (minutes of runtime at the flagship's
    [128, 750, 4336]). The top list is a PRUNING set, not a ranking: the
    beam engine scores candidates itself, so a ~recall-0.99 proposal set is
    semantically the same prune as exact top-k. k >= V-1 (the exactness
    regime the parity tests run) stays exact top_k.
    """
    lp_ext = log_probs.at[:, :, blank_id].set(-1e30)
    V = log_probs.shape[-1]
    if k >= V - 1:
        # exactness regime (parity tests): full-precision exact top-k
        top_vals, top_ids = jax.lax.top_k(lp_ext, k)
        return top_vals, top_ids.astype(jnp.int32), log_probs[:, :, blank_id]
    top_vals, top_ids = jax.lax.approx_max_k(
        lp_ext, k, recall_target=0.99, aggregate_to_topk=True
    )
    # Compact transfer dtypes: the device->host link can bound the beam
    # pipeline. f16 keeps ~3 decimal digits on log-probs in
    # [-30, 0] — noise relative to the pruning already applied — and int16
    # ids cover any vocab < 32768; the host widens both before the C engine.
    if V < 32768:
        top_ids = top_ids.astype(jnp.int16)
    else:
        top_ids = top_ids.astype(jnp.int32)
    return (
        top_vals.astype(jnp.float16),
        top_ids,
        log_probs[:, :, blank_id].astype(jnp.float16),
    )


def ctc_prefix_beam_search_native(
    log_probs,  # [B, T, V] device or host
    lengths,  # [B]
    beam_size: int = 8,
    blank_id: int = 0,
    topk_tokens: int = 64,
    n_threads: int = 0,
    prune_logp: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """CTC prefix beam search via the C++ engine (native/beam.cpp),
    multithreaded across utterances over device-pruned top-k posteriors.

    Same merge semantics as ctc_prefix_beam_search_host; exact when
    topk_tokens >= V-1 and prune_logp >= 0 (the parity test runs that
    config). prune_logp < 0 drops per-frame candidates more than
    |prune_logp| nats below the frame's best mass (pruned prefix beam) —
    on peaked trained posteriors most frames collapse to an O(beams)
    blank-only update. The repeat-last
    expansion reads lp[last] from the frame's pruned list (absent -> -inf),
    which coincides with the host searcher whenever the beam's last token is
    inside the frame's top-k — always true for tokens the pruned proposal
    set admitted that frame.
    """
    from ..utils.native_ext import load_beam

    V = log_probs.shape[-1]
    k = min(topk_tokens, V - 1)
    top_vals, top_ids, blank_lp = ctc_topk_posteriors(
        jnp.asarray(log_probs), k, blank_id
    )
    return load_beam().search(
        np.asarray(top_vals),
        np.asarray(top_ids),
        np.asarray(blank_lp),
        np.asarray(lengths),
        beam_size,
        n_threads,
        prune_logp,
    )


def ids_to_texts(ids: np.ndarray, lengths: np.ndarray, tokenizer) -> List[str]:
    """Host-side final lookup: packed id rows -> strings."""
    out = []
    for row, n in zip(np.asarray(ids), np.asarray(lengths)):
        out.append(tokenizer.decode([int(t) for t in row[: int(n)]]))
    return out
