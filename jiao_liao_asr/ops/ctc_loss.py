"""CTC loss as a log-semiring forward recursion under `lax.scan`.

Replacement for the reference's cuDNN CTC
(speechbrain.nnet.losses.ctc_loss -> torch.nn.functional.ctc_loss,
SURVEY.md C8/N1). Design notes (SURVEY §7 hard-part 2):

* forward-only alpha recursion in float32 log space; gradients via XLA
  autodiff through the scan (exact, and the backward scan XLA derives is
  the standard beta recursion up to fusion)
* static shapes: labels padded to S_max, frames padded to T_max; true
  lengths carried as int32 vectors, padding handled by carry-through masking
  so padded steps are exact no-ops
* the whole batch advances in lock-step — [B, 2S+1] state matrix per step,
  a pure VPU workload that XLA vectorizes cleanly

Semantics match torch.nn.functional.ctc_loss(reduction='none',
zero_infinity=False) / optax.ctc_loss: per-example negative log likelihood.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEG_INF = -1e30  # avoids nan from (-inf) - (-inf) in masked logaddexp


def _logaddexp(a, b):
    mx = jnp.maximum(a, b)
    mx = jnp.maximum(mx, NEG_INF)  # both -inf -> stay at floor
    return mx + jnp.log1p(jnp.exp(jnp.minimum(a, b) - mx))


def ctc_loss(
    log_probs: jnp.ndarray,  # [B, T, V] log-softmax outputs (float32)
    logit_lengths: jnp.ndarray,  # [B] valid frames
    labels: jnp.ndarray,  # [B, S] int labels (no blanks; padding arbitrary)
    label_lengths: jnp.ndarray,  # [B] valid label counts
    blank_id: int = 0,
    unroll: int = 1,
) -> jnp.ndarray:
    """Per-example CTC negative log likelihood, shape [B].

    `unroll`: lax.scan unroll factor (the transposed backward scan
    inherits it). The loop body is a tiny [B, 2S+1] elementwise op and
    unrolling only grows the program, so 1 is the default. Whether the GPU
    wants another factor is not measured yet.
    train step — and the unroll sweep was flat because the GATHER, not
    the scan, dominated; see the emission-matmul comment below.)"""
    B, T, V = log_probs.shape
    S = labels.shape[1]
    U = 2 * S + 1

    labels = labels.astype(jnp.int32)
    # extended label sequence: blank, l1, blank, l2, ..., blank
    ext = jnp.full((B, U), blank_id, dtype=jnp.int32)
    ext = ext.at[:, 1::2].set(labels)

    # skip transition u-2 -> u allowed iff ext[u] != blank and ext[u] != ext[u-2]
    same_as_prev = jnp.concatenate(
        [jnp.ones((B, 1), bool), labels[:, 1:] == labels[:, :-1]], axis=1
    )  # [B, S]: label s equals label s-1 (s=0 -> disallow, no u-2 label)
    allow_skip = jnp.zeros((B, U), bool).at[:, 1::2].set(~same_as_prev)

    # state validity: u < 2*label_len + 1
    u_idx = jnp.arange(U)[None, :]
    valid_state = u_idx < (2 * label_lengths[:, None] + 1)

    # per-step emissions gathered once: [T, B, U], as a one-hot MATMUL
    # rather than take_along_axis (whose scatter-add transpose serializes
    # in the backward). The one-hot contraction is 1.7 GFLOP at flagship
    # train shapes and its transpose is another matmul; HIGHEST precision
    # keeps it bit-exact (one side is exactly 0/1). Which form is faster
    # on the GPU is an open measurement (ROADMAP.md). Guarded by a memory
    # budget for very wide vocabs (the one-hot is [B, V, U]).
    if B * V * U <= (1 << 28):
        onehot = (
            ext[:, None, :] == jnp.arange(V, dtype=jnp.int32)[None, :, None]
        ).astype(log_probs.dtype)  # [B, V, U]
        emit = jax.lax.dot_general(
            log_probs, onehot, (((2,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST,
        ).transpose(1, 0, 2)
    else:
        emit = jnp.take_along_axis(
            log_probs, ext[:, None, :].repeat(T, axis=1), axis=2
        ).transpose(1, 0, 2)

    alpha0 = jnp.full((B, U), NEG_INF, dtype=jnp.float32)
    alpha0 = alpha0.at[:, 0].set(emit[0, :, 0])
    has_label = label_lengths > 0
    alpha0 = alpha0.at[:, 1].set(jnp.where(has_label, emit[0, :, 1], NEG_INF))

    def step(alpha, inputs):
        emit_t, t = inputs
        stay = alpha
        prev1 = jnp.concatenate([jnp.full((B, 1), NEG_INF), alpha[:, :-1]], axis=1)
        prev2 = jnp.concatenate([jnp.full((B, 2), NEG_INF), alpha[:, :-2]], axis=1)
        prev2 = jnp.where(allow_skip, prev2, NEG_INF)
        new = _logaddexp(_logaddexp(stay, prev1), prev2) + emit_t
        new = jnp.where(valid_state, new, NEG_INF)
        # carry-through on padded frames: exact no-op past logit_length
        active = (t < logit_lengths)[:, None]
        new = jnp.where(active, new, alpha)
        return new, None

    ts = jnp.arange(1, T)
    alpha, _ = jax.lax.scan(
        step, alpha0, (emit[1:], ts), unroll=max(int(unroll), 1)
    )

    end_u = 2 * label_lengths  # final blank state
    a_last = jnp.take_along_axis(alpha, end_u[:, None], axis=1)[:, 0]
    a_prev = jnp.take_along_axis(
        alpha, jnp.maximum(end_u - 1, 0)[:, None], axis=1
    )[:, 0]
    a_prev = jnp.where(label_lengths > 0, a_prev, NEG_INF)
    ll = _logaddexp(a_last, a_prev)
    return -ll


def ctc_loss_mean(
    log_probs, logit_lengths, labels, label_lengths, blank_id: int = 0
) -> jnp.ndarray:
    """Batch-mean CTC loss normalized by label lengths (the usual
    torch `ctc_loss(reduction='mean')` semantics used in SB recipes)."""
    nll = ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank_id)
    denom = jnp.maximum(label_lengths, 1).astype(jnp.float32)
    return jnp.mean(nll / denom)
