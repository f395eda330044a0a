"""CTC loss correctness (SURVEY.md §4.2): vs a numpy DP oracle, vs torch's
cuDNN-semantics ctc_loss (CPU), gradient vs numerical differentiation, and
padding invariance."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.ops.ctc_loss import ctc_loss


def numpy_ctc_oracle(log_probs, labels, blank=0):
    """Plain forward-algorithm reference, single example."""
    T, V = log_probs.shape
    ext = [blank]
    for l in labels:
        ext += [l, blank]
    U = len(ext)
    alpha = np.full((T, U), -np.inf)
    alpha[0, 0] = log_probs[0, blank]
    if U > 1:
        alpha[0, 1] = log_probs[0, ext[1]]
    for t in range(1, T):
        for u in range(U):
            cands = [alpha[t - 1, u]]
            if u >= 1:
                cands.append(alpha[t - 1, u - 1])
            if u >= 2 and ext[u] != blank and ext[u] != ext[u - 2]:
                cands.append(alpha[t - 1, u - 2])
            m = max(cands)
            alpha[t, u] = (
                m + np.log(sum(np.exp(c - m) for c in cands)) + log_probs[t, ext[u]]
                if m > -np.inf
                else -np.inf
            )
    ends = [alpha[T - 1, U - 1]]
    if U > 1:
        ends.append(alpha[T - 1, U - 2])
    m = max(ends)
    return -(m + np.log(sum(np.exp(e - m) for e in ends)))


def _rand_case(rng, T, S, V):
    logits = rng.randn(T, V).astype(np.float32)
    log_probs = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    labels = rng.randint(1, V, S).astype(np.int32)
    return np.asarray(log_probs), labels


def test_vs_numpy_oracle(rng):
    V = 6
    for T, S in [(10, 3), (20, 8), (5, 2), (7, 7 // 2)]:
        lp, labels = _rand_case(rng, T, S, V)
        want = numpy_ctc_oracle(lp, labels)
        got = ctc_loss(
            jnp.asarray(lp)[None],
            jnp.asarray([T]),
            jnp.asarray(labels)[None],
            jnp.asarray([S]),
        )[0]
        assert np.abs(float(got) - want) < 5e-4, (T, S)


def test_repeated_labels(rng):
    lp, _ = _rand_case(rng, 12, 4, 5)
    labels = np.array([2, 2, 3, 3], np.int32)
    want = numpy_ctc_oracle(lp, labels)
    got = ctc_loss(
        jnp.asarray(lp)[None], jnp.asarray([12]), jnp.asarray(labels)[None], jnp.asarray([4])
    )[0]
    assert np.abs(float(got) - want) < 5e-4


def test_vs_torch(rng):
    torch = pytest.importorskip("torch")
    B, T, V, S = 4, 25, 8, 6
    logits = rng.randn(B, T, V).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    tlens = np.array([25, 20, 15, 9], np.int64)
    llens = np.array([6, 4, 1, 3], np.int64)
    ref = torch.nn.functional.ctc_loss(
        torch.tensor(lp).permute(1, 0, 2),
        torch.tensor(labels.astype(np.int64)),
        torch.tensor(tlens),
        torch.tensor(llens),
        blank=0,
        reduction="none",
    ).numpy()
    got = np.asarray(
        ctc_loss(jnp.asarray(lp), jnp.asarray(tlens), jnp.asarray(labels), jnp.asarray(llens))
    )
    assert np.abs(got - ref).max() < 1e-3


def test_padding_invariance(rng):
    """Extra padded frames and label slots must not change the loss."""
    lp, labels = _rand_case(rng, 10, 3, 6)
    base = ctc_loss(
        jnp.asarray(lp)[None], jnp.asarray([10]), jnp.asarray(labels)[None], jnp.asarray([3])
    )[0]
    lp_pad = np.concatenate([lp, rng.randn(5, 6).astype(np.float32)], axis=0)
    labels_pad = np.concatenate([labels, rng.randint(1, 6, 4).astype(np.int32)])
    padded = ctc_loss(
        jnp.asarray(lp_pad)[None],
        jnp.asarray([10]),
        jnp.asarray(labels_pad)[None],
        jnp.asarray([3]),
    )[0]
    assert np.abs(float(base) - float(padded)) < 1e-5


def test_gradient_matches_numerical(rng):
    T, V, S = 6, 5, 2
    logits = rng.randn(T, V).astype(np.float32)
    labels = jnp.asarray(rng.randint(1, V, S).astype(np.int32))[None]

    def loss_fn(lg):
        lp = jax.nn.log_softmax(lg, axis=-1)
        return ctc_loss(lp[None], jnp.asarray([T]), labels, jnp.asarray([S]))[0]

    g = jax.grad(loss_fn)(jnp.asarray(logits))
    eps = 1e-3
    for _ in range(10):
        i, j = rng.randint(T), rng.randint(V)
        e = np.zeros_like(logits)
        e[i, j] = eps
        num = (loss_fn(jnp.asarray(logits + e)) - loss_fn(jnp.asarray(logits - e))) / (
            2 * eps
        )
        assert np.abs(float(g[i, j]) - float(num)) < 2e-2


def test_vs_optax(rng):
    import optax

    B, T, V, S = 3, 15, 7, 4
    logits = rng.randn(B, T, V).astype(np.float32)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    tlens = np.array([15, 12, 8])
    llens = np.array([4, 2, 3])
    got = ctc_loss(lp, jnp.asarray(tlens), jnp.asarray(labels), jnp.asarray(llens))
    # optax.ctc_loss uses paddings (1.0 = pad)
    logit_pad = (np.arange(T)[None] >= tlens[:, None]).astype(np.float32)
    label_pad = (np.arange(S)[None] >= llens[:, None]).astype(np.float32)
    ref = optax.ctc_loss(
        jnp.asarray(logits), jnp.asarray(logit_pad), jnp.asarray(labels), jnp.asarray(label_pad)
    )
    # optax floors path log-probs at its internal log_epsilon, which skews
    # its values by ~1e-2 on short sequences; torch + the numpy oracle are
    # the authoritative comparisons (exact above), so this is a sanity band.
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() < 5e-2
