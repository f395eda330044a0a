"""Whisper autoregressive generation with KV cache under lax.while_loop.

Counterpart of WhisperGenerationMixin.generate (SURVEY.md 3.2):
the reference syncs host<->device once per token for stopping criteria; here
the whole decode loop compiles into one XLA program — greedy first, beam as
a batched extension. Stops on EOT or max length, entirely on device.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils.config import DecodeConfig

# Whisper multilingual special tokens (vocab 51865; SURVEY C6/C7)
SOT = 50258
EOT = 50257
TRANSCRIBE = 50359
NO_TIMESTAMPS = 50363
LANG_ZH = 50260


def default_prompt(vocab_size: int = 51865) -> Tuple[int, ...]:
    """<|startoftranscript|><|zh|><|transcribe|><|notimestamps|> — the
    standard Mandarin transcription prompt."""
    shift = 1 if vocab_size == 51866 else 0  # large-v3 adds a language token
    return (SOT + shift, LANG_ZH + shift, TRANSCRIBE + shift, NO_TIMESTAMPS + shift)


def _suppression_masks(vocab_size: int, suppress_ids, begin_suppress_ids):
    """(always-mask, begin-mask) additive [V] logit masks, or None when
    empty — HF-generate-parity token suppression."""
    always = begin = None
    if suppress_ids:
        always = jnp.zeros((vocab_size,), jnp.float32).at[
            jnp.asarray(suppress_ids, jnp.int32)
        ].set(-1e30)
    if begin_suppress_ids:
        begin = jnp.zeros((vocab_size,), jnp.float32).at[
            jnp.asarray(begin_suppress_ids, jnp.int32)
        ].set(-1e30)
    return always, begin


def _apply_suppression(logits, pos, prompt_len, always, begin):
    """Add the suppression masks to [.., V] logits at decode position `pos`
    (the token being predicted lands at pos+1; the first generated position
    is prompt_len)."""
    if always is not None:
        logits = logits + always
    if begin is not None:
        is_first = (pos + 1 == prompt_len).astype(jnp.float32)
        logits = logits + is_first * begin
    return logits


def greedy_generate(
    model,
    params,
    mel: jnp.ndarray,  # [B, mels, T]
    max_len: int = 224,
    prompt: Optional[Tuple[int, ...]] = None,
    eot_id: int = EOT,
    temperature: float = 0.0,
    rng: Optional[jax.Array] = None,
    suppress_ids: Tuple[int, ...] = (),
    begin_suppress_ids: Tuple[int, ...] = (),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy AR decode -> (tokens [B, max_len], lengths [B]). `lengths`
    counts generated tokens excluding the prompt and the EOT.

    temperature > 0 samples each token from softmax(logits/T) (the
    reference's temperature decoding knob); 0 is pure argmax.
    suppress_ids / begin_suppress_ids mirror transformers' generate()
    defaults (every step / first generated step)."""
    prompt = prompt or default_prompt(model.cfg.vocab_size)
    enc = model.apply({"params": params}, mel, method=model.encode)
    return greedy_from_enc(
        model, params, enc, None, max_len=max_len, prompt=prompt,
        eot_id=eot_id, temperature=temperature, rng=rng,
        suppress_ids=suppress_ids, begin_suppress_ids=begin_suppress_ids,
    )


def greedy_from_enc(
    model,
    params,
    enc: jnp.ndarray,  # [B, T, d] encoder output
    enc_lengths: Optional[jnp.ndarray] = None,  # [B] valid encoder frames
    max_len: int = 224,
    prompt: Tuple[int, ...] = (),
    eot_id: int = EOT,
    temperature: float = 0.0,
    rng: Optional[jax.Array] = None,
    suppress_ids: Tuple[int, ...] = (),
    begin_suppress_ids: Tuple[int, ...] = (),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy AR decode loop over a precomputed encoder output — the shared
    core behind Whisper greedy_generate and the joint CTC/attention model's
    attention decode (decode/joint_generate.py). `enc_lengths` masks padded
    encoder frames in cross-attention (bucketed joint batches; Whisper's
    fixed 30 s windows pass None)."""
    B = enc.shape[0]
    P = len(prompt)
    if temperature > 0 and rng is None:
        rng = jax.random.PRNGKey(0)
    sup_always, sup_begin = _suppression_masks(
        model.cfg.vocab_size, suppress_ids, begin_suppress_ids
    )

    caches = model.apply(
        {"params": params}, B, enc, max_len, method=model.init_cache
    )

    tokens0 = jnp.full((B, max_len), eot_id, jnp.int32)
    tokens0 = tokens0.at[:, :P].set(jnp.asarray(prompt, jnp.int32)[None])

    def step_fn(carry):
        tokens, caches, pos, done = carry
        tok = jax.lax.dynamic_slice(tokens, (0, pos), (B, 1))
        logits, caches = model.apply(
            {"params": params}, tok, pos, enc, caches, enc_lengths,
            method=model.decode_step,
        )
        logits = _apply_suppression(logits, pos, P, sup_always, sup_begin)
        if temperature > 0:
            key = jax.random.fold_in(rng, pos)
            nxt = jax.random.categorical(
                key, logits.astype(jnp.float32) / temperature, axis=-1
            ).astype(jnp.int32)
        else:
            nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [B]
        is_prompt = pos + 1 < P  # keep forced prompt tokens
        cur_next = jax.lax.dynamic_slice(tokens, (0, pos + 1), (B, 1))[:, 0]
        nxt = jnp.where(done, eot_id, jnp.where(is_prompt, cur_next, nxt))
        tokens = jax.lax.dynamic_update_slice(tokens, nxt[:, None], (0, pos + 1))
        done = done | (~is_prompt & (nxt == eot_id))
        return tokens, caches, pos + 1, done

    def cond_fn(carry):
        _, _, pos, done = carry
        return (pos < max_len - 1) & ~jnp.all(done)

    done0 = jnp.zeros((B,), bool)
    tokens, _, _, _ = jax.lax.while_loop(
        cond_fn, step_fn, (tokens0, caches, jnp.int32(0), done0)
    )
    # lengths: generated tokens before first EOT after the prompt
    gen = tokens[:, P:]
    is_eot = gen == eot_id
    first_eot = jnp.argmax(is_eot, axis=1)
    lengths = jnp.where(jnp.any(is_eot, axis=1), first_eot, gen.shape[1])
    return gen, lengths


def beam_generate(
    model,
    params,
    mel: jnp.ndarray,  # [B, mels, T]
    beam_size: int = 4,
    max_len: int = 224,
    length_penalty: float = 1.0,
    prompt: Optional[Tuple[int, ...]] = None,
    eot_id: int = EOT,
    lm_bigram: Optional[jnp.ndarray] = None,  # [V, V] log P(next|prev)
    lm_weight: float = 0.0,
    suppress_ids: Tuple[int, ...] = (),
    begin_suppress_ids: Tuple[int, ...] = (),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched AR beam search with KV caches, fully on device.

    Beams fold into the batch axis (B*K); each step scores K*V candidate
    continuations per utterance, keeps the top K, and gathers the KV caches
    along the winning beams. Finished beams propose only EOT at logprob 0 so
    their score freezes. Returns the best beam per utterance:
    (tokens [B, max_len] past prompt, lengths [B]).

    lm_bigram + lm_weight > 0 adds on-device shallow fusion: one row-gather
    of the dense bigram log-prob matrix per step (decode/lm.py), added to
    the model log-probs before top-k.
    """
    prompt = prompt or default_prompt(model.cfg.vocab_size)
    enc = model.apply({"params": params}, mel, method=model.encode)
    gen, lengths, scores = beam_from_enc(
        model, params, enc, None, beam_size=beam_size, max_len=max_len,
        prompt=prompt, eot_id=eot_id, lm_bigram=lm_bigram,
        lm_weight=lm_weight, suppress_ids=suppress_ids,
        begin_suppress_ids=begin_suppress_ids,
    )
    norm = jnp.maximum(lengths, 1).astype(jnp.float32) ** length_penalty
    best = jnp.argmax(scores / norm, axis=1)  # [B]
    gen_best = jnp.take_along_axis(gen, best[:, None, None], axis=1)[:, 0]
    len_best = jnp.take_along_axis(lengths, best[:, None], axis=1)[:, 0]
    return gen_best, len_best


def beam_from_enc(
    model,
    params,
    enc: jnp.ndarray,  # [B, T, d] encoder output
    enc_lengths: Optional[jnp.ndarray] = None,
    beam_size: int = 4,
    max_len: int = 224,
    prompt: Tuple[int, ...] = (),
    eot_id: int = EOT,
    lm_bigram: Optional[jnp.ndarray] = None,
    lm_weight: float = 0.0,
    suppress_ids: Tuple[int, ...] = (),
    begin_suppress_ids: Tuple[int, ...] = (),
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Beam-search loop over a precomputed encoder output. Returns ALL beams
    per utterance — (tokens [B, K, L] past prompt, lengths [B, K],
    scores [B, K]) — so callers choose the ranking rule: Whisper's
    beam_generate applies a length penalty, joint_generate rescores with the
    CTC branch before selecting (SpeechBrain-style joint decoding)."""
    B = enc.shape[0]
    K = beam_size
    P = len(prompt)
    V = model.cfg.vocab_size
    NEG = -1e30

    sup_always, sup_begin = _suppression_masks(
        model.cfg.vocab_size, suppress_ids, begin_suppress_ids
    )
    enc = jnp.repeat(enc, K, axis=0)  # [B*K, T, d]
    enc_lengths = (
        jnp.repeat(enc_lengths, K, axis=0) if enc_lengths is not None else None
    )
    caches = model.apply(
        {"params": params}, B * K, enc, max_len, method=model.init_cache
    )

    tokens0 = jnp.full((B, K, max_len), eot_id, jnp.int32)
    tokens0 = tokens0.at[:, :, :P].set(jnp.asarray(prompt, jnp.int32)[None, None])
    scores0 = jnp.full((B, K), NEG).at[:, 0].set(0.0)  # only beam 0 alive
    finished0 = jnp.zeros((B, K), bool)

    def gather_beams(tree, idx):
        """Gather along the beam axis of [B*K, ...] leaves. idx [B, K]."""

        def g(x):
            xk = x.reshape(B, K, *x.shape[1:])
            ind = idx.reshape(B, K, *([1] * (x.ndim - 1)))
            return jnp.take_along_axis(xk, ind, axis=1).reshape(x.shape)

        return jax.tree_util.tree_map(g, tree)

    def step_fn(carry):
        tokens, scores, finished, caches, pos = carry
        tok = jax.lax.dynamic_slice(tokens, (0, 0, pos), (B, K, 1)).reshape(B * K, 1)
        logits, new_caches = model.apply(
            {"params": params}, tok, pos, enc, caches, enc_lengths,
            method=model.decode_step,
        )
        logits = _apply_suppression(logits, pos, P, sup_always, sup_begin)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1).reshape(B, K, V)
        if lm_bigram is not None and lm_weight > 0.0:
            # shallow fusion: + w * log P_LM(next | current token)
            logp = logp + lm_weight * lm_bigram[tok[:, 0]].reshape(B, K, V)
        # finished beams: only EOT continuation at logprob 0
        eot_only = jnp.full((V,), NEG).at[eot_id].set(0.0)
        logp = jnp.where(finished[..., None], eot_only[None, None, :], logp)

        in_prompt = pos + 1 < P
        cand = scores[..., None] + logp  # [B, K, V]

        def prompt_select(_):
            # forced decoding: every beam continues with the prompt token
            nxt = tokens[:, :, pos + 1]
            return scores + jnp.take_along_axis(logp, nxt[..., None], axis=2)[..., 0], \
                jnp.tile(jnp.arange(K)[None], (B, 1)), nxt

        def beam_select(_):
            flat = cand.reshape(B, K * V)
            top_scores, top_idx = jax.lax.top_k(flat, K)
            return top_scores, top_idx // V, (top_idx % V).astype(jnp.int32)

        new_scores, src_beam, new_tok = jax.lax.cond(
            in_prompt, prompt_select, beam_select, None
        )
        tokens = jnp.take_along_axis(tokens, src_beam[..., None], axis=1)
        finished = jnp.take_along_axis(finished, src_beam, axis=1)
        caches = gather_beams(new_caches, src_beam)
        new_tok = jnp.where(finished, eot_id, new_tok)
        tokens = jax.lax.dynamic_update_slice(
            tokens, new_tok[..., None], (0, 0, pos + 1)
        )
        finished = finished | (~in_prompt & (new_tok == eot_id))
        return tokens, new_scores, finished, caches, pos + 1

    def cond_fn(carry):
        _, _, finished, _, pos = carry
        return (pos < max_len - 1) & ~jnp.all(finished)

    tokens, scores, finished, _, _ = jax.lax.while_loop(
        cond_fn, step_fn, (tokens0, scores0, finished0, caches, jnp.int32(0))
    )

    gen = tokens[:, :, P:]  # [B, K, L]
    is_eot = gen == eot_id
    first_eot = jnp.argmax(is_eot, axis=2)
    lengths = jnp.where(jnp.any(is_eot, axis=2), first_eot, gen.shape[2])  # [B, K]
    return gen, lengths, scores


def load_bigram_matrix(lm_path: str, vocab_size: int) -> jnp.ndarray:
    """Load an NGramCharLM and lower it to a [vocab_size, vocab_size] bigram
    log-prob matrix for on-device fusion, padding ids past the LM vocab
    (model specials) with a uniform floor so they are neither boosted nor
    killed by the LM."""
    from .lm import NGramCharLM

    lm = NGramCharLM.load(lm_path)
    mat = lm.bigram_log_matrix()
    V = vocab_size
    if mat.shape[0] < V:
        import numpy as np

        floor = float(np.median(mat))
        out = jnp.full((V, V), floor, jnp.float32)
        out = out.at[: mat.shape[0], : mat.shape[1]].set(mat)
        return out
    return jnp.asarray(mat[:V, :V])


def resolve_specials(wcfg) -> Tuple[Tuple[int, ...], int]:
    """(prompt, eot) from WhisperConfig, defaulting to the standard
    multilingual Whisper tokens."""
    prompt = tuple(wcfg.prompt_ids) or default_prompt(wcfg.vocab_size)
    eot = wcfg.eot_id if wcfg.eot_id >= 0 else EOT
    return prompt, eot


def generate(bundle, mel: jnp.ndarray, decode_cfg: DecodeConfig):
    """Entry used by ModelBundle.transcribe for the whisper family.

    Whisper's AR beam IS the on-device beam, so both "beam" and
    "beam_device" route to beam_generate; unknown strategies error loudly
    instead of silently falling back to greedy."""
    from ..models.whisper import WhisperModel

    model = WhisperModel(bundle.config.whisper)
    prompt, eot = resolve_specials(bundle.config.whisper)
    if decode_cfg.strategy not in ("greedy", "beam", "beam_device"):
        raise ValueError(f"unknown whisper decode strategy {decode_cfg.strategy!r}")
    # cap the horizon at the position-embedding table: decoding past
    # max_target_positions silently clamps the pos-embed gather and loops
    # on the final embedding (HF generate caps the same way)
    max_len = min(decode_cfg.max_decode_len, bundle.config.whisper.max_target_positions)
    if decode_cfg.strategy in ("beam", "beam_device") and decode_cfg.beam_size > 1:
        lm_bigram = None
        if decode_cfg.lm_path and decode_cfg.lm_weight > 0.0:
            lm_bigram = load_bigram_matrix(
                decode_cfg.lm_path, bundle.config.whisper.vocab_size
            )
        return beam_generate(
            model,
            bundle.params,
            mel,
            beam_size=decode_cfg.beam_size,
            max_len=max_len,
            length_penalty=decode_cfg.length_penalty,
            prompt=prompt,
            eot_id=eot,
            lm_bigram=lm_bigram,
            lm_weight=decode_cfg.lm_weight,
            suppress_ids=bundle.config.whisper.suppress_ids,
            begin_suppress_ids=bundle.config.whisper.begin_suppress_ids,
        )
    return greedy_generate(
        model, bundle.params, mel, max_len=max_len,
        prompt=prompt, eot_id=eot, temperature=decode_cfg.temperature,
        suppress_ids=bundle.config.whisper.suppress_ids,
        begin_suppress_ids=bundle.config.whisper.begin_suppress_ids,
    )
