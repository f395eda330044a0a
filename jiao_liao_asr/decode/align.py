"""Cross-attention forced alignment for the whisper family — per-token
timestamps without touching the model code.

The reference's stack exposes Whisper word timestamps through cross-attention
DTW (transformers 4.36 `generate(return_token_timestamps=True)`,
/root/reference/requirements.txt:81); this is the equivalent here. A
teacher-forced decoder pass returns each block's cross-attention
``q_proj``/``k_proj`` outputs (the decoder's ``cross_qk`` sinks; normal
inference passes none), the attention probabilities are recomputed exactly from them
(softmax(q kᵀ/√dh), the same math the module applies), averaged over heads
and layers, and a monotonic DTW over each utterance's [tokens × encoder
frames] matrix yields contiguous per-token frame spans.

All-heads averaging (vs the HF per-checkpoint "alignment heads" lists):
from-scratch checkpoints carry no alignment-head metadata, and the average is
the convention-free baseline. One encoder frame = 2 mel hops = 20 ms.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np


def _decoder_cross_qk(wcfg, params, mel, tokens, layers=None):
    """Teacher-forced pass returning cross-attention q/k per decoder block.

    Returns {layer_index: (q [B, S, d], k [B, T, d])}. ``tokens`` is the
    full [B, S] sequence (prompt + generated); ``mel`` the [B, mels, frames]
    features the ids were decoded from (the encoder is recomputed once,
    only on the timestamps path). ``layers`` limits the capture to those
    block indices (k alone is [B, 1500, d_model] per layer at large-v3
    scale); None captures all.
    """
    from ..models.whisper import WhisperModel

    model = WhisperModel(wcfg)
    enc = model.apply({"params": params}, mel, method=WhisperModel.encode)
    wanted = range(wcfg.decoder_layers) if layers is None else layers
    sinks = {i: [] for i in wanted if 0 <= i < wcfg.decoder_layers}
    model.apply(
        {"params": params},
        jnp.asarray(tokens, jnp.int32),
        enc,
        method=WhisperModel.decode,
        cross_qk=sinks,
    )
    # DEVICE arrays — kept on device so the probability reduction below runs
    # on-chip and only the small averaged matrix crosses to host.
    # alignment_heads referencing absent layers capture nothing: caller errors
    return {i: sink[0] for i, sink in sinks.items() if sink}


def cross_attention_matrix(wcfg, params, mel, tokens) -> np.ndarray:
    """[B, S, T] f32 — teacher-forced cross-attention probabilities over the
    full encoder horizon. Averages ``wcfg.alignment_heads`` (the HF
    generation_config (layer, head) pairs, imported by whisper_import) when
    set; all heads of all layers otherwise (from-scratch checkpoints carry
    no alignment metadata)."""
    by_layer = {}
    for l, h in wcfg.alignment_heads:
        by_layer.setdefault(int(l), []).append(int(h))
    captured = _decoder_cross_qk(
        wcfg, params, mel, tokens, layers=set(by_layer) if by_layer else None
    )
    assert captured, (
        "no cross-attention captured: empty decoder or alignment_heads "
        "referencing layers outside the model"
    )
    heads_key = tuple(sorted((l, tuple(sorted(h))) for l, h in by_layer.items()))
    reduce_fn = _reduce_fn_for(wcfg.num_heads, heads_key)
    return np.asarray(
        reduce_fn({str(i): v for i, v in captured.items()}), np.float32
    )


_REDUCE_CACHE: dict = {}


def _reduce_fn_for(num_heads: int, heads_key):
    """Memoized jitted reduction: per-layer probs, selected-head sum, layer
    average — ON DEVICE, so only the [B, S, T] matrix leaves the chip (the
    raw q/k at large-v3 scale are ~30 MB/layer f32). Cached per
    (num_heads, alignment-head selection) so repeated calls — the serving
    engine aligns every harvested request — reuse one compiled program per
    shape bucket."""
    import jax

    key = (num_heads, heads_key)
    if key not in _REDUCE_CACHE:
        by_layer = {l: list(hs) for l, hs in heads_key}

        @jax.jit
        def _reduce(qk):
            acc = None
            n = 0
            for i, (q, k) in sorted(qk.items()):
                heads = by_layer.get(int(i)) if by_layer else None
                B, S, d = q.shape
                T = k.shape[1]
                dh = d // num_heads
                qh = q.reshape(B, S, num_heads, dh).astype(jnp.float32)
                kh = k.reshape(B, T, num_heads, dh).astype(jnp.float32)
                s = jnp.einsum(
                    "bshd,bthd->bhst", qh, kh,
                    preferred_element_type=jnp.float32,
                ) / np.sqrt(dh)
                p = jax.nn.softmax(s, axis=-1)
                if heads:
                    p = p[:, jnp.asarray(heads)]
                acc = p.sum(axis=1) if acc is None else acc + p.sum(axis=1)
                n += p.shape[1]
            return acc / n

        _REDUCE_CACHE[key] = _reduce
    return _REDUCE_CACHE[key]


def dtw_spans(attn: np.ndarray) -> List[Tuple[int, int]]:
    """Monotonic DTW over one utterance's [S_tokens, T_frames] attention
    matrix. Moves are (token+1, frame+1) and (token, frame+1) — every token
    occupies >= 1 frame, frames advance strictly — maximizing the summed
    log-probability along the path. Returns one (start_frame, end_frame)
    half-open span per token, contiguous and non-overlapping whenever
    T >= S; with fewer frames than tokens (pathological) a 1-frame-per-span
    contiguous cover cannot exist, so spans spread evenly and may repeat
    (starts stay non-decreasing)."""
    S, T = attn.shape
    if S == 0:
        return []
    if T < S:  # degenerate: fewer frames than tokens — spread evenly
        edges = np.linspace(0, T, S + 1).astype(int)
        return [(int(edges[i]), int(max(edges[i + 1], edges[i] + 1))) for i in range(S)]
    logA = np.log(np.maximum(attn, 1e-12))
    NEG = -1e18
    # D[i, j]: best score of a path ending with token i at frame j
    D = np.full((S, T), NEG)
    ptr = np.zeros((S, T), np.uint8)  # 0 = stay on token row, 1 = came from row above
    D[0, 0] = logA[0, 0]
    for j in range(1, T):
        D[0, j] = D[0, j - 1] + logA[0, j]
    for i in range(1, S):
        # frame j must be >= token index i (each earlier token took a frame)
        for j in range(i, T - (S - 1 - i)):
            stay = D[i, j - 1]
            up = D[i - 1, j - 1]
            if up >= stay:
                D[i, j] = up + logA[i, j]
                ptr[i, j] = 1
            else:
                D[i, j] = stay + logA[i, j]
    # backtrack from (S-1, T-1)
    bounds = np.zeros(S, np.int64)  # first frame of each token
    i, j = S - 1, T - 1
    while i > 0:
        if ptr[i, j]:
            bounds[i] = j
            i -= 1
        j -= 1
    spans = []
    for t in range(S):
        start = int(bounds[t])
        end = int(bounds[t + 1]) if t + 1 < S else T
        spans.append((start, max(end, start + 1)))
    return spans


def whisper_token_spans(
    wcfg,
    params,
    mel,
    gen_ids: np.ndarray,  # [B, G] generated tokens (after the prompt)
    gen_lens: np.ndarray,  # [B] tokens before the first EOT
    prompt: Tuple[int, ...],
    eot: int,
    valid_frames: Optional[np.ndarray] = None,  # [B] encoder frames w/ audio
) -> List[List[Tuple[int, int]]]:
    """Per utterance, one (start_frame, end_frame) encoder-frame span per
    generated text token. Query rows are the tokens' own input positions
    (the transformers convention for token timestamps)."""
    B = gen_ids.shape[0]
    P = len(prompt)
    G = int(gen_lens.max()) if B else 0
    if G == 0:
        return [[] for _ in range(B)]
    # bucket the token horizon so the teacher-forced program compiles once
    # per bucket, not once per distinct transcript length (decoder
    # self-attention is causal: end-padding never reaches earlier query
    # rows, and only rows < P + gen_lens[b] are read below)
    G = min(-(-G // 8) * 8, gen_ids.shape[1])
    tokens = np.full((B, P + G), eot, np.int64)
    tokens[:, :P] = np.asarray(prompt, np.int64)[None]
    tokens[:, P:] = gen_ids[:, :G]
    A = cross_attention_matrix(wcfg, params, mel, tokens)  # [B, P+G, T]
    T = A.shape[-1]
    out: List[List[Tuple[int, int]]] = []
    for b in range(B):
        n = int(gen_lens[b])
        if n == 0:
            out.append([])
            continue
        tv = T if valid_frames is None else max(int(valid_frames[b]), 1)
        out.append(dtw_spans(A[b, P : P + n, : min(tv, T)]))
    return out
