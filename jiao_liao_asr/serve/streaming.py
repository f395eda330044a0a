"""Streaming (online) CTC transcription over a sliding window.

Beyond-reference serving capability: the reference's SpeechBrain/Whisper
stacks decode complete recordings offline (SURVEY.md C14); production
dialect-ASR serving also needs low-latency partial results while audio is
still arriving. The whisper family gets continuous batching from
serve/engine.py; this module is the counterpart for the CTC families, whose
non-autoregressive head makes streaming natural.

Shape of the problem: everything the device sees is ONE jitted
fixed-shape program — featurize a W-second audio window, run the encoder,
emit per-frame argmax ids from the CTC head — dispatched once
per hop. No dynamic shapes, no growing sequences, no per-token host syncs:
the window tensor is [1, W*sr] every step, so XLA compiles exactly one
executable for the life of the stream. All ragged, stateful work (the
audio ring buffer, frame-commit accounting, incremental CTC collapse) is
O(frames/sec) integer bookkeeping and stays on the host.

Commit discipline: the encoder is bidirectional inside the window, so the
newest frames' posteriors will still change as right-context arrives.
A frame is COMMITTED (final, never revisited) once it has at least
`lookahead_seconds` of audio to its right; newer frames are exposed as a
mutable `preview`. Windows advance in hops that keep the encoder-frame
grid aligned (window starts are multiples of hop_length*subsample_factor
samples — the stride-2 conv stack is shift-equivariant at that granularity,
so a global frame index is well-defined across windows), and the committed
ids stream through the same collapse rule as decode.ctc.ctc_greedy_collapse
with the previous frame id carried across window boundaries.

Latency = hop_seconds + lookahead_seconds + one window forward.
Exactness: with
the whole utterance inside one window, finish() reproduces the offline
transcribe() text bit-for-bit (same features, same length mask —
tests/test_streaming.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional

import jax
import numpy as np

from ..frontend import features
from ..utils.config import ExperimentConfig


@dataclass
class StreamingConfig:
    """Sliding-window parameters.

    window_seconds: audio context the encoder sees per step. More context =
      closer to offline quality, linearly more compute per hop.
    hop_seconds: how often a new window is dispatched; the cadence of
      partial results. Must be a multiple of the encoder-frame stride
      (hop_length*subsample_factor samples, 40 ms at the flagship config).
    lookahead_seconds: right context a frame must have before it is
      committed. Smaller = lower latency, larger = committed text closer
      to offline. 0 commits every frame the moment it is computed.
    """

    window_seconds: float = 10.0
    hop_seconds: float = 0.4
    lookahead_seconds: float = 0.64


@dataclass
class StreamingResult:
    """One feed()/finish() outcome."""

    text: str  # all committed (final) text so far
    new_text: str  # text committed by THIS call
    preview: str  # unstable tail past the commit point; will change
    committed_frames: int  # encoder frames finalized so far
    # committed trailing silence (seconds of blank frames since the last
    # non-blank commit) — the endpointing signal: a serving layer finalizes
    # the utterance once this exceeds its threshold (e.g. 0.8 s)
    trailing_silence: float = 0.0
    is_final: bool = False


class StreamingTranscriber:
    """Incremental greedy-CTC transcription for one audio stream.

    >>> st = StreamingTranscriber(bundle)
    >>> for pcm in microphone_chunks():      # float32 @ frontend sample_rate
    ...     res = st.feed(pcm)
    ...     print(res.text + res.preview)
    >>> final_text = st.finish().text

    Works for the flagship CTC family and the joint family's CTC branch
    (model_family "ctc" | "joint"). Whisper's AR decoder needs complete
    utterances — use serve.engine for that family.

    N concurrent streams batch naturally: their window tensors stack to
    [N, W*sr] under one jit. This class keeps the single-stream state
    machine; a pool can share one batched step across instances.
    """

    def __init__(
        self,
        bundle,
        stream_cfg: Optional[StreamingConfig] = None,
        blank_id: Optional[int] = None,
    ):
        self.bundle = bundle
        self.cfg = stream_cfg or StreamingConfig()
        config: ExperimentConfig = bundle.config
        fe = config.frontend
        family = config.model_family
        if family == "ctc":
            sub = config.ctc_model.subsample_factor
            max_frames = config.ctc_model.max_frames
        elif family == "joint":
            sub = config.joint.subsample_factor
            max_frames = config.joint.max_frames
        else:
            raise ValueError(
                f"streaming supports the ctc/joint families, not {family!r}; "
                "whisper serving is serve/engine.py"
            )
        self._align = fe.hop_length * sub  # samples per encoder frame
        self._hop_len = fe.hop_length
        self._sub = sub
        sr = fe.sample_rate
        self._W = int(round(self.cfg.window_seconds * sr))
        self._hop = int(round(self.cfg.hop_seconds * sr))
        if self._W % self._align or self._hop % self._align:
            raise ValueError(
                f"window/hop must be multiples of the encoder frame stride "
                f"({self._align} samples = {self._align / sr:.3f} s); got "
                f"window={self._W}, hop={self._hop}"
            )
        if self._W // fe.hop_length > max_frames:
            raise ValueError(
                f"window of {self._W // fe.hop_length} mel frames exceeds the "
                f"model's max_frames={max_frames}"
            )
        self._look = int(np.ceil(self.cfg.lookahead_seconds * sr / self._align))
        if self._W < self._hop + self._look * self._align:
            raise ValueError(
                "window_seconds must cover hop_seconds + lookahead_seconds; "
                f"got window={self._W}, hop={self._hop}, "
                f"lookahead={self._look} frames"
            )
        self.blank_id = (
            config.decode.ctc_blank_id if blank_id is None else blank_id
        )
        self._family = family
        self._step = _window_step_fn(config, family)

        # ---- host stream state ------------------------------------------
        self._buf = np.zeros(0, np.float32)  # samples [base, base+len)
        self._base = 0  # global sample index of buf[0]
        self._total = 0  # samples received
        self._end = 0  # last processed (hop-aligned) window end
        self._committed = 0  # global encoder frames finalized
        self._prev_id = -1  # last committed frame id (collapse carry)
        self._tokens: List[int] = []  # committed token ids
        # committed tokens' frame spans [(start, end)) in GLOBAL encoder
        # frames — same emission rule as decode.ctc.ctc_collapse_with_times
        self._spans: List[tuple] = []
        self._last_voice = 0  # frame AFTER the last committed non-blank
        self._preview_ids: List[int] = []
        self._finished = False

    # ------------------------------------------------------------------ api
    def feed(self, pcm: np.ndarray) -> StreamingResult:
        """Append audio (float32/float64/int16 mono at the frontend sample
        rate) and return the updated partial transcript."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._append(pcm)
        n_before = len(self._tokens)
        while self._total >= self._end + self._hop:
            self._end += self._hop
            self._run_window(self._end, final=False)
            self._trim()
        return self._result(n_before, final=False)

    def finish(self) -> StreamingResult:
        """Flush: commit every remaining frame and return the final text."""
        if self._finished:
            raise RuntimeError("stream already finished")
        n_before = len(self._tokens)
        if self._total > 0:
            self._run_window(self._total, final=True)
        self._finished = True
        self._preview_ids = []
        return self._result(n_before, final=True)

    @property
    def text(self) -> str:
        return self.bundle.tokenizer.decode(self._tokens)

    @property
    def timed_tokens(self) -> List[dict]:
        """Committed tokens with start/end seconds from the CTC frame
        alignment (matches ModelBundle.transcribe_timed's emission rule)."""
        frame_s = self._align / self.bundle.config.frontend.sample_rate
        tok = self.bundle.tokenizer
        return [
            {
                "token": tok.decode([t]),
                "start": round(s * frame_s, 3),
                "end": round(e * frame_s, 3),
            }
            for t, (s, e) in zip(self._tokens, self._spans)
        ]

    @property
    def timed_words(self) -> List[dict]:
        """Committed words with start/end seconds — timed_tokens merged by
        the same jieba segmentation WER scores (utils/captions.group_words)."""
        from ..utils.captions import group_words

        return group_words(self.timed_tokens)

    # ------------------------------------------------------------- internals
    def _append(self, pcm: np.ndarray) -> None:
        """Buffer audio without dispatching (StreamingPool batches the
        dispatches across slots)."""
        pcm = np.asarray(pcm)
        if pcm.dtype == np.int16:
            pcm = pcm.astype(np.float32) / 32768.0
        pcm = np.ascontiguousarray(pcm, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, pcm])
        self._total += len(pcm)

    def _trim(self) -> None:
        # keep a full window ending at `end`: the NEXT hop window starts at
        # end+hop-W, but a finish() between hops can start its final window
        # as early as aligned_up(total-W) >= end-W — trim to the earlier
        keep_from = max(0, self._end - self._W)
        if keep_from > self._base:
            self._buf = self._buf[keep_from - self._base :]
            self._base = keep_from

    def _build_window(self, end: int):
        """-> (wav [W] float32, valid mel frames, e0 global frame offset).
        Window start sits on the encoder-frame grid (ceil keeps len <= W)."""
        start = max(0, -(-(end - self._W) // self._align) * self._align)
        seg = self._buf[start - self._base : end - self._base]
        wav = np.zeros(self._W, np.float32)
        wav[: len(seg)] = seg
        return wav, len(seg) // self._hop_len, start // self._align

    def _run_window(self, end: int, final: bool) -> None:
        wav, nfr, e0 = self._build_window(end)
        ids, out_lens = self._step(
            self.bundle.params, wav[None], np.asarray([nfr], np.int32)
        )
        self._absorb(np.asarray(ids[0]), int(out_lens[0]), e0, final)

    def _absorb(self, ids: np.ndarray, out_len: int, e0: int, final: bool) -> None:
        """Commit the window's stable frames and refresh the preview."""
        n_glob = e0 + out_len
        cut = n_glob if final else max(self._committed, n_glob - self._look)
        if cut > self._committed:
            new = ids[self._committed - e0 : cut - e0]
            prev = self._prev_id
            for k, t in enumerate(new.tolist()):
                g = self._committed + k
                if t != self.blank_id and t != prev:
                    self._tokens.append(t)
                    self._spans.append((g, g + 1))
                elif t != self.blank_id and self._tokens:
                    # t == prev != blank: the run continues; extend its span
                    self._spans[-1] = (self._spans[-1][0], g + 1)
                if t != self.blank_id:
                    self._last_voice = g + 1
                prev = t
            self._prev_id = prev
            self._committed = cut
        # unstable tail: collapse continues from the committed carry
        tail = ids[cut - e0 : n_glob - e0]
        pv: List[int] = []
        prev = self._prev_id
        for t in tail.tolist():
            if t != self.blank_id and t != prev:
                pv.append(t)
            prev = t
        self._preview_ids = pv

    def _result(self, n_before: int, final: bool) -> StreamingResult:
        tok = self.bundle.tokenizer
        frame_s = self._align / self.bundle.config.frontend.sample_rate
        return StreamingResult(
            text=tok.decode(self._tokens),
            new_text=tok.decode(self._tokens[n_before:]),
            preview=tok.decode(self._preview_ids),
            committed_frames=self._committed,
            trailing_silence=round(
                (self._committed - self._last_voice) * frame_s, 3
            ),
            is_final=final,
        )


class StreamingPool:
    """N concurrent streams sharing ONE batched window program.

    A single stream dispatches a [1, W] window per hop, so the per-dispatch
    cost is paid once per stream; the pool pays it once for all of its
    streams' windows in one [N, W] dispatch. The pool keeps a fixed
    slot count so every step() compiles to the same executable; open slots
    advance by at most one hop per step(), idle rows ride along masked to a
    minimal valid length and their outputs are ignored.

    >>> pool = StreamingPool(bundle, slots=32)
    >>> sid = pool.open()
    >>> pool.feed(sid, pcm)                # buffer only, no dispatch
    >>> for sid, res in pool.step().items():   # one dispatch, all slots
    ...     push_partial(sid, res.text + res.preview)
    >>> final = pool.finish(sid)           # flush + free the slot

    Per-slot semantics are exactly StreamingTranscriber's (same commit
    discipline, same collapse carry); tests pin pool == single-stream text.
    """

    def __init__(self, bundle, slots: int = 8,
                 stream_cfg: Optional[StreamingConfig] = None,
                 device_ring: bool = True):
        self.bundle = bundle
        self.cfg = stream_cfg or StreamingConfig()
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = int(slots)
        # template carries the validated geometry + the memoized step fn;
        # its stream state is never used
        self._proto = StreamingTranscriber(bundle, self.cfg)
        self._active: dict = {}
        self._next_id = 0
        # device-resident audio ring: the window state lives in device
        # memory and only the NEW hop samples cross host->device per step
        # (the ring roll + write + featurize + encode fuse into ONE jitted
        # dispatch). The host-assembled path re-ships the whole [N, W]
        # batch every step — 96% of it window overlap. Bit-identical by
        # construction:
        # each ring row always equals the host-built window.
        self._device_ring = bool(device_ring)
        self._ring = None  # lazy [slots, W] f32 on first ring step
        self._rows: dict = {}  # sid -> ring row
        self._free_rows = list(range(self.slots))
        self._ring_step = (
            _ring_step_fn(bundle.config, self._proto._family,
                          self.slots, self._proto._W, self._proto._hop)
            if self._device_ring else None
        )

    def open(self) -> int:
        """Claim a slot for a new stream; returns its id."""
        if len(self._active) >= self.slots:
            raise RuntimeError(f"pool full ({self.slots} slots)")
        sid = self._next_id
        self._next_id += 1
        self._active[sid] = StreamingTranscriber(self.bundle, self.cfg)
        row = self._free_rows.pop(0)
        self._rows[sid] = row
        if self._ring is not None:
            # reused row must not leak the previous stream's audio
            self._ring = self._ring.at[row].set(0.0)
        return sid

    def feed(self, sid: int, pcm: np.ndarray) -> None:
        """Buffer audio for a stream. No dispatch happens until step()."""
        self._active[sid]._append(pcm)

    def step(self) -> dict:
        """Advance every slot with >= one hop of unprocessed audio by ONE
        hop, in one batched dispatch. Returns {sid: StreamingResult} for the
        slots that advanced."""
        jobs = []
        for sid, st in self._active.items():
            if st._total >= st._end + st._hop:
                st._end += st._hop
                jobs.append((sid, st, st._end, False))
        if self._device_ring:
            out = self._dispatch_ring(jobs)
        else:
            out = self._dispatch(jobs)
        for _, st, _, _ in jobs:
            st._trim()
        return out

    def _dispatch_ring(self, jobs) -> dict:
        if not jobs:
            return {}
        import jax.numpy as jnp

        proto = self._proto
        B, W, H = self.slots, proto._W, proto._hop
        if self._ring is None:
            self._ring = jnp.zeros((B, W), jnp.float32)
        chunk = np.zeros((B, H), np.float32)
        shift = np.zeros((B,), np.int32)
        woff = np.zeros((B,), np.int32)
        advance = np.zeros((B,), np.int32)
        # idle rows still flow through the encoder; a non-empty mask keeps
        # their (discarded) attention rows NaN-free
        nfr = np.full((B,), proto._align // proto._hop_len, np.int32)
        e0s = {}
        for sid, st, end, _ in jobs:
            r = self._rows[sid]
            chunk[r] = st._buf[end - H - st._base : end - st._base]
            start = max(0, end - W)
            shift[r] = start - max(0, end - H - W)
            woff[r] = min(end - H, W - H)
            advance[r] = 1
            nfr[r] = max((end - start) // proto._hop_len, 1)
            e0s[sid] = start // proto._align
        ids, out_lens, self._ring = self._ring_step(
            self.bundle.params, self._ring, chunk,
            shift, woff, advance, nfr,
        )
        ids = np.asarray(ids)
        out_lens = np.asarray(out_lens)
        results = {}
        for sid, st, end, final in jobs:
            r = self._rows[sid]
            n_before = len(st._tokens)
            st._absorb(ids[r], int(out_lens[r]), e0s[sid], final)
            results[sid] = st._result(n_before, final=final)
        return results

    def finish(self, sid: int) -> StreamingResult:
        """Flush a stream's remaining frames and release its slot."""
        st = self._active.pop(sid)
        self._free_rows.append(self._rows.pop(sid))
        # drain backlogged hops first — pool feed() only buffers, so a slot
        # finished without step()s may hold more audio than one window;
        # jumping straight to the final window would skip frames older than
        # total - window
        while st._total >= st._end + st._hop:
            st._end += st._hop
            self._dispatch([(sid, st, st._end, False)])
            st._trim()
        if st._total > 0:
            res = self._dispatch([(sid, st, st._total, True)])[sid]
        else:
            res = st._result(len(st._tokens), final=True)
        st._finished = True
        return res

    def _dispatch(self, jobs) -> dict:
        if not jobs:
            return {}
        proto = self._proto
        B, W = self.slots, proto._W
        wav = np.zeros((B, W), np.float32)
        # idle rows: one encoder frame of silence keeps the length mask
        # non-empty (a fully-masked attention row is NaN); outputs ignored
        nfr = np.full((B,), proto._align // proto._hop_len, np.int32)
        e0s = []
        for i, (sid, st, end, final) in enumerate(jobs):
            row, n, e0 = st._build_window(end)
            wav[i] = row
            nfr[i] = max(n, 1)
            e0s.append(e0)
        ids, out_lens = proto._step(self.bundle.params, wav, nfr)
        ids = np.asarray(ids)
        out_lens = np.asarray(out_lens)
        results = {}
        for i, (sid, st, end, final) in enumerate(jobs):
            n_before = len(st._tokens)
            st._absorb(ids[i], int(out_lens[i]), e0s[i], final)
            results[sid] = st._result(n_before, final=final)
        return results


# jitted window programs memoized like models/bundle._ENCODE_FN_CACHE: one
# executable per (family, model config, window length), shared across streams
_STEP_CACHE: dict = {}


def _window_step_fn(config: ExperimentConfig, family: str):
    import json

    from ..utils.config import to_dict

    sub = config.ctc_model if family == "ctc" else config.joint
    key = (
        "stream",
        family,
        json.dumps(to_dict(sub), sort_keys=True),
        json.dumps(to_dict(config.frontend), sort_keys=True),
    )
    fn = _STEP_CACHE.get(key)
    if fn is not None:
        return fn
    fe = config.frontend
    if family == "ctc":
        from ..models.ctc_model import CTCEncoderModel

        model = CTCEncoderModel(config.ctc_model)

        def run(params, wav, nframes):
            feats = features.featurize_batch(wav, fe)
            return model.apply(
                {"params": params}, feats, nframes,
                deterministic=True, head_mode="argmax_ids",
            )

    else:
        from ..models.joint import JointCTCAttentionModel

        model = JointCTCAttentionModel(config.joint)

        def run(params, wav, nframes):
            feats = features.featurize_batch(wav, fe)
            enc, out_lens = model.apply(
                {"params": params}, feats, nframes, method=model.encode
            )
            ids = model.apply({"params": params}, enc, method=model.ctc_argmax_ids)
            return ids, out_lens

    fn = jax.jit(run)
    _STEP_CACHE[key] = fn
    return fn


def _ring_step_fn(config: ExperimentConfig, family: str, slots: int,
                  window: int, hop: int):
    """Fused ring-update + window forward for StreamingPool's device ring.

    ring [B, W] holds each row's CURRENT window (prefix-valid, exactly what
    the host _build_window would assemble). One dispatch per pool step:

      rolled  = per-row circular left-shift by `shift` (0 while the stream
                is younger than W, then hop)         — one [B, W] gather
      written = rolled with the new hop scattered at `write_off`
      ring'   = where(advance, written, ring)        — idle rows untouched
      ids     = encoder(featurize(ring'), nframes)   — same math as the
                host path on identical window values, so pool-with-ring ==
                pool-without == single-stream, bit for bit

    Host->device per step: [B, hop] samples + 4 [B] int vectors — ~4% of
    re-shipping the [B, W] windows at the default 10 s / 0.4 s geometry.
    """
    import json

    from ..utils.config import to_dict

    sub = config.ctc_model if family == "ctc" else config.joint
    key = (
        "ring", family, slots, window, hop,
        json.dumps(to_dict(sub), sort_keys=True),
        json.dumps(to_dict(config.frontend), sort_keys=True),
    )
    fn = _STEP_CACHE.get(key)
    if fn is not None:
        return fn
    fe = config.frontend
    if family == "ctc":
        from ..models.ctc_model import CTCEncoderModel

        model = CTCEncoderModel(config.ctc_model)

        def forward(params, feats, nframes):
            return model.apply(
                {"params": params}, feats, nframes,
                deterministic=True, head_mode="argmax_ids",
            )

    else:
        from ..models.joint import JointCTCAttentionModel

        model = JointCTCAttentionModel(config.joint)

        def forward(params, feats, nframes):
            enc, out_lens = model.apply(
                {"params": params}, feats, nframes, method=model.encode
            )
            ids = model.apply(
                {"params": params}, enc, method=model.ctc_argmax_ids
            )
            return ids, out_lens

    import jax.numpy as jnp

    @jax.jit
    def run(params, ring, chunk, shift, write_off, advance, nframes):
        B, W = ring.shape
        H = chunk.shape[1]
        idx = (jnp.arange(W)[None, :] + shift[:, None]) % W
        rolled = jnp.take_along_axis(ring, idx, axis=1)
        bidx = jnp.arange(B)[:, None]
        pos = write_off[:, None] + jnp.arange(H)[None, :]
        written = rolled.at[bidx, pos].set(chunk)
        ring2 = jnp.where(advance[:, None] > 0, written, ring)
        feats = features.featurize_batch(ring2, fe)
        ids, out_lens = forward(params, feats, nframes)
        return ids, out_lens, ring2

    _STEP_CACHE[key] = run
    return run
