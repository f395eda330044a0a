"""Continuous-batching serving engine for Whisper AR decode.

The reference serves inference as static batches: transcribe a batch, wait
for the LONGEST utterance's decode to finish, start the next batch
(transformers generate(), SURVEY.md 3.2) — short utterances burn decoder
steps as padding. This engine keeps a fixed pool of `slots` decode lanes
and admits utterances MID-FLIGHT as lanes free up, a statically shaped
form of vLLM-style continuous batching:

* every shape is static (slot count, cache horizons, token buffers) — one
  compile, no recompilation as requests come and go;
* each slot sits at its OWN decode position, so decode_step takes a [S]
  position VECTOR: pos-embed lookups, key masks, and KV-cache row writes
  are all per-row (models/whisper.py decode_step, layers.update_cache_rows);
* admission is ONE batched device dispatch per wave: every queued
  newcomer is featurized + encoded + cache-built together (padded to the
  slot count, unit caches in the SLOT-POOL layout via the init_cache
  layout override) and scattered into its lane — per-request dispatches
  would multiply the fixed dispatch cost;
* decode runs `steps_per_dispatch` tokens per device dispatch
  (lax.fori_loop inside one jit) so the dispatch latency amortizes;
  finished lanes idle at most one dispatch before harvest.

Composes with the int8 serving path: a ModelBundle.quantize()d bundle
admits int8 cross caches (and int8 self caches when the pool layout is
head-major), so the memory-bound decode streams int8 exactly as in offline
serving.

Greedy only: beam serving would multiply every lane by the beam width;
offline beam stays in decode/whisper_generate.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..decode.whisper_generate import _suppression_masks, resolve_specials
from ..frontend import features


@dataclass
class _Request:
    rid: int
    wav: np.ndarray  # padded/trimmed to the model window
    submitted_at: float
    wav_len: int = 0  # samples before padding (timestamp frame clamp)
    started_at: float = 0.0
    finished_at: float = 0.0
    text: Optional[str] = None
    timed: Optional[list] = None  # [{"token","start","end"}] when enabled


@dataclass
class ServingStats:
    """Per-drain serving metrics (examples/serve_bench.py)."""

    completed: int = 0
    decode_steps: int = 0
    dispatches: int = 0
    latencies_s: List[float] = field(default_factory=list)

    @property
    def mean_latency_s(self) -> float:
        return float(np.mean(self.latencies_s)) if self.latencies_s else 0.0

    @property
    def p95_latency_s(self) -> float:
        return (
            float(np.percentile(self.latencies_s, 95))
            if self.latencies_s
            else 0.0
        )


class ServingEngine:
    """Continuous-batching greedy transcription over a fixed slot pool.

    Usage::

        eng = ServingEngine(bundle, slots=8)
        rid = eng.submit(wav)          # non-blocking: queues + admits
        texts = eng.drain()            # run decode until all requests done
        # or the one-call form, order-preserving like bundle.transcribe:
        texts = eng.transcribe([wav1, wav2, ...])
    """

    def __init__(
        self,
        bundle,
        slots: int = 8,
        steps_per_dispatch: int = 32,
        max_len: Optional[int] = None,
        timestamps: bool = False,
    ):
        if bundle.config.model_family != "whisper":
            raise ValueError(
                "ServingEngine drives AR decode; the CTC family is a "
                "single forward pass per batch — use bundle.transcribe"
            )
        from ..models import layers as _layers
        from ..models.whisper import WhisperModel

        self.bundle = bundle
        self.cfg = bundle.config
        wcfg = self.cfg.whisper
        self.model = WhisperModel(wcfg)
        self.slots = int(slots)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.max_len = int(max_len or self.cfg.decode.max_decode_len)
        self.max_len = min(self.max_len, wcfg.max_target_positions)
        # word timing at harvest: each finished request runs one B=1
        # teacher-forced alignment pass (decode/align.py) over its retained
        # window — the horizon is 8-bucketed there, so the pass compiles
        # once per transcript-length bucket, off the decode hot loop
        self.timestamps = bool(timestamps)
        self.layout = (
            "head_major"
            if self.slots >= _layers.HEAD_MAJOR_MIN_BATCH
            else "packed"
        )
        self.prompt, self.eot = resolve_specials(wcfg)
        self._P = len(self.prompt)
        sup_always, sup_begin = _suppression_masks(
            wcfg.vocab_size, wcfg.suppress_ids, wcfg.begin_suppress_ids
        )
        self._sup_always, self._sup_begin = sup_always, sup_begin
        row = np.full((self.max_len,), self.eot, np.int32)
        row[: self._P] = self.prompt
        self._fresh_row = jnp.asarray(row)

        # ---------------- jitted device programs (compiled once each)
        model = self.model
        fe = self.cfg.frontend
        S, P, eot, max_len = self.slots, self._P, self.eot, self.max_len
        fresh_row = self._fresh_row
        layout = self.layout
        self._window = int(fe.chunk_seconds * fe.sample_rate)

        def _prepare(params, wavs):
            """[S, window] padded audio -> ([S, T', d] encoder outputs,
            batch-S unit caches in the pool layout)."""
            mel = features.featurize_batch(wavs, fe)
            enc = model.apply({"params": params}, mel, method=model.encode)
            unit = model.apply(
                {"params": params}, S, enc, max_len, layout,
                method=model.init_cache,
            )
            return enc, unit

        @jax.jit
        def _admit_batch(params, caches, enc_all, tokens, pos, done,
                         wavs, slot_ids):
            """Admit up to S newcomers in ONE dispatch: featurize + encode
            + cache-build the whole wave batched, then scatter row i into
            lane slot_ids[i]. Unused rows carry slot_ids[i] == S, which is
            out of range — JAX drops out-of-bound scatter updates, so they
            are no-ops (padding rows do waste encoder FLOPs, but the shape
            stays static and the device sees one dispatch per admission
            round instead of four per REQUEST)."""
            enc, unit = _prepare(params, wavs)
            caches = jax.tree_util.tree_map(
                lambda big, u: big.at[slot_ids].set(u), caches, unit
            )
            enc_all = enc_all.at[slot_ids].set(enc)
            tokens = tokens.at[slot_ids].set(fresh_row)
            pos = pos.at[slot_ids].set(0)
            done = done.at[slot_ids].set(False)
            return caches, enc_all, tokens, pos, done

        @partial(jax.jit, static_argnames=("n",))
        def _decode_chunk(params, tokens, caches, pos, done, enc_all, n):
            def body(_, carry):
                tokens, caches, pos, done = carry
                tok = jnp.take_along_axis(tokens, pos[:, None], axis=1)
                logits, caches = model.apply(
                    {"params": params},
                    tok,
                    pos,
                    enc_all,
                    caches,
                    None,
                    method=model.decode_step,
                )
                if sup_always is not None:
                    logits = logits + sup_always
                if sup_begin is not None:
                    is_first = (pos + 1 == P).astype(jnp.float32)
                    logits = logits + is_first[:, None] * sup_begin
                nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                is_prompt = pos + 1 < P  # forced decoding of the prompt
                cur_next = jnp.take_along_axis(
                    tokens, (pos + 1)[:, None], axis=1
                )[:, 0]
                nxt = jnp.where(
                    done, eot, jnp.where(is_prompt, cur_next, nxt)
                )
                active = ~done
                tokens = tokens.at[jnp.arange(S), pos + 1].set(nxt)
                done = done | (
                    active & ~is_prompt & (nxt == eot)
                ) | (pos + 1 >= max_len - 1)
                # idle lanes freeze: their cache row rewrites stay put and
                # their token rows are already EOT-terminated
                pos = jnp.where(active, pos + 1, pos)
                return tokens, caches, pos, done

            return jax.lax.fori_loop(
                0, n, body, (tokens, caches, pos, done)
            )

        self._admit_batch = _admit_batch
        self._decode_chunk = _decode_chunk

        # ---------------- pool state: shapes from eval_shape (no compute)
        enc_sd, unit_sd = jax.eval_shape(
            _prepare,
            bundle.params,
            jax.ShapeDtypeStruct((S, self._window), jnp.float32),
        )
        zeros = lambda sd: jnp.zeros(sd.shape, sd.dtype)
        self._caches = jax.tree_util.tree_map(zeros, unit_sd)
        self._enc_all = zeros(enc_sd)
        self._tokens = jnp.tile(self._fresh_row[None], (S, 1))
        self._pos = jnp.zeros((S,), jnp.int32)
        self._done = jnp.ones((S,), bool)  # empty lanes are idle
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._queue: List[_Request] = []
        self._results: Dict[int, _Request] = {}
        self._next_rid = 0
        self.stats = ServingStats()

    # ------------------------------------------------------------- public API
    def submit(self, audio, sample_rate: Optional[int] = None) -> int:
        """Queue one utterance (path / 1-D array at the frontend rate, at
        most one model window — engine.transcribe handles chunking) and
        admit it immediately if a lane is free. Returns a request id."""
        fe = self.cfg.frontend
        wavs, _ = self.bundle._collect_audio(audio, sample_rate)
        if len(wavs) != 1:
            raise ValueError("submit() takes exactly one utterance")
        wav = features.pad_or_trim(wavs[0], fe)
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid=rid, wav=wav, submitted_at=time.monotonic(),
            wav_len=min(len(wavs[0]), self._window),
        )
        self._queue.append(req)
        self._fill_free_slots()
        return rid

    @property
    def in_flight(self) -> int:
        """Requests admitted to lanes or still queued (not yet harvested)."""
        return sum(r is not None for r in self._slot_req) + len(self._queue)

    def step(self) -> List[_Request]:
        """One serving tick: admit queued requests into free lanes, run one
        decode dispatch (steps_per_dispatch tokens), harvest finished lanes.
        Returns the requests that completed on this tick (each with .rid,
        .text, and submit/start/finish timestamps) — the streaming-service
        loop (`cli serve`) calls this as work arrives instead of blocking
        on a full drain()."""
        self._fill_free_slots()
        if not any(r is not None for r in self._slot_req):
            done = list(self._results.values())
            self._results.clear()
            return done
        self._dispatch_and_harvest()
        done = list(self._results.values())
        self._results.clear()
        return done

    def drain(self) -> Dict[int, str]:
        """Decode until every queued and in-flight request has finished.
        Returns {request_id: text} for everything completed since the last
        step()/drain()."""
        out = {r.rid: r.text for r in self.step()}
        while self._queue or any(r is not None for r in self._slot_req):
            for req in self.step():
                out[req.rid] = req.text
        return out

    def transcribe(self, audios: Sequence, sample_rate=None) -> List[str]:
        """Order-preserving convenience: submit every utterance (splitting
        long recordings into model windows and re-joining, matching
        bundle.transcribe's chunked long-form semantics), drain, return
        texts."""
        raw, _ = self.bundle._collect_audio(audios, sample_rate)
        fe = self.cfg.frontend
        window = int(fe.chunk_seconds * fe.sample_rate)
        rids: List[List[int]] = []
        for a in raw:
            group = []
            for s in range(0, max(len(a), 1), window):
                group.append(self.submit(a[s : s + window]))
            rids.append(group)
        texts = self.drain()
        return ["".join(texts[rid] for rid in group) for group in rids]

    # ---------------------------------------------------------------- internals
    def _fill_free_slots(self):
        """Admit queued requests into free lanes — the whole wave in one
        batched device dispatch (_admit_batch)."""
        if not self._queue:
            return
        S = self.slots
        free = [s for s in range(S) if self._slot_req[s] is None]
        take = min(len(free), len(self._queue))
        if take == 0:
            return
        wavs = np.zeros((S, self._window), np.float32)
        slot_ids = np.full((S,), S, np.int32)  # S == drop (padding rows)
        admitted = []
        for i in range(take):
            req = self._queue.pop(0)
            wavs[i] = req.wav
            slot_ids[i] = free[i]
            admitted.append((free[i], req))
        (
            self._caches,
            self._enc_all,
            self._tokens,
            self._pos,
            self._done,
        ) = self._admit_batch(
            self.bundle.params,
            self._caches,
            self._enc_all,
            self._tokens,
            self._pos,
            self._done,
            jnp.asarray(wavs),
            jnp.asarray(slot_ids),
        )
        now = time.monotonic()
        for s, req in admitted:
            req.started_at = now
            self._slot_req[s] = req

    def _dispatch_and_harvest(self):
        n = self.steps_per_dispatch
        self._tokens, self._caches, self._pos, self._done = (
            self._decode_chunk(
                self.bundle.params,
                self._tokens,
                self._caches,
                self._pos,
                self._done,
                self._enc_all,
                n,
            )
        )
        self.stats.dispatches += 1
        self.stats.decode_steps += n
        # ONE host fetch for done + the whole token pool (slots x max_len
        # int32 — a few KB even at flagship scale). Gathering only the
        # finished rows would build a fresh gather program per distinct
        # row count, a compile each, dominating the serve loop.
        done, toks = jax.device_get((self._done, self._tokens))
        now = time.monotonic()
        finished_rows = [
            s
            for s in range(self.slots)
            if done[s] and self._slot_req[s] is not None
        ]
        if not finished_rows:
            return
        for s in finished_rows:
            req = self._slot_req[s]
            gen = toks[s, self._P :]
            eots = np.nonzero(gen == self.eot)[0]
            ln = int(eots[0]) if len(eots) else len(gen)
            ids = gen[:ln]
            req.text = self.bundle.tokenizer.decode(
                [int(i) for i in ids]
            )
            if self.timestamps and ln:
                req.timed = self._align_request(req, ids)
            req.finished_at = now
            self.stats.completed += 1
            self.stats.latencies_s.append(now - req.submitted_at)
            self._results[req.rid] = req
            self._slot_req[s] = None

    def _align_request(self, req: _Request, ids: np.ndarray) -> list:
        """Per-token spans for one finished request via the same
        cross-attention DTW bundle.transcribe_timed runs (decode/align.py);
        output matches it exactly for a single-window utterance."""
        from ..decode.align import whisper_token_spans

        fe = self.cfg.frontend
        mel = features.featurize_batch(
            jnp.asarray(req.wav[None]), fe
        )
        frame_s = fe.hop_length * 2 / fe.sample_rate
        valid = np.asarray(
            [max(req.wav_len // (fe.hop_length * 2), 1)], np.int64
        )
        spans = whisper_token_spans(
            self.cfg.whisper, self.bundle.params, mel,
            ids[None].astype(np.int64), np.asarray([len(ids)]),
            self.prompt, self.eot, valid,
        )[0]
        tok = self.bundle.tokenizer
        return [
            {
                "token": tok.decode([int(t)]),
                "start": round(f0 * frame_s, 3),
                "end": round(f1 * frame_s, 3),
            }
            for t, (f0, f1) in zip(ids, spans)
        ]
