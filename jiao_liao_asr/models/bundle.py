"""ModelBundle: config + params + tokenizer, the object behind api.load().

Mirrors the reference's (model, processor) pair from HF from_pretrained
(SURVEY.md 3.2) as one explicit value. Transcription runs the BASELINE
configs[0-1] stacks: featurize on device -> encoder -> CTC greedy / prefix
beam (or Whisper AR generate for the whisper family).
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import (
    CTCModelConfig,
    DecodeConfig,
    ExperimentConfig,
    FrontendConfig,
    from_dict,
    load_config,
    to_dict,
)
from ..data.tokenizer import CharTokenizer
from ..frontend import audio_io, features
from ..frontend.resample import resample as _resample
from ..decode.ctc import ctc_prefix_beam_search, ids_to_texts


# jitted encode functions memoized by model-structure signature: in-training
# eval constructs a fresh ModelBundle per call, and a per-instance jit would
# recompile the encoder every eval
_ENCODE_FN_CACHE: dict = {}


def _whisper_generate_fn_for(config: ExperimentConfig, decode_cfg: DecodeConfig):
    """Memoized jitted whisper generate: one XLA program per (model, decode)
    signature instead of per-op dispatch (dispatch latency would dominate
    an unjitted AR loop) or per-eval retracing."""
    key = (
        "wgen",
        json.dumps(to_dict(config.whisper), sort_keys=True),
        json.dumps(to_dict(decode_cfg), sort_keys=True),
    )
    fn = _ENCODE_FN_CACHE.get(key)
    if fn is None:
        from ..decode import whisper_generate as wg
        from .whisper import WhisperModel

        model = WhisperModel(config.whisper)
        prompt, eot = wg.resolve_specials(config.whisper)
        strategy = decode_cfg.strategy
        if strategy not in ("greedy", "beam", "beam_device"):
            raise ValueError(f"unknown whisper decode strategy {strategy!r}")
        use_beam = strategy in ("beam", "beam_device") and decode_cfg.beam_size > 1
        lm_bigram = None
        if use_beam and decode_cfg.lm_path and decode_cfg.lm_weight > 0.0:
            lm_bigram = wg.load_bigram_matrix(
                decode_cfg.lm_path, config.whisper.vocab_size
            )

        sup = config.whisper.suppress_ids
        bsup = config.whisper.begin_suppress_ids
        # cap at the position-embedding table: past max_target_positions the
        # pos-embed gather clamps and the decoder loops on the last embedding
        max_len = min(decode_cfg.max_decode_len, config.whisper.max_target_positions)
        if use_beam:
            def run(params, mel):
                return wg.beam_generate(
                    model, params, mel,
                    beam_size=decode_cfg.beam_size,
                    max_len=max_len,
                    length_penalty=decode_cfg.length_penalty,
                    prompt=prompt, eot_id=eot,
                    lm_bigram=lm_bigram, lm_weight=decode_cfg.lm_weight,
                    suppress_ids=sup, begin_suppress_ids=bsup,
                )
        else:
            def run(params, mel):
                return wg.greedy_generate(
                    model, params, mel, max_len=max_len,
                    prompt=prompt, eot_id=eot,
                    temperature=decode_cfg.temperature,
                    suppress_ids=sup, begin_suppress_ids=bsup,
                )

        fn = jax.jit(run)
        _ENCODE_FN_CACHE[key] = fn
    return fn


def _joint_generate_fn_for(config: ExperimentConfig, decode_cfg: DecodeConfig):
    """Memoized jitted decode for the joint CTC/attention family:
    greedy/beam = attention decode (beam adds CTC joint rescoring,
    decode/joint_generate.py); ctc_greedy = the CTC branch's
    head+argmax fast path."""
    key = (
        "jgen",
        json.dumps(to_dict(config.joint), sort_keys=True),
        json.dumps(to_dict(decode_cfg), sort_keys=True),
    )
    fn = _ENCODE_FN_CACHE.get(key)
    if fn is None:
        from ..decode import joint_generate as jg
        from ..decode.ctc import ctc_greedy_collapse
        from .joint import JointCTCAttentionModel

        model = JointCTCAttentionModel(config.joint)
        strategy = decode_cfg.strategy
        if strategy not in (
            "greedy", "beam", "beam_device", "ctc_greedy", "spec_greedy"
        ):
            raise ValueError(f"unknown joint decode strategy {strategy!r}")

        if strategy == "spec_greedy":
            from ..decode.speculative import joint_spec_greedy

            def run(params, feats, flens):
                # CTC-draft speculative decode: same text as `greedy`, the
                # sequential AR loop replaced by a few parallel verification
                # passes (decode/speculative.py)
                return joint_spec_greedy(
                    model, params, feats, flens,
                    max_len=decode_cfg.max_decode_len,
                )
        elif strategy == "ctc_greedy":
            def run(params, feats, flens):
                enc, out_lens = model.apply(
                    {"params": params}, feats, flens, method=model.encode
                )
                ids = model.apply(
                    {"params": params}, enc, method=model.ctc_argmax_ids
                )
                return ctc_greedy_collapse(ids, out_lens, decode_cfg.ctc_blank_id)
        elif strategy == "greedy":
            def run(params, feats, flens):
                return jg.joint_greedy(
                    model, params, feats, flens,
                    max_len=decode_cfg.max_decode_len,
                )
        else:
            def run(params, feats, flens):
                return jg.joint_beam(
                    model, params, feats, flens,
                    beam_size=decode_cfg.beam_size,
                    max_len=decode_cfg.max_decode_len,
                    length_penalty=decode_cfg.length_penalty,
                )

        fn = jax.jit(run)
        _ENCODE_FN_CACHE[key] = fn
    return fn


def _encode_fn_for(config: ExperimentConfig):
    sub = config.ctc_model if config.model_family == "ctc" else config.whisper
    key = (config.model_family, json.dumps(to_dict(sub), sort_keys=True))
    fn = _ENCODE_FN_CACHE.get(key)
    if fn is None:
        model = ModelBundle._model(config)

        @jax.jit
        def fn(params, f, fl):
            return model.apply({"params": params}, f, fl, deterministic=True)

        _ENCODE_FN_CACHE[key] = fn
    return fn


def _ctc_greedy_fn_for(config: ExperimentConfig, blank_id: int):
    """Memoized jitted greedy path: trunk -> head argmax -> on-device
    collapse (only ids leave the device)."""
    key = (
        "ctc_greedy",
        json.dumps(to_dict(config.ctc_model), sort_keys=True),
        blank_id,
    )
    fn = _ENCODE_FN_CACHE.get(key)
    if fn is None:
        from ..decode.ctc import ctc_greedy_collapse
        from .ctc_model import CTCEncoderModel

        model = CTCEncoderModel(config.ctc_model)

        @jax.jit
        def fn(params, f, fl):
            ids, out_lens = model.apply(
                {"params": params}, f, fl, deterministic=True,
                head_mode="argmax_ids",
            )
            return ctc_greedy_collapse(ids, out_lens, blank_id)

        _ENCODE_FN_CACHE[key] = fn
    return fn


def _argmax_fn_for(config: ExperimentConfig):
    """Memoized jitted per-frame argmax ids WITHOUT the device collapse —
    the timestamp path needs the raw frame alignment (ctc/joint families)."""
    sub = config.ctc_model if config.model_family == "ctc" else config.joint
    key = (
        "argmax_frames",
        config.model_family,
        json.dumps(to_dict(sub), sort_keys=True),
    )
    fn = _ENCODE_FN_CACHE.get(key)
    if fn is None:
        if config.model_family == "ctc":
            from .ctc_model import CTCEncoderModel

            model = CTCEncoderModel(config.ctc_model)

            @jax.jit
            def fn(params, f, fl):
                return model.apply(
                    {"params": params}, f, fl, deterministic=True,
                    head_mode="argmax_ids",
                )

        else:
            from .joint import JointCTCAttentionModel

            model = JointCTCAttentionModel(config.joint)

            @jax.jit
            def fn(params, f, fl):
                enc, out_lens = model.apply(
                    {"params": params}, f, fl, method=model.encode
                )
                ids = model.apply(
                    {"params": params}, enc, method=model.ctc_argmax_ids
                )
                return ids, out_lens

        _ENCODE_FN_CACHE[key] = fn
    return fn


@dataclass
class ModelBundle:
    config: ExperimentConfig
    params: Any
    tokenizer: Any
    _jitted_encode: Any = field(default=None, repr=False)
    mesh: Any = field(default=None, repr=False)

    # -------------------------------------------------------------- sharding
    def shard(self, mesh=None) -> "ModelBundle":
        """Shard params for multi-chip INFERENCE: Megatron-style TP over
        'model' (parallel/tp_rules.py) layered on FSDP over 'fsdp', from
        config.mesh. Subsequent encode/transcribe calls shard input batches
        over 'data', trace under the mesh (so attention runs per shard,
        models/layers.dot_product_attention) and XLA propagates the
        shardings through the jitted programs (the serving-scale path for
        whisper-large-v3,
        BASELINE configs[4]; tested on the virtual CPU-8 mesh in
        tests/test_tp.py)."""
        from ..parallel.mesh import build_mesh
        from ..parallel.tp_rules import fsdp_tp_sharding

        if mesh is None:
            mesh = build_mesh(self.config.mesh)
        sh = fsdp_tp_sharding(mesh, self.params)
        object.__setattr__(
            self,
            "params",
            jax.tree_util.tree_map(lambda p, s: jax.device_put(p, s), self.params, sh),
        )
        object.__setattr__(self, "mesh", mesh)
        return self

    # --------------------------------------------------------- quantization
    def quantize(self) -> "ModelBundle":
        """Weight-only int8 quantization of the DECODER Dense kernels for
        memory-bound AR serving (ops/quant.py): every `dense` subtree under
        params['decoder'] becomes `dense_q` = {kernel_q int8, scale f32
        [d_out], bias}, which adapters.wf_dense reads per step. The
        encoder stays bf16 — it is compute-bound and reads its weights once
        per utterance. Decode from a quantized tree also stores the
        cross-attention AND self-attention KV caches int8 with per-position
        scales (whisper.build_decode_caches + layers._int8_cache_attention;
        self rows are quantized as decode writes them): both are re-read end
        to end every step, the other dominant memory terms. The tied
        embedding/logit table is quantized per vocab row (TiedEmbedding +
        ops/quant.int8_tied_logits).

        Whisper-only (the flagship CTC family is encoder-only: nothing is
        weight-read-bound). Returns a NEW bundle; a serving-time transform,
        not a checkpoint format. Token fidelity vs the bf16 decoder is
        asserted in tests/test_quant.py."""
        if self.config.model_family != "whisper":
            raise NotImplementedError(
                "int8 decode serving targets the whisper family; the CTC/"
                "joint encoders are compute-bound, not weight-read-bound"
            )
        from ..ops.quant import quantize_int8

        def walk(node):
            if not isinstance(node, dict):
                return node
            out = {}
            for k, v in node.items():
                if (
                    k == "dense"
                    and isinstance(v, dict)
                    and "kernel" in v
                    and getattr(v["kernel"], "ndim", 0) == 2
                ):
                    q, scale = quantize_int8(v["kernel"])
                    dq = {"kernel_q": q, "scale": scale}
                    if "bias" in v:
                        dq["bias"] = v["bias"]
                    out["dense_q"] = dq
                elif (
                    k == "embed_tokens"
                    and isinstance(v, dict)
                    and "embedding" in v
                ):
                    # tied embedding/logit table [V, D]: per-VOCAB-ROW int8
                    # (quantize_int8 scales per column of its input, so feed
                    # the transpose). The row scale commutes through both
                    # uses: lookup rows dequantize per token; tied logits
                    # are (x . E[v]) * s[v]. models/whisper.TiedEmbedding
                    # dispatches on the embedding_q key.
                    qT, scale = quantize_int8(jnp.asarray(v["embedding"]).T)
                    out[k] = {"embedding_q": qT.T, "scale": scale}
                else:
                    out[k] = walk(v)
            return out

        params = dict(self.params)
        params["decoder"] = walk(params["decoder"])
        return ModelBundle(
            config=self.config, params=params, tokenizer=self.tokenizer
        )

    def _on_mesh(self):
        """The context the inference entry points trace in: the mesh that
        shard() placed the params on, or none."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return jax.set_mesh(self.mesh)

    def _shard_inputs(self, *arrays):
        """Shard leading (batch) axes over the mesh data axes (ragged
        batches replicate — see parallel.mesh.shard_batch)."""
        if self.mesh is None:
            return arrays
        from ..parallel.mesh import shard_batch

        return tuple(shard_batch(self.mesh, a) for a in arrays)

    # ------------------------------------------------------------------ load
    @classmethod
    def load(
        cls,
        checkpoint: Optional[str] = None,
        config: Optional[Union[str, ExperimentConfig]] = None,
        tokenizer: Optional[Any] = None,
    ) -> "ModelBundle":
        if isinstance(config, str):
            config = load_config(config)
        if checkpoint is not None:
            ckpt = Path(checkpoint)
            if ckpt.is_dir() and (ckpt / "config.json").exists():
                config = load_config(str(ckpt / "config.json"))
            if config is None:
                raise ValueError("checkpoint without config.json needs explicit config")
            params = cls._load_params(ckpt, config)
            if tokenizer is None and ckpt.is_dir():
                if (ckpt / "merges.txt").exists():
                    # HF-format BPE files (whisper family)
                    from ..data.bpe import ByteLevelBPE

                    tokenizer = ByteLevelBPE.from_hf_dir(ckpt)
                elif (ckpt / "vocab.json").exists():
                    import json as _json

                    obj = _json.loads((ckpt / "vocab.json").read_text(
                        encoding="utf-8"
                    ))
                    if obj.get("type") == "unigram":
                        from ..data.unigram import UnigramTokenizer

                        tokenizer = UnigramTokenizer(
                            obj["pieces"], obj["logprobs"]
                        )
                    else:
                        tokenizer = CharTokenizer.load(ckpt / "vocab.json")
        else:
            if config is None:
                config = ExperimentConfig()
            params = cls._init_params(config)
        if tokenizer is None:
            tokenizer = CharTokenizer([])  # blank+unk only; tests override
        bundle = cls(config=config, params=params, tokenizer=tokenizer)
        m = config.mesh
        if (m.fsdp_axis > 1 or m.model_axis > 1) and (
            len(jax.devices()) >= m.fsdp_axis * m.model_axis
        ):
            # explicit multi-chip request in the config: shard for inference.
            # A checkpoint saved with a pod-scale mesh config must still LOAD
            # on a host whose device count doesn't tile the requested mesh
            # (e.g. fsdp=4 on 6 devices) — fall back to unsharded with a
            # warning instead of crashing in build_mesh's divisibility check.
            try:
                bundle.shard()
            except ValueError as e:
                import warnings

                warnings.warn(
                    f"config requests mesh fsdp={m.fsdp_axis} model={m.model_axis} "
                    f"but {len(jax.devices())} devices don't tile it ({e}); "
                    "loading unsharded"
                )
        return bundle

    @staticmethod
    def _model(config: ExperimentConfig):
        if config.model_family == "ctc":
            from .ctc_model import CTCEncoderModel

            return CTCEncoderModel(config.ctc_model)
        elif config.model_family == "whisper":
            from .whisper import WhisperModel

            return WhisperModel(config.whisper)
        elif config.model_family == "joint":
            from .joint import JointCTCAttentionModel

            return JointCTCAttentionModel(config.joint)
        raise ValueError(f"unknown model family {config.model_family!r}")

    @classmethod
    def _init_params(cls, config: ExperimentConfig, seed: int = 0):
        model = cls._model(config)
        fe = config.frontend
        if config.model_family == "ctc":
            dummy = jnp.zeros((1, fe.num_mels, 256), jnp.float32)
            return model.init(jax.random.PRNGKey(seed), dummy)["params"]
        if config.model_family == "joint":
            t = min(256, config.joint.max_frames)
            s = min(8, config.joint.max_target_positions)
            dummy = jnp.zeros((1, config.joint.num_mels, t), jnp.float32)
            toks = jnp.zeros((1, s), jnp.int32)
            return model.init(
                jax.random.PRNGKey(seed), dummy, None, toks
            )["params"]
        # dummy sized inside the model's receptive-field limits (conv2 halves
        # the frame count; small test configs shrink max_source_positions)
        t = min(256, 2 * config.whisper.max_source_positions)
        s = min(8, config.whisper.max_target_positions)
        dummy_mel = jnp.zeros((1, config.whisper.num_mels, t), jnp.float32)
        dummy_tok = jnp.zeros((1, s), jnp.int32)
        return model.init(jax.random.PRNGKey(seed), dummy_mel, dummy_tok)["params"]

    @classmethod
    def _load_params(cls, ckpt: Path, config: ExperimentConfig):
        from ..train.checkpoints import restore_params

        return restore_params(str(ckpt), cls._init_params(config))

    def save(self, path: str) -> None:
        from ..parallel import multihost as mh
        from ..train.checkpoints import save_params
        from ..utils.config import save_config

        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        if mh.is_primary():
            # host-side metadata is primary-only under multi-host SPMD; the
            # the param save below gathers collectively; the primary writes
            save_config(self.config, str(p / "config.json"))
            if hasattr(self.tokenizer, "save"):
                self.tokenizer.save(p / "vocab.json")
        save_params(str(p), self.params)
        mh.barrier("bundle_save")

    # ------------------------------------------------------------- inference
    def encode(self, feats: jnp.ndarray, feat_lengths: jnp.ndarray):
        """[B, mels, T] -> (log_probs, lengths) via the jitted encoder."""
        if self._jitted_encode is None:
            object.__setattr__(
                self, "_jitted_encode", _encode_fn_for(self.config)
            )
        with self._on_mesh():
            return self._jitted_encode(self.params, feats, feat_lengths)

    def transcribe(
        self,
        audio: Union[str, np.ndarray, Sequence],
        sample_rate: Optional[int] = None,
        decode_cfg: Optional[DecodeConfig] = None,
    ) -> List[str]:
        """Audio -> text. Recordings longer than the model's receptive field
        (chunk_seconds, 30 s for Whisper parity — SURVEY §5.7) are split into
        consecutive chunks, transcribed batched, and re-joined per utterance,
        matching the reference's chunked long-form semantics."""
        decode_cfg = decode_cfg or self.config.decode
        fe = self.config.frontend
        wavs, alens, owners = self._prepare_audio_chunked(audio, sample_rate)
        with self._on_mesh():
            texts = self._transcribe_prepared(wavs, alens, decode_cfg)
        out: List[str] = []
        for group in owners:
            out.append("".join(texts[i] for i in group))
        return out

    def transcribe_timed(
        self,
        audio: Union[str, np.ndarray, Sequence],
        sample_rate: Optional[int] = None,
    ) -> List[List[dict]]:
        """Greedy transcription WITH per-token timestamps. Returns, per
        utterance, a list of ``{"token": str, "start": s, "end": s}`` whose
        concatenated tokens equal transcribe(greedy)'s text. ctc/joint
        families: the CTC frame alignment gives spans directly (same emission
        rule, host-side collapse keeping spans —
        decode/ctc.ctc_collapse_with_times). whisper family: cross-attention
        DTW forced alignment (decode/align.py — the counterpart of
        transformers' return_token_timestamps). Long recordings chunk exactly
        like transcribe(); chunk k's tokens are offset by k * chunk_seconds."""
        with self._on_mesh():
            if self.config.model_family == "whisper":
                return self._transcribe_timed_whisper(audio, sample_rate)
            return self._transcribe_timed_ctc(audio, sample_rate)

    def _transcribe_timed_ctc(self, audio, sample_rate) -> List[List[dict]]:
        from ..decode.ctc import ctc_collapse_with_times

        fe = self.config.frontend
        sub = (
            self.config.ctc_model
            if self.config.model_family == "ctc"
            else self.config.joint
        )
        frame_s = fe.hop_length * sub.subsample_factor / fe.sample_rate
        blank = self.config.decode.ctc_blank_id
        wavs, alens, owners = self._prepare_audio_chunked(audio, sample_rate)
        wav_dev, = self._shard_inputs(jnp.asarray(wavs))
        feats = features.featurize_batch(wav_dev, fe)
        flens = jnp.asarray(alens // fe.hop_length, dtype=jnp.int32)
        flens, = self._shard_inputs(flens)
        ids, out_lens = _argmax_fn_for(self.config)(self.params, feats, flens)
        ids = np.asarray(ids)
        out_lens = np.asarray(out_lens)
        out: List[List[dict]] = []
        for group in owners:
            utt: List[dict] = []
            for j, piece in enumerate(group):
                off = j * fe.chunk_seconds
                for tid, t0, t1 in ctc_collapse_with_times(
                    ids[piece], int(out_lens[piece]), blank
                ):
                    utt.append({
                        "token": self.tokenizer.decode([tid]),
                        "start": round(off + t0 * frame_s, 3),
                        "end": round(off + t1 * frame_s, 3),
                    })
            out.append(utt)
        return out

    def _transcribe_timed_whisper(
        self, audio, sample_rate
    ) -> List[List[dict]]:
        """Whisper per-token timestamps: greedy generate (the same jitted
        program transcribe(greedy) runs), then one teacher-forced pass whose
        captured cross-attention q/k feed the DTW alignment in
        decode/align.py. Alignment cost is one extra forward per chunk,
        only on this path."""
        from dataclasses import replace as _dc_replace

        from ..decode import whisper_generate as wg
        from ..decode.align import whisper_token_spans

        fe = self.config.frontend
        wcfg = self.config.whisper
        wavs, alens, owners = self._prepare_audio_chunked(audio, sample_rate)
        wav_dev, = self._shard_inputs(jnp.asarray(wavs))
        feats = features.featurize_batch(wav_dev, fe)
        dc = _dc_replace(self.config.decode, strategy="greedy")
        ids, lens = _whisper_generate_fn_for(self.config, dc)(self.params, feats)
        ids, lens = np.asarray(ids), np.asarray(lens)
        prompt, eot = wg.resolve_specials(wcfg)
        # one encoder frame = 2 mel hops (Whisper conv subsampling, stride 2:
        # 3000 mel frames -> max_source_positions=1500) = 20 ms at 16 kHz
        frame_s = fe.hop_length * 2 / fe.sample_rate
        valid = np.maximum(alens // (fe.hop_length * 2), 1).astype(np.int64)
        spans = whisper_token_spans(
            wcfg, self.params, feats, ids, lens, prompt, eot, valid
        )
        out: List[List[dict]] = []
        for group in owners:
            utt: List[dict] = []
            for j, piece in enumerate(group):
                off = j * fe.chunk_seconds
                n = int(lens[piece])
                for tid, (f0, f1) in zip(ids[piece][:n], spans[piece]):
                    utt.append({
                        "token": self.tokenizer.decode([int(tid)]),
                        "start": round(off + f0 * frame_s, 3),
                        "end": round(off + f1 * frame_s, 3),
                    })
            out.append(utt)
        return out

    def _prepare_audio_chunked(self, audio, sample_rate):
        fe = self.config.frontend
        chunk = int(fe.chunk_seconds * fe.sample_rate)
        raw, _ = self._collect_audio(audio, sample_rate)
        pieces: List[np.ndarray] = []
        owners: List[List[int]] = []
        for a in raw:
            group = []
            for s in range(0, max(len(a), 1), chunk):
                group.append(len(pieces))
                pieces.append(a[s : s + chunk])
            owners.append(group)
        batch = np.stack([features.pad_or_trim(p, fe) for p in pieces])
        lens = np.asarray([min(len(p), chunk) for p in pieces], np.int32)
        return batch, lens, owners

    def _transcribe_prepared(self, wavs, alens, decode_cfg) -> List[str]:
        fe = self.config.frontend
        wav_dev, = self._shard_inputs(jnp.asarray(wavs))
        feats = features.featurize_batch(wav_dev, fe)
        flens = jnp.asarray(alens // fe.hop_length, dtype=jnp.int32)
        flens, = self._shard_inputs(flens)
        if self.config.model_family == "whisper":
            ids, lens = _whisper_generate_fn_for(self.config, decode_cfg)(
                self.params, feats
            )
            return ids_to_texts(np.asarray(ids), np.asarray(lens), self.tokenizer)
        if self.config.model_family == "joint":
            ids, lens = _joint_generate_fn_for(self.config, decode_cfg)(
                self.params, feats, flens
            )
            return ids_to_texts(np.asarray(ids), np.asarray(lens), self.tokenizer)
        if decode_cfg.strategy in ("greedy", "ctc_greedy"):
            # greedy path: head argmax + collapse on device, ids only to host
            ids, lens = _ctc_greedy_fn_for(self.config, decode_cfg.ctc_blank_id)(
                self.params, feats, flens
            )
            return ids_to_texts(np.asarray(ids), np.asarray(lens), self.tokenizer)
        log_probs, out_lens = self.encode(feats, flens)
        if decode_cfg.strategy == "beam":
            from ..utils.native_ext import native_available

            lm = None
            if decode_cfg.lm_path and decode_cfg.lm_weight > 0.0:
                from ..decode.lm import NGramCharLM

                lm = NGramCharLM.load(decode_cfg.lm_path)
            if lm is None and native_available("beam"):
                # production beam: C++ engine over device-pruned top-k
                # posteriors, multithreaded across utterances — same merge
                # semantics as the python searcher (tests/test_beam_native.py)
                from ..decode.ctc import ctc_prefix_beam_search_native

                ids, lens = ctc_prefix_beam_search_native(
                    log_probs, out_lens,
                    decode_cfg.beam_size, decode_cfg.ctc_blank_id,
                    topk_tokens=decode_cfg.beam_topk,
                    prune_logp=decode_cfg.beam_prune_logp,
                )
            else:
                # python host beam: zero native deps + external-LM fusion
                from ..decode.ctc import ctc_prefix_beam_search_host

                ids, lens = ctc_prefix_beam_search_host(
                    np.asarray(log_probs), np.asarray(out_lens),
                    decode_cfg.beam_size, decode_cfg.ctc_blank_id,
                    topk_tokens=decode_cfg.beam_topk,
                    lm=lm, lm_weight=decode_cfg.lm_weight,
                )
        elif decode_cfg.strategy == "beam_device":
            ids, lens = ctc_prefix_beam_search(
                log_probs, out_lens, decode_cfg.beam_size, decode_cfg.ctc_blank_id,
                topk_tokens=min(decode_cfg.beam_topk, 16),
            )
        else:
            raise ValueError(f"unknown ctc decode strategy {decode_cfg.strategy!r}")
        return ids_to_texts(np.asarray(ids), np.asarray(lens), self.tokenizer)

    def _collect_audio(self, audio, sample_rate):
        """Normalize inputs to a list of mono float32 arrays at fe.sample_rate.

        Every item carries its OWN source rate — files report theirs from the
        WAV header, raw arrays use `sample_rate` (None = already at target) —
        and each is resampled individually, so mixed-rate file lists and
        file/array mixtures are all brought to fe.sample_rate correctly.
        """
        fe = self.config.frontend

        def one(a):
            if isinstance(a, (str, Path)):
                return audio_io.read_audio(a)
            return np.asarray(a, np.float32), (sample_rate or fe.sample_rate)

        if isinstance(audio, (str, Path)):
            items = [one(audio)]
        elif isinstance(audio, np.ndarray) and audio.ndim == 1:
            items = [one(audio)]
        elif isinstance(audio, np.ndarray):
            items = [one(a) for a in audio]
        else:
            items = [one(a) for a in audio]
        out = []
        for pcm, sr in items:
            if sr != fe.sample_rate:
                pcm = np.asarray(_resample(jnp.asarray(pcm), sr, fe.sample_rate))
            out.append(np.asarray(pcm, np.float32))
        return out, fe.sample_rate

    def _prepare_audio(self, audio, sample_rate):
        fe = self.config.frontend
        audios, _ = self._collect_audio(audio, sample_rate)
        batch = np.stack([features.pad_or_trim(a, fe) for a in audios])
        lens = np.asarray(
            [min(len(a), batch.shape[1]) for a in audios], dtype=np.int32
        )
        return batch, lens
