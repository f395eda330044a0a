#!/usr/bin/env python3
"""Smoke run of the ASR main path on one GPU, at the published model widths.

    python3 chip_smoke.py               # one card: phases 0-4
    python3 chip_smoke.py --four-cards  # four cards: the mesh paths only

Weights and audio are drawn from --seed. Phases, each through the package's
own entry points (ModelBundle, featurize_batch, train/engine.py,
decode/whisper_generate.py, serve/engine.ServingEngine):

0. environment: devices, the card's name and power limit, JAX version,
   XLA_FLAGS, the compile-cache directory, optional packages;
1. flagship transformer-CTC offline transcription, 32 x 30 s;
2. flagship WF-adapter fine-tune, 16 x 10 s, with a checkpoint round trip;
3. whisper-large-v3: encode + greedy generate in bf16 and int8, one
   adapter fine-tune step at 4 x 30 s with remat, and the serving engine
   over requests of mixed durations;
4. comparisons with the plain references: attention at both widths
   (forward and gradients), model outputs against float32 at HIGHEST
   precision, int8 decoder logits against bf16, log-mel against numpy.

Every phase prints its result and its compile and run seconds. The last
line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}};
without a GPU, or when any phase fails, the script exits non-zero and
prints no such line. --whisper-layers cuts large-v3's depth (not its
widths) for a quicker run.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Tuple

import numpy as np

# --------------------------------------------------------------------------
# Tolerances, each with its reason.
# --------------------------------------------------------------------------

# bf16 attention (inputs rounded to 8 mantissa bits, probabilities rounded
# to bf16 before the value product) against a float32 einsum: the relative
# Frobenius error of one such op is a few units of bf16 roundoff (2^-8 =
# 3.9e-3), so 1e-2 forward; gradients chain two more bf16 products, 2e-2.
ATTN_FWD_TOL = 1e-2
ATTN_GRAD_TOL = 2e-2
# a bf16 forward through a deep pre-LN stack against float32 at HIGHEST:
# each layer adds rounding of order 4e-3 to the residual stream, and
# independent errors add roughly in quadrature, ~sqrt(64) * 4e-3 = 3e-2 for
# the 32+32-layer large-v3; 5e-2 leaves room for correlated error.
MODEL_TOL = 5e-2
# int8 decoder (weights, KV caches, tied logits) vs bf16: the bounds of
# tests/test_quant.py::test_bundle_quantize_decoder_logit_fidelity, over
# 2 x 32 teacher-forced positions.
INT8_MIN_COSINE = 0.999
INT8_MIN_TOP1_AGREE = 0.9
# log-mel parity bar of tests/test_frontend.py (normalized log-mel units)
LOGMEL_TOL = 2e-4


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Model configurations and workload shapes of one smoke run."""

    ctc: object  # CTCModelConfig
    whisper: object  # WhisperConfig
    offline_batch: int = 32
    offline_secs: float = 30.0
    ft_batch: int = 16
    ft_secs: float = 10.0
    ft_steps: int = 3
    window_secs: float = 30.0
    w_train_batch: int = 4
    gen_tokens: int = 32
    serve_secs: Tuple[float, ...] = (3.0, 30.0, 7.5, 12.0, 4.0, 22.0, 16.0, 9.0)
    # attention comparison shapes (B, T, H, dh): flagship, large-v3
    attn_shapes: Tuple[Tuple[int, int, int, int], ...] = (
        (8, 750, 4, 128), (4, 1500, 20, 64),
    )
    compare_batch: int = 2


def full_sizes(whisper_layers: int = 0) -> Sizes:
    """The flagship and whisper-large-v3 at their published widths."""
    from jiao_liao_asr.utils.config import (
        CTCModelConfig, whisper_preset,
    )

    w = whisper_preset("large-v3")
    if whisper_layers:
        w = dataclasses.replace(
            w, encoder_layers=whisper_layers, decoder_layers=whisper_layers
        )
    return Sizes(ctc=CTCModelConfig(), whisper=w)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def check(name: str, err: float, bound: float) -> None:
    log(f"  compare {name}: rel_err={err:.3e} bound={bound:.1e}")
    if not err <= bound:
        raise AssertionError(f"{name}: error {err:.3e} over bound {bound:.1e}")


def timed(fn: Callable, *args):
    """(result, seconds) with the device work finished."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def twice(fn: Callable, *args):
    """Run fn twice: the first call compiles. Returns (result, compile_s,
    run_s), compile_s being the first call's extra time over the second."""
    _, first = timed(fn, *args)
    out, run = timed(fn, *args)
    return out, max(first - run, 0.0), run


def wavs_from_seed(seed: int, batch: int, secs: float, sr: int = 16000):
    rng = np.random.RandomState(seed)
    n = int(secs * sr)
    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * rng.uniform(150, 900, (batch, 1)) * t[None, :])
    return (0.1 * tone + 0.05 * rng.randn(batch, n)).astype(np.float32)


def peak_gb() -> float:
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2**30


def describe_choices(seen) -> str:
    return "; ".join(
        f"{impl} q{q} k{k} {form}" for impl, q, k, form in sorted(set(seen))
    )


def char_tokenizer(vocab_size: int):
    from jiao_liao_asr.data.tokenizer import CharTokenizer

    return CharTokenizer([chr(0x4E00 + i) for i in range(vocab_size - 2)])


# --------------------------------------------------------------------------
# Phase 0
# --------------------------------------------------------------------------


def card_name_and_limit() -> str:
    """nvidia-smi's name and power limit, read by a child that never
    imports JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    return r.stdout.strip() or f"unavailable (rc={r.returncode})"


def phase_environment() -> Dict:
    """Print the environment; return the device as JAX reports it."""
    import jax

    devices = jax.devices()
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    log(f"devices: {device}")
    log(f"card: {card_name_and_limit()}")
    from jiao_liao_asr.utils.compile_cache import (
        enable_compile_cache,
    )

    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {enable_compile_cache()}")
    for mod in ("flax", "orbax.checkpoint", "yaml", "jieba"):
        try:
            version = getattr(importlib.import_module(mod), "__version__", "?")
        except ImportError:
            version = "absent"
        log(f"package {mod}: {version}")
    return device


# --------------------------------------------------------------------------
# Phase 1: flagship offline transcription
# --------------------------------------------------------------------------


def ctc_experiment(ctc_cfg):
    from jiao_liao_asr.utils.config import (
        ExperimentConfig, FrontendConfig,
    )

    return ExperimentConfig(
        model_family="ctc", ctc_model=ctc_cfg,
        frontend=FrontendConfig(num_mels=ctc_cfg.num_mels),
    )


def phase_offline(sz: Sizes, seed: int) -> Dict:
    import jax.numpy as jnp

    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.models.bundle import ModelBundle

    cfg = ctc_experiment(sz.ctc)
    bundle = ModelBundle(
        config=cfg, params=ModelBundle._init_params(cfg, seed),
        tokenizer=char_tokenizer(sz.ctc.vocab_size),
    )
    wavs = wavs_from_seed(seed, sz.offline_batch, sz.offline_secs)
    texts, compile_s, run_s = twice(bundle.transcribe, list(wavs))
    feats = featurize_batch(jnp.asarray(wavs), cfg.frontend)
    flens = jnp.full((wavs.shape[0],), feats.shape[-1], jnp.int32)
    log_probs, out_lens = bundle.encode(feats, flens)
    assert len(texts) == sz.offline_batch
    assert np.all(np.isfinite(np.asarray(log_probs)))
    log(f"  audio {wavs.shape} -> log-mel {tuple(feats.shape)} -> log-probs "
        f"{tuple(log_probs.shape)}; {len(texts)} texts, first "
        f"{len(texts[0])} chars")
    log(f"  peak device memory {peak_gb():.2f} GiB")
    return {"compile_s": compile_s, "run_s": run_s}


# --------------------------------------------------------------------------
# Phase 2: flagship adapter fine-tune + checkpoint round trip
# --------------------------------------------------------------------------


def ctc_batches(rng, n: int, batch: int, secs: float, vocab: int, labels: int = 24):
    import jax.numpy as jnp

    samples = int(secs * 16000)
    return [{
        "audio": jnp.asarray(rng.randn(batch, samples).astype(np.float32) * 0.1),
        "audio_lengths": jnp.full((batch,), samples, jnp.int32),
        "labels": jnp.asarray(rng.randint(1, vocab, (batch, labels)).astype(np.int32)),
        "label_lengths": jnp.full((batch,), labels, jnp.int32),
    } for _ in range(n)]


def split_adapter(params):
    """(adapter leaves, backbone leaves) as {path: array} dicts."""
    import jax

    from jiao_liao_asr.models.adapters import param_is_adapter
    from jiao_liao_asr.train.checkpoints import path_key

    ad, bb = {}, {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = tuple(str(getattr(k, "key", k)) for k in kp)
        (ad if param_is_adapter(names) else bb)[path_key(kp)] = np.asarray(leaf)
    return ad, bb


def phase_finetune(sz: Sizes, seed: int) -> Dict:
    import jax

    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.train.checkpoints import TrainCheckpointer
    from jiao_liao_asr.train.engine import (
        build_train_setup, init_state,
    )
    from jiao_liao_asr.utils.config import AdapterConfig

    cfg = ctc_experiment(
        dataclasses.replace(sz.ctc, adapter=AdapterConfig(kind="wf", wf_rank=8))
    )
    cfg.train.train_adapters_only = True
    cfg.train.optimizer.schedule = "constant"  # the first step moves params
    params = ModelBundle._init_params(cfg, seed)
    ad0, bb0 = split_adapter(params)
    _, _, tx, step = build_train_setup(cfg, params)
    state = init_state(cfg, tx, params, seed)
    batches = ctc_batches(np.random.RandomState(seed), 2, sz.ft_batch, sz.ft_secs,
                          sz.ctc.vocab_size)
    (state, metrics), first = timed(step, state, batches[0])
    t0 = time.perf_counter()
    losses = [float(metrics["loss"])]
    for i in range(1, sz.ft_steps):
        state, metrics = step(state, batches[i % len(batches)])
        losses.append(float(metrics["loss"]))
    run_s = (time.perf_counter() - t0) / max(sz.ft_steps - 1, 1)
    assert all(np.isfinite(losses)), losses
    ad1, bb1 = split_adapter(state.params)
    assert all(np.array_equal(bb0[k], bb1[k]) for k in bb0), "backbone moved"
    changed = sum(not np.array_equal(ad0[k], ad1[k]) for k in ad0)
    assert changed > 0, "no adapter param changed"
    with tempfile.TemporaryDirectory() as td:
        ck = TrainCheckpointer(td, keep=1)
        ck.save(sz.ft_steps, state, {"smoke": True})
        step_no, restored, extra = ck.restore(state)
    same = jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b))),
        state, restored,
    ))
    assert step_no == sz.ft_steps and same and extra == {"smoke": True}
    log(f"  losses {[round(x, 4) for x in losses]}; backbone bit-identical; "
        f"{changed}/{len(ad0)} adapter leaves changed; checkpoint round trip exact")
    log(f"  peak device memory {peak_gb():.2f} GiB")
    return {"compile_s": max(first - run_s, 0.0), "run_s": run_s}


# --------------------------------------------------------------------------
# Phase 3: whisper-large-v3
# --------------------------------------------------------------------------


def whisper_experiment(wcfg, window_secs: float = 30.0):
    from jiao_liao_asr.utils.config import (
        ExperimentConfig, FrontendConfig,
    )

    cfg = ExperimentConfig(
        model_family="whisper", whisper=wcfg,
        frontend=FrontendConfig(num_mels=wcfg.num_mels, chunk_seconds=window_secs),
    )
    cfg.decode.max_decode_len = 32
    return cfg


def whisper_bundle(sz: Sizes, seed: int):
    from jiao_liao_asr.models.bundle import ModelBundle

    cfg = whisper_experiment(sz.whisper, sz.window_secs)
    return ModelBundle(
        config=cfg, params=ModelBundle._init_params(cfg, seed),
        tokenizer=char_tokenizer(min(sz.whisper.vocab_size, 4096)),
    )


def generate_fn(bundle, sz: Sizes):
    import jax

    from jiao_liao_asr.decode.whisper_generate import (
        greedy_generate, resolve_specials,
    )
    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.models.whisper import WhisperModel

    model = WhisperModel(bundle.config.whisper)
    prompt, eot = resolve_specials(bundle.config.whisper)
    fe = bundle.config.frontend

    @jax.jit
    def run(params, wav):
        mel = featurize_batch(wav, fe)
        return greedy_generate(
            model, params, mel, max_len=len(prompt) + sz.gen_tokens,
            prompt=prompt, eot_id=eot,
        )

    return run


def phase_whisper_generate(sz: Sizes, seed: int, bundle) -> Dict:
    import jax.numpy as jnp

    wav = jnp.asarray(wavs_from_seed(seed + 1, 1, sz.window_secs))
    run = generate_fn(bundle, sz)
    (ids, n), compile_s, run_s = twice(run, bundle.params, wav)
    qbundle = bundle.quantize()
    (qids, qn), qcompile_s, qrun_s = twice(run, qbundle.params, wav)
    del qbundle
    for name, a, length in (("bf16", ids, n), ("int8", qids, qn)):
        a = np.asarray(a)
        assert a.ndim == 2 and a.shape[0] == 1, a.shape
        assert 0 < int(np.asarray(length)[0]) <= a.shape[1]
        assert a.min() >= 0 and a.max() < sz.whisper.vocab_size
        log(f"  {name}: ids {a.shape}, {int(np.asarray(length)[0])} tokens")
    log(f"  int8: compile {qcompile_s:.1f}s run {qrun_s:.2f}s")
    log(f"  peak device memory {peak_gb():.2f} GiB")
    return {"compile_s": compile_s, "run_s": run_s}


def whisper_train_batch(rng, sz: Sizes, vocab: int, batch: int, tokens: int = 24):
    import jax.numpy as jnp

    samples = int(sz.window_secs * 16000)
    toks = rng.randint(0, vocab, (batch, tokens)).astype(np.int32)
    return {
        "audio": jnp.asarray(rng.randn(batch, samples).astype(np.float32) * 0.1),
        "audio_lengths": jnp.full((batch,), samples, jnp.int32),
        "labels": jnp.asarray(toks),
        "label_lengths": jnp.full((batch,), tokens, jnp.int32),
        "tokens": jnp.asarray(toks),
        "targets": jnp.asarray(np.roll(toks, -1, 1)),
    }


def whisper_adapter_setup(sz: Sizes, seed: int, mesh=None):
    """(config, params, jitted step, tx) for the large-v3 WF-adapter
    fine-tune with remat, the step for inputs on `mesh` if given."""
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.train.engine import build_train_setup
    from jiao_liao_asr.utils.config import AdapterConfig

    cfg = whisper_experiment(dataclasses.replace(
        sz.whisper, remat=True, adapter=AdapterConfig(kind="wf", wf_rank=8)
    ), sz.window_secs)
    cfg.train.train_adapters_only = True
    cfg.train.optimizer.schedule = "constant"  # the first step moves params
    params = ModelBundle._init_params(cfg, seed)
    _, _, tx, step = build_train_setup(cfg, params, mesh)
    return cfg, params, step, tx


def phase_whisper_train(sz: Sizes, seed: int) -> Dict:
    from jiao_liao_asr.train.engine import init_state

    cfg, params, step, tx = whisper_adapter_setup(sz, seed)
    ad0, _ = split_adapter(params)
    state = init_state(cfg, tx, params, seed)
    del params
    batch = whisper_train_batch(
        np.random.RandomState(seed), sz, sz.whisper.vocab_size, sz.w_train_batch
    )
    (state, metrics), first = timed(step, state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    ad1, _ = split_adapter(state.params)
    changed = sum(not np.array_equal(ad0[k], ad1[k]) for k in ad0)
    assert changed > 0
    log(f"  adapter step at {sz.w_train_batch} x {sz.window_secs:.0f} s with "
        f"remat: loss {loss:.4f}, {changed}/{len(ad0)} adapter leaves changed")
    log(f"  peak device memory {peak_gb():.2f} GiB")
    return {"compile_s": first, "run_s": None}


def phase_whisper_serve(sz: Sizes, seed: int, bundle) -> Dict:
    from jiao_liao_asr.serve.engine import ServingEngine

    rng = np.random.RandomState(seed + 2)
    reqs = [wavs_from_seed(int(rng.randint(1 << 30)), 1, s)[0] for s in sz.serve_secs]
    eng = ServingEngine(bundle, slots=8, max_len=bundle.config.decode.max_decode_len)
    t0 = time.perf_counter()
    texts = eng.transcribe(reqs)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    texts = eng.transcribe(reqs)
    run_s = time.perf_counter() - t0
    assert len(texts) == len(reqs)
    s = eng.stats
    log(f"  {len(reqs)} requests of {min(sz.serve_secs):g}-"
        f"{max(sz.serve_secs):g} s, served twice: {s.completed} completed, "
        f"{s.decode_steps} decode steps, {s.dispatches} dispatches")
    log(f"  peak device memory {peak_gb():.2f} GiB")
    return {"compile_s": max(first - run_s, 0.0), "run_s": run_s}


# --------------------------------------------------------------------------
# Phase 4: comparisons with the plain references
# --------------------------------------------------------------------------


def compare_attention(shape, seed: int) -> None:
    """The chosen implementation (layers.dot_product_attention) vs a
    float32 einsum reference at HIGHEST precision: forward and gradients
    with respect to q, k and v, with ragged key lengths."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.models import layers

    B, T, H, dh = shape
    rng = np.random.RandomState(seed)
    q, k, v = (jnp.asarray(rng.randn(B, T, H, dh), jnp.bfloat16) for _ in range(3))
    lens = jnp.asarray(rng.randint(T // 2, T + 1, B).astype(np.int32)).at[0].set(T)
    probe = jnp.asarray(rng.randn(B, T, H, dh), jnp.float32)

    def chosen(q, k, v):
        out = layers.dot_product_attention(q, k, v, kv_lengths=lens)
        return jnp.sum(out.astype(jnp.float32) * probe), out

    def reference(q, k, v):
        mask = layers.length_mask(lens, T)
        out = layers.reference_attention(q, k, v, mask)
        return jnp.sum(out * probe), out

    with layers.record_attention_choices() as seen:
        got_g, got = jax.jit(jax.grad(chosen, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    f32 = [a.astype(jnp.float32) for a in (q, k, v)]
    with jax.default_matmul_precision("highest"):
        want_g, want = jax.jit(
            jax.grad(reference, argnums=(0, 1, 2), has_aux=True)
        )(*f32)
    log(f"  attention {shape}: {describe_choices(seen)}")
    check(f"attention{shape} forward", rel_err(got, want), ATTN_FWD_TOL)
    for name, a, b in zip("qkv", got_g, want_g):
        check(f"attention{shape} d{name}", rel_err(a, b), ATTN_GRAD_TOL)


def compare_flagship(sz: Sizes, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.models.ctc_model import CTCEncoderModel

    cfg = ctc_experiment(sz.ctc)
    params = ModelBundle._init_params(cfg, seed)
    wav = jnp.asarray(wavs_from_seed(seed + 3, sz.compare_batch, sz.offline_secs))
    feats = featurize_batch(wav, cfg.frontend)
    lens = jnp.asarray([feats.shape[-1], feats.shape[-1] * 2 // 3], jnp.int32)[
        : sz.compare_batch
    ]
    got, out_lens = jax.jit(lambda p, f, l: CTCEncoderModel(sz.ctc).apply(
        {"params": p}, f, l))(params, feats, lens)
    ref_model = CTCEncoderModel(dataclasses.replace(sz.ctc, dtype="float32"))
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda p, f, l: ref_model.apply({"params": p}, f, l))(
            params, feats, lens)
    valid = np.arange(got.shape[1])[None, :] < np.asarray(out_lens)[:, None]
    check("flagship log-probs (valid frames)",
          rel_err(np.asarray(got)[valid], np.asarray(want)[valid]), MODEL_TOL)


def compare_whisper(sz: Sizes, seed: int, bundle) -> None:
    """large-v3 encoder output and first-step decoder logits, bf16 vs
    float32 at HIGHEST; int8 decoder logits vs bf16."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.decode.whisper_generate import (
        resolve_specials,
    )
    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.models.whisper import WhisperModel

    wcfg = bundle.config.whisper
    wav = jnp.asarray(wavs_from_seed(seed + 4, 1, sz.window_secs))
    mel = featurize_batch(wav, bundle.config.frontend)
    prompt, _ = resolve_specials(wcfg)
    toks = jnp.asarray([list(prompt)], jnp.int32)

    def forward(model):
        def f(p, mel, toks):
            enc = model.apply({"params": p}, mel, method=model.encode)
            logits = model.apply({"params": p}, toks, enc, method=model.decode)
            return enc, logits[:, -1]
        return jax.jit(f)

    enc, logits = forward(WhisperModel(wcfg))(bundle.params, mel, toks)
    ref = WhisperModel(dataclasses.replace(wcfg, dtype="float32"))
    with jax.default_matmul_precision("highest"):
        enc_ref, logits_ref = forward(ref)(bundle.params, mel, toks)
    check("large-v3 encoder output", rel_err(enc, enc_ref), MODEL_TOL)
    check("large-v3 first-step logits", rel_err(logits, logits_ref), MODEL_TOL)

    qparams = bundle.quantize().params
    model = WhisperModel(wcfg)
    rng = np.random.RandomState(seed + 5)
    steps = jnp.asarray(rng.randint(0, wcfg.vocab_size, (2, 32)).astype(np.int32))
    mel2 = jnp.concatenate([mel, mel[:, :, ::-1]], axis=0)
    teacher = jax.jit(lambda p, m, t: model.apply({"params": p}, m, t))
    ref = np.asarray(teacher(bundle.params, mel2, steps), np.float32)
    got = np.asarray(teacher(qparams, mel2, steps), np.float32)
    del qparams
    cos, agree = int8_agreement(got, ref)
    log(f"  compare int8 vs bf16 decoder logits over {ref.shape[0] * ref.shape[1]} "
        f"positions: cosine={cos:.6f} (min {INT8_MIN_COSINE}), top-1 agreement="
        f"{agree:.3f} (min {INT8_MIN_TOP1_AGREE})")
    if not (cos > INT8_MIN_COSINE and agree >= INT8_MIN_TOP1_AGREE):
        raise AssertionError(f"int8 logits: cosine {cos}, top-1 agreement {agree}")


def int8_agreement(got: np.ndarray, ref: np.ndarray):
    """(cosine, top-1 agreement rate) of int8 logits `got` against bf16
    logits `ref` [..., V]."""
    cos = float((ref * got).sum() / (np.linalg.norm(ref) * np.linalg.norm(got)))
    return cos, float((got.argmax(-1) == ref.argmax(-1)).mean())


def compare_frontend(seed: int, num_mels: int) -> None:
    import jax.numpy as jnp

    from jiao_liao_asr.frontend.features import (
        featurize_batch, log_mel_reference,
    )
    from jiao_liao_asr.utils.config import FrontendConfig

    fe = FrontendConfig(num_mels=num_mels)
    wav = wavs_from_seed(seed + 6, 2, 30.0)
    got = np.asarray(featurize_batch(jnp.asarray(wav), fe))
    want = log_mel_reference(wav, fe)
    err = float(np.abs(got - want).max())
    log(f"  compare log-mel ({num_mels} mels): max_abs_err={err:.3e} "
        f"bound={LOGMEL_TOL:.0e}")
    if not err <= LOGMEL_TOL:
        raise AssertionError(f"log-mel error {err} over {LOGMEL_TOL}")


def phase_compare(sz: Sizes, seed: int, bundle) -> Dict:
    t0 = time.perf_counter()
    for i, shape in enumerate(sz.attn_shapes):
        compare_attention(shape, seed + 10 + i)
    compare_flagship(sz, seed)
    compare_whisper(sz, seed, bundle)
    compare_frontend(seed, sz.ctc.num_mels)
    compare_frontend(seed, sz.whisper.num_mels)
    return {"compile_s": None, "run_s": time.perf_counter() - t0}


# --------------------------------------------------------------------------
# Four cards
# --------------------------------------------------------------------------


# Tolerances of the four-card comparisons. The model computes in bf16, and
# on a mesh its sums over batch and features run in another order: the
# loss to 1e-3 relative; the adapter gradient (read from Adam's first
# moment, which after one step is (1 - b1) times the clipped gradient) to
# 5e-2 relative over all adapter params together. Adam's first step moves
# each param by about lr * sign(g), so an element whose gradient is within
# rounding of zero can move the other way: at least 95% of the adapter
# updates must agree in sign (a gradient not summed over all cards' rows
# agrees on far fewer).
MESH_LOSS_TOL = 1e-3
MESH_GRAD_TOL = 5e-2
MESH_MIN_SIGN_AGREE = 0.95


def adapter_leaves(params):
    return split_adapter(params)[0]


def adapter_first_moment(opt_state) -> Dict[str, np.ndarray]:
    """Adam's first moment of each adapter param, keyed by param path."""
    import jax

    from jiao_liao_asr.models.adapters import param_is_adapter

    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = tuple(
            str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k))))
            for k in kp
        )
        if "mu" in names and param_is_adapter(names):
            out["/".join(names[names.index("mu") + 1:])] = np.asarray(leaf, np.float32)
    return out


def step_summary(ad0: Dict[str, np.ndarray], state, metrics) -> Dict:
    """What one adapter step did: its loss, the adapter gradient's first
    moment and the adapter update, each flattened in path order."""
    ad1 = adapter_leaves(state.params)
    mu = adapter_first_moment(state.opt_state)
    keys = sorted(ad0)
    return {
        "loss": float(metrics["loss"]),
        "moment": np.concatenate([mu[k].ravel() for k in sorted(mu)]),
        "update": np.concatenate([(ad1[k] - ad0[k]).ravel() for k in keys]),
    }


def state_gb_per_device(tree) -> list:
    """GiB of the tree's array shards held by each device, in device order:
    a mesh that left everything on device 0 shows as one large entry."""
    import jax

    held = {d: 0 for d in jax.devices()}
    for leaf in jax.tree_util.tree_leaves(tree):
        for shard in getattr(leaf, "addressable_shards", ()):
            held[shard.device] += shard.data.nbytes
    return [b / 2**30 for b in held.values()]


def phase_mesh_train(sz: Sizes, seed: int, mesh_cfg, single: Dict) -> Dict:
    """One large-v3 adapter step on a mesh against the same step on one
    card (`single`, a step_summary)."""
    from jiao_liao_asr.parallel.mesh import (
        build_mesh, shard_batch, shard_state,
    )
    from jiao_liao_asr.train.engine import init_state

    mesh = build_mesh(mesh_cfg)
    cfg, params, step, tx = whisper_adapter_setup(sz, seed, mesh)
    ad0 = adapter_leaves(params)
    state = shard_state(mesh, init_state(cfg, tx, params, seed))
    del params
    batch = shard_batch(mesh, whisper_train_batch(
        np.random.RandomState(seed), sz, sz.whisper.vocab_size, sz.w_train_batch))
    (state, metrics), first = timed(step, state, batch)
    got = step_summary(ad0, state, metrics)
    per_dev = state_gb_per_device(state)
    name = f"mesh {dict(mesh.shape)}"
    log(f"  {name}: loss {got['loss']:.6f}; train state per card "
        f"{[round(x, 3) for x in per_dev]} GiB")
    check(f"{name} loss", abs(got["loss"] - single["loss"]) / abs(single["loss"]),
          MESH_LOSS_TOL)
    check(f"{name} adapter gradient", rel_err(got["moment"], single["moment"]),
          MESH_GRAD_TOL)
    agree = float(np.mean(np.sign(got["update"]) == np.sign(single["update"])))
    log(f"  {name} adapter update sign agreement {agree:.5f} "
        f"(min {MESH_MIN_SIGN_AGREE})")
    if agree < MESH_MIN_SIGN_AGREE:
        raise AssertionError(f"{name}: update sign agreement {agree}")
    if max(per_dev) > 2.5 * max(min(per_dev), 1e-6):
        raise AssertionError(f"unbalanced placement across cards: {per_dev}")
    return {"compile_s": first, "run_s": None}


def four_cards(sz: Sizes, seed: int) -> None:
    import jax

    from jiao_liao_asr.train.engine import init_state
    from jiao_liao_asr.utils.config import MeshConfig

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, JAX sees {len(jax.devices())}")
    # the reference: the same step on card 0 alone
    cfg, params, step, tx = whisper_adapter_setup(sz, seed)
    ad0 = adapter_leaves(params)
    state = init_state(cfg, tx, params, seed)
    del params
    batch = whisper_train_batch(
        np.random.RandomState(seed), sz, sz.whisper.vocab_size, sz.w_train_batch)
    state, metrics = step(state, batch)
    single = step_summary(ad0, state, metrics)
    del state, step
    log(f"  one card: loss {single['loss']:.6f}")
    run_phase("mesh data2 x fsdp2", phase_mesh_train, sz, seed,
              MeshConfig(data_axis=2, fsdp_axis=2, model_axis=1), single)
    run_phase("mesh fsdp2 x model2", phase_mesh_train, sz, seed,
              MeshConfig(data_axis=1, fsdp_axis=2, model_axis=2), single)
    run_phase("sharded inference", phase_sharded_inference, sz, seed)


def phase_sharded_inference(sz: Sizes, seed: int) -> Dict:
    """ModelBundle.shard() (Megatron TP over 'model' + batch over 'data'):
    encode, greedy generate and teacher-forced decoder logits against the
    same bundle on one card. Greedy text is printed, not bounded: with
    random weights a near tie flips one token and the rest of the sequence
    follows it, so the logits carry the check."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.parallel.mesh import shard_batch
    from jiao_liao_asr.utils.config import MeshConfig

    bundle = whisper_bundle(sz, seed)
    wav = jnp.asarray(wavs_from_seed(seed + 1, 4, sz.window_secs))
    mel = featurize_batch(wav, bundle.config.frontend)
    run = generate_fn(bundle, sz)
    model = bundle._model(bundle.config)
    enc = jax.jit(lambda p, m: model.apply({"params": p}, m, method="encode"))
    teacher = jax.jit(lambda p, m, t: model.apply({"params": p}, m, t))
    ids1 = np.asarray(run(bundle.params, wav)[0])
    toks = jnp.asarray(ids1, jnp.int32)
    enc1 = np.asarray(enc(bundle.params, mel), np.float32)
    logits1 = np.asarray(teacher(bundle.params, mel, toks), np.float32)
    bundle.config.mesh = MeshConfig(data_axis=2, fsdp_axis=1, model_axis=2)
    bundle.shard()  # in place: params now sharded over the mesh
    # traced under the mesh, as the bundle's own entry points are, so
    # attention runs per shard
    with jax.set_mesh(bundle.mesh):
        (ids4, _), first = timed(run, bundle.params, shard_batch(bundle.mesh, wav))
        mel4 = shard_batch(bundle.mesh, mel)
        enc4 = enc(bundle.params, mel4)
        logits4 = teacher(bundle.params, mel4, shard_batch(bundle.mesh, toks))
    ids4 = np.asarray(ids4)
    assert ids4.shape == ids1.shape and ids4.min() >= 0
    log(f"  ModelBundle.shard() {dict(bundle.mesh.shape)}: greedy token "
        f"agreement with one card {float((ids4 == ids1).mean()):.3f}")
    check("sharded encoder output", rel_err(enc4, enc1), MODEL_TOL)
    check("sharded teacher-forced decoder logits", rel_err(logits4, logits1), MODEL_TOL)
    return {"compile_s": first, "run_s": None}


# --------------------------------------------------------------------------


def run_phase(name: str, fn: Callable, *args):
    """Run one phase: its result line with compile and run seconds, and the
    attention implementation each call site traced inside it chose."""
    from jiao_liao_asr.models.layers import record_attention_choices

    log(f"phase {name}: start")
    t0 = time.perf_counter()
    with record_attention_choices() as seen:
        out = fn(*args)
    if seen:
        log(f"  attention: {describe_choices(seen)}")
    fmt = lambda x: "n/a" if x is None else f"{x:.1f}s"  # noqa: E731
    log(f"phase {name}: ok compile={fmt(out.get('compile_s'))} "
        f"run={fmt(out.get('run_s'))} total={time.perf_counter() - t0:.1f}s")
    return out


def run_one_card(sz: Sizes, seed: int) -> None:
    run_phase("1 flagship offline transcription", phase_offline, sz, seed)
    run_phase("2 flagship adapter fine-tune", phase_finetune, sz, seed)
    bundle = whisper_bundle(sz, seed)
    run_phase("3a large-v3 generate bf16/int8", phase_whisper_generate, sz, seed, bundle)
    run_phase("3b large-v3 adapter step", phase_whisper_train, sz, seed)
    run_phase("3c large-v3 serving engine", phase_whisper_serve, sz, seed, bundle)
    run_phase("4 comparisons", phase_compare, sz, seed, bundle)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh paths and their comparisons")
    ap.add_argument("--whisper-layers", type=int, default=0,
                    help="cut large-v3 to this many encoder and decoder layers")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = run_phase("0 environment", lambda: {"device": phase_environment()})["device"]
    if device["platform"] != "gpu":
        log(f"no GPU: JAX's default backend is {device['platform']!r}")
        return 1
    sz = full_sizes(args.whisper_layers)
    if args.four_cards:
        four_cards(sz, args.seed)
    else:
        run_one_card(sz, args.seed)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
