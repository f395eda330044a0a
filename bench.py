"""Benchmark: the flagship transformer-CTC and whisper-large-v3 on one card.

Sections, in order (each a function returning its fields):
- bench_rtfx: greedy RTFx (audio-seconds per wall-clock second per card),
  batch 128 x 30 s: frontend -> encoder -> CTC head argmax -> collapse.
- bench_adapter_finetune: the production jitted train step (frozen
  backbone + WF adapters, on-device featurize + SpecAugment + CTC loss),
  batch 16 x 10 s, steps/sec.
- bench_beam_rtfx: CTC prefix beam (native C++ on the host) over the
  device's top-k posteriors, exact and pruned.
- bench_parity: greedy text on the card vs a CPU-JAX child, byte-equal.
- bench_bucketed_rtfx: a mixed-length corpus through the production
  BatchIterator.
- bench_large_v3_adapter / bench_large_v3_decode: whisper-large-v3 adapter
  fine-tune steps/sec and int8-serving greedy decode tokens/sec.
- bench_quality_ordering: the synthetic adapter-transfer protocol (a CPU
  child; accuracy, not speed).

Everything runs in ONE process: a JAX process reserves most of the card's
memory when it first touches it, so a second process on the card would
fail. The CPU children (parity, quality) run with JAX_PLATFORMS=cpu and
never open the card. A section that fails leaves its fields null, records
its error under "errors", and makes the exit code non-zero.

Output: after every section, one cumulative JSON line (same keys each time,
nulls for sections not yet run) with the device it ran on:
  {"metric": "rtfx", "value": N, ..., "device": {"platform": "gpu",
   "kind": "...", "count": 1}, "errors": {...}}
vs_baseline is measured RTFx / 200 (the >=200x real-time target,
BASELINE.md; the reference publishes no throughput numbers).

Flags: --no-beam / --no-parity / --no-bucketed / --no-large / --no-quality
skip sections. With no GPU the script exits non-zero before any section.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_FLAGSHIP_VOCAB = 4336


def _flagship(vocab: int = _FLAGSHIP_VOCAB):
    from jiao_liao_asr.models.ctc_model import CTCEncoderModel
    from jiao_liao_asr.utils.config import (
        CTCModelConfig,
        FrontendConfig,
    )

    fe = FrontendConfig()
    cfg = CTCModelConfig(vocab_size=vocab)
    return CTCEncoderModel(cfg), cfg, fe


def _init_flagship_params(model, fe, seed: int = 0):
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.frontend.features import (
        log_mel_spectrogram,
    )

    wav = jnp.asarray(
        np.random.RandomState(0).randn(1, fe.sample_rate).astype(np.float32) * 0.1
    )
    feats0 = log_mel_spectrogram(wav, fe)
    return model.init(
        jax.random.PRNGKey(seed), feats0, jnp.asarray([fe.sample_rate // fe.hop_length])
    )["params"]


def _peak_gb() -> float:
    """Peak device memory in use so far, GiB (memory_stats on the card)."""
    import jax

    return round(jax.local_devices()[0].memory_stats()["peak_bytes_in_use"] / 2**30, 2)


def bench_rtfx() -> dict:
    """Headline greedy RTFx: frontend + encoder + head argmax + on-device
    collapse, batch 128 x 30 s, two buffers in flight."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.decode.ctc import ctc_greedy_collapse
    from jiao_liao_asr.frontend.features import featurize_batch

    model, cfg, fe = _flagship()
    secs, batch = 30.0, 128
    samples = int(secs * fe.sample_rate)
    rng = np.random.RandomState(0)
    wav = jnp.asarray(rng.randn(batch, samples).astype(np.float32) * 0.1)
    lengths = jnp.full((batch,), samples, jnp.int32)
    params = _init_flagship_params(model, fe)

    @jax.jit
    def infer(params, wav, lengths):
        feats = featurize_batch(wav, fe)
        ids, out_lens = model.apply(
            {"params": params}, feats, lengths // fe.hop_length,
            deterministic=True, head_mode="argmax_ids",
        )
        return ctc_greedy_collapse(ids, out_lens)

    # distinct input batches, each warmed once before the timed window
    wavs = [jnp.roll(wav, i + 1, axis=0) + 1e-4 * (i + 1) for i in range(2)]
    jax.block_until_ready(wavs)
    for w in wavs:
        out = infer(params, w, lengths)
        _ = int(np.asarray(out[1]).sum())

    iters = 10
    t0 = time.perf_counter()
    prev = None
    for i in range(iters):
        # two batches in flight: sync batch i-1 while i executes — hides the
        # fixed per-dispatch latency without ever skipping an execution
        ids, n = infer(params, wavs[i % len(wavs)], lengths)
        if prev is not None:
            _ = int(np.asarray(prev).sum())
        prev = n
    _ = int(np.asarray(prev).sum())
    dt = time.perf_counter() - t0
    rtfx = secs * batch * iters / dt
    return {"value": round(rtfx, 2), "vs_baseline": round(rtfx / 200.0, 3)}


def bench_beam_rtfx() -> dict:
    """Prefix-beam decode RTFx (BASELINE configs[1] as written): device runs
    encoder + log_softmax + per-frame top-k pruning; the C++ engine
    (native/beam.cpp) runs the beam multithreaded across utterances while
    the chip works on the NEXT batch (1-deep software pipeline).

    Measured on a briefly-TRAINED model: deployed CTC models emit peaked,
    blank-dominated posteriors, where most frames collapse to the engine's
    O(beams) blank-only update — random-init near-uniform rows would
    overstate the per-frame beam cost by orders of magnitude.

    Benched at BOTH pruning settings: the production
    default (DecodeConfig.beam_prune_logp) AND the -10.0-nats pruned beam,
    with a per-run assertion that the two emit byte-identical ids on the
    bench model — the recorded numbers can't silently depend on an
    accuracy-relevant knob. Returns {"beam_rtfx": <at production default>,
    "beam_rtfx_pruned": <at -10>, "beam_prune_text_equal": bool}."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.decode.ctc import ctc_topk_posteriors
    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.utils.config import DecodeConfig
    from jiao_liao_asr.utils.native_ext import load_beam

    model, cfg, fe = _flagship()
    secs, batch, K, beam_size = 30.0, 128, 16, 8
    default_prune = DecodeConfig().beam_prune_logp  # as configured
    samples = int(secs * fe.sample_rate)
    rng = np.random.RandomState(1)
    wav = jnp.asarray(rng.randn(batch, samples).astype(np.float32) * 0.1)
    lengths = jnp.full((batch,), samples, jnp.int32)
    params = _overfit_flagship()[0]
    engine = load_beam()

    @jax.jit
    def infer_topk(params, wav, lengths):
        feats = featurize_batch(wav, fe)
        log_probs, out_lens = model.apply(
            {"params": params}, feats, lengths // fe.hop_length, deterministic=True
        )
        tv, ti, bl = ctc_topk_posteriors(log_probs, K)
        return tv, ti, bl, out_lens

    wavs = [jnp.roll(wav, i + 1, axis=0) + 1e-4 * (i + 1) for i in range(2)]
    jax.block_until_ready(wavs)

    def host_beam(dev_out, prune_logp):
        tv, ti, bl, out_lens = [np.asarray(a) for a in dev_out]
        return engine.search(tv, ti, bl, out_lens, beam_size,
                             prune_logp=prune_logp)

    # per-run pruning-equality assertion on every warm buffer
    equal = True
    for w in wavs:
        dev_out = infer_topk(params, w, lengths)
        ids_d, lens_d = host_beam(dev_out, default_prune)
        ids_p, lens_p = host_beam(dev_out, -10.0)
        if not (
            np.array_equal(lens_d, lens_p)
            and all(
                np.array_equal(a[:n], b[:n])
                for a, b, n in zip(ids_d, ids_p, lens_d)
            )
        ):
            equal = False

    def timed_rtfx(prune_logp, iters=6):
        t0 = time.perf_counter()
        pending = infer_topk(params, wavs[0], lengths)
        total_out = 0
        for i in range(1, iters + 1):
            nxt = (
                infer_topk(params, wavs[i % len(wavs)], lengths)
                if i < iters
                else None
            )
            # host beam overlaps device compute
            ids, lens = host_beam(pending, prune_logp)
            total_out += int(lens.sum())
            pending = nxt
        dt = time.perf_counter() - t0
        assert total_out >= 0
        return secs * batch * iters / dt

    return {
        "beam_rtfx": round(timed_rtfx(default_prune), 2),
        "beam_rtfx_pruned": round(timed_rtfx(-10.0), 2),
        "beam_prune_text_equal": equal,
    }


_BENCH_CORPUS = os.path.join(tempfile.gettempdir(), "jl_bench_corpus")


def _ensure_bucketed_corpus(n_utts: int = 256, seed: int = 3):
    """Synthetic mixed-length corpus on disk (cached across runs AND across
    section subprocesses/rounds — retries don't re-pay generation time):
    durations drawn from a realistic right-skewed distribution over
    (3, 30] seconds."""
    from jiao_liao_asr.data import ManifestRow, write_manifest
    from jiao_liao_asr.frontend.audio_io import write_wav

    manifest = os.path.join(_BENCH_CORPUS, "bench.jsonl")
    marker = os.path.join(_BENCH_CORPUS, f".done_{n_utts}_{seed}")
    if os.path.exists(marker):
        return manifest
    os.makedirs(_BENCH_CORPUS, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_utts):
        dur = float(np.clip(3.0 + rng.gamma(2.2, 4.5), 3.0, 30.0))
        n = int(dur * 16000)
        t = np.arange(n) / 16000.0
        wav = (
            0.25 * np.sin(2 * np.pi * (180 + (i % 40) * 11) * t)
            + 0.05 * rng.randn(n)
        ).astype(np.float32)
        path = os.path.join(_BENCH_CORPUS, f"b{i}.wav")
        write_wav(path, wav, 16000)
        rows.append(ManifestRow(audio=path, text="基准", duration=dur, dialect="bench"))
    write_manifest(rows, manifest)
    open(marker, "w").close()
    return manifest


def bench_bucketed_rtfx() -> dict:
    """Mixed-length RTFx through the PRODUCTION input pipeline: manifest ->
    BatchIterator (length bucketing, one compiled shape per bucket) ->
    prefetch thread -> fused greedy infer -> host text materialization.
    RTFx counts SPOKEN seconds only, so bucket padding waste, ragged
    batches, host wav decode, and id->text all land in the denominator.

    Returns {"bucketed_rtfx", "bucketed_device_rtfx"}: the second replays
    the SAME epoch from device-resident buffers (audio pre-uploaded, no
    host wav decode / host->device transfer / text materialization in the
    timed window), which separates the card's capability from the host
    pipeline. The gap between the two numbers IS the input-pipeline cost on
    this host."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.data.manifest import read_manifest
    from jiao_liao_asr.data.pipeline import (
        BatchIterator,
        PrefetchIterator,
    )
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.decode.ctc import ctc_greedy_collapse
    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.utils.config import DataConfig

    model, cfg, fe = _flagship()
    params = _init_flagship_params(model, fe)

    manifest = read_manifest(_ensure_bucketed_corpus())
    tok = CharTokenizer.build([r.text for r in manifest.rows])
    data_cfg = DataConfig(
        batch_size=64,
        bucket_boundaries_seconds=[10.0, 20.0, 30.0],
        max_text_len=8,
        shuffle_seed=0,
        # int16 wire format: halves the host->device bytes; dequantized on
        # device
        transfer_dtype="int16",
    )
    hop = fe.hop_length

    @jax.jit
    def infer(params, wav, lengths):
        feats = featurize_batch(wav, fe)
        ids, out_lens = model.apply(
            {"params": params}, feats, lengths // hop,
            deterministic=True, head_mode="argmax_ids",
        )
        return ctc_greedy_collapse(ids, out_lens)

    # one epoch = the iterator's own deterministic plan (batches are cut
    # PER BUCKET, so the count exceeds ceil(N/B) when buckets are ragged)
    n_batches = len(
        BatchIterator(
            manifest, tok, data_cfg, drop_last=False,
            process_index=0, process_count=1,
        )._plan_for_epoch()
    )

    def run_epoch(timed: bool):
        it = PrefetchIterator(
            BatchIterator(
                manifest, tok, data_cfg, drop_last=False,
                process_index=0, process_count=1,
            ),
            depth=2,
        )
        spoken = 0.0
        texts = []

        def materialize(pending):
            ids, lens = (np.asarray(a) for a in pending)
            for row, n in zip(ids, lens):
                texts.append("".join(chr(0x4E00 + int(t)) for t in row[: int(n)]))

        # 1-deep software pipeline: launch transfer+infer for batch i, THEN
        # sync batch i-1's ids — the host text work and the device round trip
        # overlap instead of serializing on one sync per batch
        pending = None
        for _ in range(n_batches):
            b = next(it)
            nxt = infer(
                params, jnp.asarray(b.audio), jnp.asarray(b.audio_lengths)
            )
            spoken += float(np.sum(b.audio_lengths)) / fe.sample_rate
            if pending is not None:
                materialize(pending)
            pending = nxt
        materialize(pending)
        return spoken, texts

    t0 = time.perf_counter()
    run_epoch(timed=False)  # warm every bucket shape
    sys.stderr.write(
        f"bucketed: warm epoch {time.perf_counter() - t0:.1f}s "
        f"({n_batches} batches)\n"
    )
    t0 = time.perf_counter()
    spoken, texts = run_epoch(timed=True)
    dt = time.perf_counter() - t0
    sys.stderr.write(f"bucketed: timed epoch {dt:.1f}s\n")
    assert len(texts) == len(manifest.rows)
    pipeline_rtfx = spoken / dt

    # --- device-resident replay of the same epoch ---
    # The replay runs in WAVES: upload <= K batches (distinct buffers), warm
    # each once, time the pure dispatch chain with ONE hard sync per wave,
    # then drop every reference before the next wave so at most one wave
    # (plus one transient execution) is live at a time. No host decode /
    # transfer / text work inside any timed window; bucketed_device_rtfx =
    # total spoken seconds / sum of timed windows. A byte cap bounds the
    # replayed subset if the corpus ever outgrows the budget (logged).
    # BatchIterator is an INFINITE iterator by design (__next__ rolls into
    # the next epoch — training semantics), so exactly ONE epoch is drawn
    # here, by the plan length.
    replay_it = BatchIterator(
        manifest, tok, data_cfg, drop_last=False,
        process_index=0, process_count=1,
    )
    host_batches = []
    for _ in range(len(replay_it._plan_for_epoch())):
        b = next(replay_it)
        host_batches.append((b.audio, b.audio_lengths))
    replay_budget = int(
        os.environ.get("JL_BENCH_REPLAY_BYTES", str(2 << 30))
    )
    picked, acc = [], 0
    for a, lens in host_batches:
        if acc + a.nbytes > replay_budget and picked:
            break
        picked.append((a, lens))
        acc += a.nbytes
    if len(picked) < len(host_batches):
        sys.stderr.write(
            f"bucketed: replay capped at {len(picked)}/{len(host_batches)} "
            f"batches ({acc / 2**20:.0f} MiB budget)\n"
        )
    dev_spoken = sum(
        float(np.sum(lens)) / fe.sample_rate for _, lens in picked
    )
    K = 4  # wave width: bounds resident bytes to ~K batches

    dt_dev = 0.0
    t_replay = time.perf_counter()
    for w0 in range(0, len(picked), K):
        wave = [
            (jnp.asarray(a), jnp.asarray(lens))
            for a, lens in picked[w0 : w0 + K]
        ]
        jax.block_until_ready(wave)
        outs = []
        for a, l in wave:  # warm every resident buffer (distinct dispatches)
            out = infer(params, a, l)
            _ = int(np.asarray(out[1]).sum())
        t0 = time.perf_counter()
        outs = [infer(params, a, l) for a, l in wave]
        total = int(np.asarray(sum(jnp.sum(o[1]) for o in outs)))  # hard sync
        dt_dev += time.perf_counter() - t0
        assert total >= 0
        del wave, outs  # drop refs -> freed before the next wave uploads
    sys.stderr.write(
        f"bucketed: replay {time.perf_counter() - t_replay:.1f}s total "
        f"(timed windows {dt_dev:.2f}s, K={K}, "
        f"{len(picked)} batches)\n"
    )
    return {
        "bucketed_rtfx": round(pipeline_rtfx, 2),
        "bucketed_device_rtfx": round(dev_spoken / dt_dev, 2),
        "bucketed_wave_batches": K,
    }


_OVERFIT_DIR = os.path.join(tempfile.gettempdir(), "jl_bench_overfit")
_PARAM_KEY_SEP = "\x1f"


def _overfit_flagship(n_utts: int = 64, secs: float = 8.0, steps: int = 150):
    """Overfit the flagship on synthetic utterances -> (params, wavs,
    lengths). Shared by the parity proof and the beam bench: a trained model
    emits PEAKED, blank-dominated posteriors — the regime deployed CTC
    models decode in — unlike random init's near-uniform rows.

    The trained params are cached ON DISK, content-addressed by the recipe
    (sections run in separate subprocesses, so an in-memory cache never
    hits): the beam section trains once, the parity section and every
    retry/rerun reload in seconds."""
    import jax.numpy as jnp

    from jiao_liao_asr.models.ctc_model import CTCEncoderModel  # noqa: F401

    model, cfg, fe = _flagship()
    samples = int(secs * fe.sample_rate)
    rng = np.random.RandomState(11)
    wavs = rng.randn(n_utts, samples).astype(np.float32) * 0.1
    lengths = np.full((n_utts,), samples, np.int32)

    cache = os.path.join(
        _OVERFIT_DIR,
        f"overfit_v1_{n_utts}_{secs}_{steps}_{cfg.vocab_size}.npz",
    )
    if os.path.exists(cache):
        with np.load(cache) as z:
            flat = {tuple(k.split(_PARAM_KEY_SEP)): z[k] for k in z.files}
        params = _unflatten_params(
            {k: jnp.asarray(v) for k, v in flat.items()}
        )
        return params, wavs, lengths

    params = _train_overfit(model, cfg, fe, wavs, n_utts, samples, steps)

    os.makedirs(_OVERFIT_DIR, exist_ok=True)
    tmp = cache + f".tmp{os.getpid()}.npz"  # np.savez appends .npz itself
    np.savez(
        tmp,
        **{
            _PARAM_KEY_SEP.join(k): np.asarray(v)
            for k, v in _flatten_params(params).items()
        },
    )
    os.replace(tmp, cache)  # atomic: concurrent sections race safely
    return params, wavs, lengths


def _train_overfit(model, cfg, fe, wavs, n_utts, samples, steps):
    import jax
    import jax.numpy as jnp
    import optax

    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.ops.ctc_loss import ctc_loss

    rng = np.random.RandomState(11)
    label_len = 6
    labels = rng.randint(1, cfg.vocab_size, (n_utts, label_len)).astype(np.int32)

    params = _init_flagship_params(model, fe, seed=1)
    tx = optax.adam(3e-4)
    opt_state = tx.init(params)
    hop = fe.hop_length

    @jax.jit
    def step(params, opt_state, wav, labels):
        def loss_fn(p):
            feats = featurize_batch(wav, fe)
            lp, out_lens = model.apply(
                {"params": p}, feats,
                jnp.full((wav.shape[0],), samples // hop, jnp.int32),
                deterministic=True,
            )
            nll = ctc_loss(lp, out_lens, labels, jnp.full((wav.shape[0],), label_len, jnp.int32))
            return jnp.mean(nll)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    B = 16
    wavs_d = jnp.asarray(wavs)
    labels_d = jnp.asarray(labels)
    for s in range(steps):
        i = (s * B) % n_utts
        params, opt_state, loss = step(
            params, opt_state, wavs_d[i : i + B], labels_d[i : i + B]
        )
    _ = float(loss)
    return params


def bench_parity(n_utts: int = 64, secs: float = 8.0, steps: int = 150) -> dict:
    """BASELINE 'decode text parity (greedy), bit-for-bit at text level,
    accelerator & CPU-JAX path': overfit the flagship on synthetic
    utterances, then transcribe them (a) on the card and (b) in a CPU-JAX
    subprocess, and require byte-identical text for all utterances."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.decode.ctc import ctc_greedy_collapse
    from jiao_liao_asr.frontend.features import featurize_batch

    model, cfg, fe = _flagship()
    hop = fe.hop_length
    params, wavs, lengths = _overfit_flagship(n_utts, secs, steps)
    wavs_d = jnp.asarray(wavs)

    @jax.jit
    def infer(params, wav, lengths):
        feats = featurize_batch(wav, fe)
        ids, out_lens = model.apply(
            {"params": params}, feats, lengths // hop,
            deterministic=True, head_mode="argmax_ids",
        )
        return ctc_greedy_collapse(ids, out_lens)

    ids, lens = infer(params, wavs_d, jnp.asarray(lengths))
    ids, lens = np.asarray(ids), np.asarray(lens)
    dev_texts = [
        " ".join(str(int(t)) for t in row[: int(n)]) for row, n in zip(ids, lens)
    ]

    # CPU-JAX path in a child that never opens the card
    with tempfile.TemporaryDirectory() as td:
        np.savez(
            os.path.join(td, "parity.npz"),
            wavs=wavs,
            lengths=lengths,
            **{
                "p_" + "/".join(map(str, k)): np.asarray(v)
                for k, v in _flatten_params(params).items()
            },
        )
        out = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                          "bench_parity_cpu.py"),
             os.path.join(td, "parity.npz"), str(cfg.vocab_size)],
            capture_output=True, text=True, timeout=840, env=cpu_child_env(),
        )
        if out.returncode != 0:
            raise RuntimeError(f"cpu parity child failed:\n{out.stderr[-2000:]}")
        cpu_texts = json.loads(out.stdout.splitlines()[-1])

    mismatches = [i for i, (a, b) in enumerate(zip(dev_texts, cpu_texts)) if a != b]
    if mismatches:
        sys.stderr.write(
            f"parity: {len(mismatches)}/{n_utts} utterances differ "
            f"(first: {mismatches[0]}: device={dev_texts[mismatches[0]]!r} "
            f"cpu={cpu_texts[mismatches[0]]!r})\n"
        )
    return {"parity_ok": not mismatches}


def _flatten_params(params):
    import jax

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    out = {}
    for kp, leaf in flat:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        out[keys] = leaf
    return out


def _unflatten_params(flat: dict) -> dict:
    """Inverse of _flatten_params for plain nested-dict param trees."""
    root: dict = {}
    for keys, leaf in flat.items():
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return root


def bench_adapter_finetune() -> dict:
    """Adapter fine-tune steps/sec (BASELINE tracked metric): the production
    jitted train step on the flagship CTC model with WF adapters + frozen
    backbone, batch 16 x 10 s. Distinct input batches per step; the step->
    step state dependency serializes execution on device, and the final
    block_until_ready is the only host sync inside the timed window."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.train.engine import (
        build_train_setup,
        init_state,
    )
    from jiao_liao_asr.utils.config import (
        AdapterConfig,
        CTCModelConfig,
        ExperimentConfig,
    )

    config = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=_FLAGSHIP_VOCAB, adapter=AdapterConfig(kind="wf", wf_rank=8)
        ),
    )
    config.train.train_adapters_only = True

    params = ModelBundle._init_params(config)
    _, _, tx, jitted_step = build_train_setup(config, params)
    state = init_state(config, tx, params)

    B, secs = 16, 10.0
    samples = int(secs * config.frontend.sample_rate)
    rng = np.random.RandomState(0)
    batches = []
    for i in range(4):
        batches.append({
            "audio": jnp.asarray(rng.randn(B, samples).astype(np.float32) * 0.1),
            "audio_lengths": jnp.full((B,), samples, jnp.int32),
            "labels": jnp.asarray(
                rng.randint(1, _FLAGSHIP_VOCAB, (B, 24)).astype(np.int32)
            ),
            "label_lengths": jnp.full((B,), 24, jnp.int32),
        })
    jax.block_until_ready(batches)
    for b in batches:  # warm every distinct buffer
        state, metrics = jitted_step(state, b)
        _ = float(metrics["loss"])

    iters = 60
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = jitted_step(state, batches[i % len(batches)])
    jax.block_until_ready(metrics)
    dt = time.perf_counter() - t0
    assert np.isfinite(float(metrics["loss"]))
    return {"adapter_finetune_steps_per_sec": round(iters / dt, 2)}


def bench_large_v3_adapter() -> dict:
    """whisper-large-v3 adapter fine-tune on ONE chip (BASELINE configs[4]
    stretch scale): bf16 backbone ~3.1 GB frozen + WF adapters trained,
    B=4 x 8 s. Returns the large_v3 train fields."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.train.engine import (
        build_train_setup,
        init_state,
    )
    from jiao_liao_asr.utils.config import (
        AdapterConfig,
        ExperimentConfig,
        whisper_preset,
    )

    w = whisper_preset("large-v3")
    w.adapter = AdapterConfig(kind="wf", wf_rank=8)
    config = ExperimentConfig(model_family="whisper", whisper=w)
    config.frontend.num_mels = 128
    config.train.train_adapters_only = True

    params = ModelBundle._init_params(config)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    _, _, tx, jitted_step = build_train_setup(config, params)
    state = init_state(config, tx, params)

    B, secs = 4, 8.0
    samples = int(secs * config.frontend.sample_rate)
    rng = np.random.RandomState(0)
    S = 24
    toks = rng.randint(0, 51000, (B, S)).astype(np.int32)
    batches = []
    for i in range(2):
        batches.append({
            "audio": jnp.asarray(rng.randn(B, samples).astype(np.float32) * 0.1),
            "audio_lengths": jnp.full((B,), samples, jnp.int32),
            "labels": jnp.asarray(toks),
            "label_lengths": jnp.full((B,), S, jnp.int32),
            "tokens": jnp.asarray(toks),
            "targets": jnp.asarray(np.roll(toks, -1, 1)),
        })
    for b in batches:
        state, metrics = jitted_step(state, b)
        _ = float(metrics["loss"])
    iters = 8
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = jitted_step(state, batches[i % len(batches)])
    jax.block_until_ready(metrics)
    dt = time.perf_counter() - t0
    peak = _peak_gb()
    return {
        "large_v3_adapter_steps_per_sec": round(iters / dt, 3),
        "large_v3_train_peak_gb": peak,
    }


def bench_large_v3_decode() -> dict:
    """whisper-large-v3 int8-serving AR greedy decode tok/s at B=8 (the
    production serving configuration: int8 weights + cross/self KV + tied
    logits — BASELINE configs[4] stretch). Random-init weights: throughput is
    weight-shape-bound, not value-bound."""
    import jax
    import jax.numpy as jnp

    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.decode.whisper_generate import (
        default_prompt,
        greedy_generate,
    )
    from jiao_liao_asr.frontend.features import featurize_batch
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.models.whisper import WhisperModel
    from jiao_liao_asr.utils.config import (
        ExperimentConfig,
        FrontendConfig,
        whisper_preset,
    )

    cfg = ExperimentConfig(
        model_family="whisper", whisper=whisper_preset("large-v3")
    )
    cfg.frontend = FrontendConfig(num_mels=128)
    model = WhisperModel(cfg.whisper)
    params = ModelBundle._init_params(cfg)
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        params,
    )
    bundle = ModelBundle(config=cfg, params=params, tokenizer=CharTokenizer([]))
    qparams = bundle.quantize().params
    del params, bundle

    fe = cfg.frontend
    B, secs, max_len = 8, 30.0, 64
    samples = int(secs * fe.sample_rate)
    prompt = default_prompt(cfg.whisper.vocab_size)

    @jax.jit
    def decode(p, wav):
        mel = featurize_batch(wav, fe)
        return greedy_generate(model, p, mel, max_len=max_len, prompt=prompt)

    rng = np.random.RandomState(8)
    wavs = [
        jnp.asarray(rng.randn(B, samples).astype(np.float32) * 0.1)
        for _ in range(2)
    ]
    jax.block_until_ready(wavs)
    toks_per_iter = 0
    for wv in wavs:  # compile + warm every distinct buffer
        _, n = decode(qparams, wv)
        toks_per_iter = int(np.asarray(n).sum())
    iters = 4
    t0 = time.perf_counter()
    toks = 0
    for i in range(iters):
        _, n = decode(qparams, wavs[i % 2])
        toks += int(np.asarray(n).sum())  # hard host sync
    dt = time.perf_counter() - t0
    peak = _peak_gb()
    assert toks >= toks_per_iter
    return {
        "large_v3_decode_tok_s": round(toks / dt, 1),
        "large_v3_decode_rtfx": round(secs * B * iters / dt, 1),
        "large_v3_serve_peak_gb": peak,
    }


def bench_quality_ordering() -> dict:
    """The one claim the reference publishes (README.md:1: novel adapters
    beat conventional adapters / full fine-tuning on CER/WER) as a SCORED,
    seeded regression field: runs the synthetic
    multi-dialect transfer protocol (examples/synthetic_demo.py
    --compare-adapters) — stage-1 neighbor-dialect pretrain, stage-2
    adapter-only adaptation once per kind (wf/att/bottleneck), held-out
    eval — and records the per-family CERs plus the robust verdict
    (transfer helps + every family adapts; the exact family ordering is
    recorded but not asserted — the toy task can't discriminate it).

    Runs in a CPU child (--cpu, JAX_PLATFORMS=cpu): the verdict is
    ACCURACY-based (seeded CER improvements), not throughput, and the child
    must not open the card this process holds."""
    r = subprocess.run(
        [sys.executable,
         os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "examples", "synthetic_demo.py"),
         "--compare-adapters", "--cpu", "--outdir",
         os.path.join(tempfile.gettempdir(), "jl_bench_quality")],
        capture_output=True, text=True, timeout=870, env=cpu_child_env(),
    )
    ordering = None
    for line in r.stdout.splitlines():
        line = line.strip()
        if line.startswith("{") and "quality_ordering" in line:
            ordering = json.loads(line)["quality_ordering"]
    if r.returncode != 0 or ordering is None:
        raise RuntimeError(
            f"quality protocol failed (rc={r.returncode}):\n"
            + r.stdout[-800:] + "\n" + r.stderr[-800:]
        )
    return {
        "quality_ordering_ok": ordering["ok"],
        "quality_zero_shot_cer": round(ordering["zero_shot_cer"], 4),
        "quality_cer_wf": round(ordering["cer_wf"], 4),
        "quality_cer_att": round(ordering["cer_att"], 4),
        "quality_cer_bottleneck": round(ordering["cer_bottleneck"], 4),
    }


# Section registry, in execution order: (function name, flag that skips it).
SECTIONS = [
    ("bench_rtfx", None),
    ("bench_adapter_finetune", None),
    ("bench_beam_rtfx", "--no-beam"),
    ("bench_parity", "--no-parity"),
    ("bench_bucketed_rtfx", "--no-bucketed"),
    ("bench_large_v3_adapter", "--no-large"),
    ("bench_large_v3_decode", "--no-large"),
    ("bench_quality_ordering", "--no-quality"),
]

# every field a section may fill, in schema order; each emission carries
# ALL of them (nulls for sections not yet run or failed)
SCHEMA = [
    ("metric", "rtfx"),
    ("value", None),
    ("unit", "audio_sec_per_sec_per_card"),
    ("vs_baseline", None),
    ("beam_rtfx", None),
    ("beam_rtfx_pruned", None),
    ("beam_prune_text_equal", None),
    ("bucketed_rtfx", None),
    ("bucketed_device_rtfx", None),
    ("bucketed_wave_batches", None),
    ("adapter_finetune_steps_per_sec", None),
    ("parity_ok", None),
    ("train_batch", 16),
    ("train_secs_per_utt", 10.0),
    ("large_v3_adapter_steps_per_sec", None),
    ("large_v3_train_peak_gb", None),
    ("large_v3_decode_tok_s", None),
    ("large_v3_decode_rtfx", None),
    ("large_v3_serve_peak_gb", None),
    ("quality_ordering_ok", None),
    ("quality_zero_shot_cer", None),
    ("quality_cer_wf", None),
    ("quality_cer_att", None),
    ("quality_cer_bottleneck", None),
]


def cpu_child_env() -> dict:
    """Environment for a child process that must stay off the card."""
    return dict(os.environ, JAX_PLATFORMS="cpu")


def run_sections(sections, device: dict, emit=print) -> int:
    """Run (name, fn) sections in turn in this process, emitting the
    cumulative JSON line after each. Returns 0 if all succeeded, else 1."""
    result = dict(SCHEMA)
    result["device"] = device
    result["errors"] = {}
    rc = 0
    for name, fn in sections:
        t0 = time.perf_counter()
        try:
            fields = fn()
        except Exception as e:  # record, null its fields, go on, fail at exit
            result["errors"][name] = f"{type(e).__name__}: {e}"[:1000]
            rc = 1
        else:
            unknown = set(fields) - set(result)
            if unknown:
                raise KeyError(f"{name} returned fields outside SCHEMA: {unknown}")
            result.update(fields)
        sys.stderr.write(f"{name}: {time.perf_counter() - t0:.1f}s\n")
        emit(json.dumps(result))
    return rc


def device_info() -> dict:
    """The device the run is on; raises unless JAX's default backend is a
    GPU (a device metric is never taken on the CPU)."""
    import jax

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    if info["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX sees {info}")
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for flag in dict.fromkeys(flag for _, flag in SECTIONS if flag):
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    from jiao_liao_asr.utils.compile_cache import (
        enable_compile_cache,
    )
    from jiao_liao_asr.utils.native_ext import build_native

    try:
        device = device_info()
    except RuntimeError as e:
        sys.stderr.write(f"bench: {e}\n")
        return 2
    enable_compile_cache()
    build_native()
    chosen = [
        (name, globals()[name]) for name, flag in SECTIONS
        if not (flag and getattr(args, flag.lstrip("-").replace("-", "_")))
    ]
    return run_sections(chosen, device)


if __name__ == "__main__":
    sys.exit(main())
