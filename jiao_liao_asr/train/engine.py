"""Fine-tuning engine: optax + frozen-backbone masking + pjit sharding.

Replacement for the reference's accelerate/Trainer/Brain loop (SURVEY.md
3.1 call stack). Key differences by design:

* featurization happens INSIDE the jitted train step (waveform -> log-mel ->
  SpecAugment on device), eliminating the reference's CPU .map() bottleneck
  (BASELINE north_star: "on-device featurization")
* gradient all-reduce is not a DDP wrapper: the batch is sharded over the
  mesh 'data' axis and XLA inserts the psum during pjit partitioning
* frozen backbone = optax.masked updates from the adapter param mask —
  matches the reference's requires_grad masking (SURVEY 3.1) but keeps one
  compiled step for both phases
* grad accumulation folds into optax.MultiSteps; AMP is bf16 compute dtype
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..utils.config import ExperimentConfig, OptimizerConfig
from ..utils.logging import MetricsLogger
from ..models.adapters import param_is_adapter
from ..ops.ctc_loss import ctc_loss
from ..frontend.features import dequantize_pcm, featurize_batch
from ..frontend.specaugment import spec_augment
from ..frontend.augment import augment_waveform


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    opt_state: Any
    rng: jnp.ndarray

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def make_schedule(cfg: OptimizerConfig):
    if cfg.schedule == "constant":
        return optax.constant_schedule(cfg.learning_rate)
    if cfg.schedule == "noam":
        return lambda step: cfg.learning_rate * jnp.minimum(
            (step + 1.0) ** -0.5, (step + 1.0) * cfg.warmup_steps**-1.5
        ) * cfg.warmup_steps**0.5
    warmup = optax.linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
    rest = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "cosine":
        decay = optax.cosine_decay_schedule(cfg.learning_rate, rest)
    else:  # linear
        decay = optax.linear_schedule(cfg.learning_rate, 0.0, rest)
    return optax.join_schedules([warmup, decay], [cfg.warmup_steps])


def adapter_mask(params: Any) -> Any:
    """True for trainable (adapter) leaves, False for frozen backbone."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]

    def is_adapter_path(kp):
        return param_is_adapter(
            tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        )

    return jax.tree_util.tree_map_with_path(lambda kp, _: is_adapter_path(kp), params)


def make_optimizer(cfg: OptimizerConfig, trainable_mask: Optional[Any] = None):
    sched = make_schedule(cfg)
    if cfg.name == "adamw":
        base = optax.adamw(
            sched, b1=cfg.beta1, b2=cfg.beta2, weight_decay=cfg.weight_decay
        )
    elif cfg.name == "adam":
        base = optax.adam(sched, b1=cfg.beta1, b2=cfg.beta2)
    elif cfg.name == "sgd":
        base = optax.sgd(sched, momentum=cfg.beta1)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip_norm), base)
    if trainable_mask is not None:
        # frozen-backbone semantics: trainable leaves get the optimizer,
        # frozen leaves get update 0 (optax.masked alone would pass raw
        # gradients through for unmasked leaves)
        labels = jax.tree_util.tree_map(
            lambda m: "train" if m else "freeze", trainable_mask
        )
        tx = optax.multi_transform(
            {"train": tx, "freeze": optax.set_to_zero()}, labels
        )
    if cfg.grad_accum_steps > 1:
        tx = optax.MultiSteps(tx, cfg.grad_accum_steps)
    return tx


# ---------------------------------------------------------------------------
# Loss / step construction
# ---------------------------------------------------------------------------


def make_ctc_loss_fn(config: ExperimentConfig, model) -> Callable:
    fe = config.frontend

    def loss_fn(params, batch, rng, train: bool):
        audio = dequantize_pcm(batch["audio"])  # int16 wire format ok
        k_aug, k_spec, k_drop = jax.random.split(rng, 3)
        if train and config.augment.enabled:
            audio = augment_waveform(
                k_aug, audio, config.augment, sample_rate=fe.sample_rate
            )
        # no gradient flows through the frontend (only params are
        # differentiated)
        feats = featurize_batch(audio, fe)
        feat_lengths = batch["audio_lengths"] // fe.hop_length
        if train and config.specaugment.enabled:
            feats = spec_augment(k_spec, feats, config.specaugment)
        log_probs, out_lens = model.apply(
            {"params": params},
            feats,
            feat_lengths,
            deterministic=not train,
            rngs={"dropout": k_drop} if train else {},
        )
        nll = ctc_loss(
            log_probs, out_lens, batch["labels"], batch["label_lengths"]
        )
        denom = jnp.maximum(batch["label_lengths"], 1).astype(jnp.float32)
        loss = jnp.mean(nll / denom)
        return loss, {"loss": loss, "nll_sum": jnp.sum(nll)}

    return loss_fn


def make_whisper_loss_fn(config: ExperimentConfig, model) -> Callable:
    fe = config.frontend

    def loss_fn(params, batch, rng, train: bool):
        k_spec, k_drop = jax.random.split(rng)
        feats = featurize_batch(batch["audio"], fe)  # handles int16 wire
        if train and config.specaugment.enabled:
            feats = spec_augment(k_spec, feats, config.specaugment)
        tokens = batch["tokens"]  # [B, S] with prompt prefix
        targets = batch["targets"]  # [B, S] next-token ids, -100 = ignore
        logits = model.apply(
            {"params": params},
            feats,
            tokens,
            deterministic=not train,
            rngs={"dropout": k_drop} if train else {},
        )
        valid = targets >= 0
        tsafe = jnp.maximum(targets, 0)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tsafe)
        loss = jnp.sum(ce * valid) / jnp.maximum(jnp.sum(valid), 1)
        return loss, {"loss": loss}

    return loss_fn


def make_train_step(loss_fn: Callable, tx, fast_rng: bool = False) -> Callable:
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rng, step_rng = jax.random.split(state.rng)
        if fast_rng:
            # derive the step's dropout/augment stream as an 'rbg' key
            # (TrainConfig.fast_dropout_rng). state.rng itself stays
            # threefry so checkpoints are format-stable and resume exact.
            step_rng = jax.random.wrap_key_data(
                jnp.tile(step_rng, 2), impl="rbg"
            )
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (loss, metrics), grads = grad_fn(state.params, batch, step_rng, True)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        gnorm = optax.global_norm(grads)
        new_state = state.replace(
            step=state.step + 1, params=params, opt_state=opt_state, rng=rng
        )
        metrics = dict(metrics, grad_norm=gnorm)
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Experiment runner
# ---------------------------------------------------------------------------


def make_joint_loss_fn(config: ExperimentConfig, model) -> Callable:
    """Hybrid loss for the joint CTC/attention family (SURVEY C8):
    ctc_weight * CTC + (1 - ctc_weight) * CE over the attention decoder —
    SpeechBrain's joint training objective, both branches off one encoder
    pass. Batch carries both CTC labels and teacher-forcing tokens/targets
    (batch_to_device builds the latter with sos/eos = blank id 0)."""
    fe = config.frontend
    w = config.joint.ctc_weight

    def loss_fn(params, batch, rng, train: bool):
        audio = dequantize_pcm(batch["audio"])  # int16 wire format ok
        k_aug, k_spec, k_drop = jax.random.split(rng, 3)
        if train and config.augment.enabled:
            audio = augment_waveform(
                k_aug, audio, config.augment, sample_rate=fe.sample_rate
            )
        feats = featurize_batch(audio, fe)
        feat_lengths = batch["audio_lengths"] // fe.hop_length
        if train and config.specaugment.enabled:
            feats = spec_augment(k_spec, feats, config.specaugment)
        ctc_lp, out_lens, dec_logits = model.apply(
            {"params": params},
            feats,
            feat_lengths,
            batch["tokens"],
            deterministic=not train,
            rngs={"dropout": k_drop} if train else {},
        )
        nll = ctc_loss(ctc_lp, out_lens, batch["labels"], batch["label_lengths"])
        denom = jnp.maximum(batch["label_lengths"], 1).astype(jnp.float32)
        loss_ctc = jnp.mean(nll / denom)
        targets = batch["targets"]
        valid = targets >= 0
        tsafe = jnp.maximum(targets, 0)
        ce = optax.softmax_cross_entropy_with_integer_labels(dec_logits, tsafe)
        loss_att = jnp.sum(ce * valid) / jnp.maximum(jnp.sum(valid), 1)
        loss = w * loss_ctc + (1.0 - w) * loss_att
        return loss, {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att}

    return loss_fn


def build_train_setup(config: ExperimentConfig, params, mesh=None):
    """(model, loss_fn, tx, jitted step). `mesh`: the mesh the step's
    sharded inputs live on; the step is traced under it."""
    from ..models.bundle import ModelBundle

    model = ModelBundle._model(config)
    if config.model_family == "ctc":
        loss_fn = make_ctc_loss_fn(config, model)
    elif config.model_family == "joint":
        loss_fn = make_joint_loss_fn(config, model)
    else:
        loss_fn = make_whisper_loss_fn(config, model)
    mask = adapter_mask(params) if config.train.train_adapters_only else None
    if mask is not None:
        # stop_gradient on frozen leaves: the optimizer masking alone still
        # COMPUTES full backbone weight-gradients and throws them away; this
        # lets XLA dead-code-eliminate the dW matmuls (~1/3 of backward
        # FLOPs) while activation gradients still flow to reach adapters
        inner_loss = loss_fn

        def loss_fn(p, batch, rng, train):
            p_eff = jax.tree_util.tree_map(
                lambda m, x: x if m else jax.lax.stop_gradient(x), mask, p
            )
            return inner_loss(p_eff, batch, rng, train)

    tx = make_optimizer(config.train.optimizer, mask)
    step_fn = make_train_step(loss_fn, tx, fast_rng=config.train.fast_dropout_rng)

    # Sharding is carried by the *inputs* (modern jax.jit semantics): the
    # caller device_puts the batch with batch_sharding(mesh) and the state
    # replicated or fsdp-sharded (parallel.mesh.param_sharding); XLA then
    # partitions the step and inserts the gradient psum over 'data' — the
    # reference's DDP all-reduce with zero framework code (SURVEY C19).
    jitted = jax.jit(step_fn, donate_argnums=(0,))
    if mesh is not None and mesh.size > 1:
        # traced under the mesh, so attention runs per shard over it
        # (models/layers.dot_product_attention)
        unmeshed = jitted

        def jitted(state, batch):
            with jax.set_mesh(mesh):
                return unmeshed(state, batch)

    return model, loss_fn, tx, jitted


def init_state(config: ExperimentConfig, tx, params, seed: int = 0) -> TrainState:
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
        rng=jax.random.PRNGKey(seed),
    )


def batch_to_device(
    batch,
    tokenizer=None,
    family: str = "ctc",
    whisper_prompt=None,
    eot_id: Optional[int] = None,
):
    """Host Batch dataclass -> dict of device arrays for the step fn.

    For the whisper family, builds teacher-forcing (tokens, targets) with the
    transcription prompt prefix; `eot_id` must lie inside the model's vocab
    (defaults to the standard Whisper EOT, 50257 — override for small test
    vocabs or the targets/embedding lookups go out of range).
    """
    out = {
        "audio": jnp.asarray(batch.audio),
        "audio_lengths": jnp.asarray(batch.audio_lengths),
        "labels": jnp.asarray(batch.labels),
        "label_lengths": jnp.asarray(batch.label_lengths),
    }
    if family in ("whisper", "joint"):
        from ..decode.whisper_generate import EOT, default_prompt

        if family == "joint":
            # joint CTC/attention: sos/eos = the CTC blank (id 0), which
            # never appears inside label sequences (models/joint.py)
            eot = 0 if eot_id is None else eot_id
            prompt = list(whisper_prompt if whisper_prompt is not None else (eot,))
        else:
            eot = EOT if eot_id is None else eot_id
            prompt = list(whisper_prompt if whisper_prompt is not None else default_prompt())
        B, S = batch.labels.shape
        P = len(prompt)
        toks = np.full((B, P + S + 1), eot, np.int32)
        tgts = np.full((B, P + S + 1), -100, np.int32)
        toks[:, :P] = prompt
        for i in range(B):
            n = batch.label_lengths[i]
            toks[i, P : P + n] = batch.labels[i, :n]
            tgts[i, P - 1 : P + n - 1] = batch.labels[i, :n]
            tgts[i, P + n - 1] = eot
        out["tokens"] = jnp.asarray(toks)
        out["targets"] = jnp.asarray(tgts)
    return out


def build_tokenizer_for(config: ExperimentConfig, manifest):
    """Tokenizer per config: pretrained BPE dir or a char vocab over the
    manifest texts (resizing the model vocab to match)."""
    from ..data.tokenizer import CharTokenizer

    if config.data.tokenizer_dir:
        # pretrained subword vocab (whisper fine-tunes): HF BPE files
        from ..data.bpe import ByteLevelBPE

        return ByteLevelBPE.from_hf_dir(config.data.tokenizer_dir)
    if config.data.unigram_vocab:
        # SP-unigram subword vocab (SURVEY N9; cli train-unigram)
        from ..data.unigram import UnigramTokenizer

        tokenizer = UnigramTokenizer.load(config.data.unigram_vocab)
    else:
        tokenizer = CharTokenizer.build(manifest.texts())
    if config.model_family == "ctc":
        config.ctc_model.vocab_size = len(tokenizer)
    elif config.model_family == "joint":
        # one shared vocab for both heads; blank (0) doubles as sos/eos
        config.joint.vocab_size = len(tokenizer)
    elif config.model_family == "whisper":
        # reserve ids past the char vocab for <sot>/<eot>
        n = len(tokenizer)
        config.whisper.vocab_size = max(n + 8, 16)
        config.whisper.prompt_ids = (n,)
        config.whisper.eot_id = n + 1
    return tokenizer


def train_loop(
    config: ExperimentConfig,
    manifest,
    tokenizer,
    params,
    mesh=None,
    resume: bool = False,
    checkpoint_dir: Optional[str] = None,
    logger: Optional[MetricsLogger] = None,
    eval_manifest=None,
):
    """The robust production loop, shared by run_experiment and the
    multi-dialect run_stages (SURVEY 3.1/3.4):

    * mesh-integrated: state is FSDP+ZeRO-sharded (parallel.mesh.shard_state)
      and every batch rides batch_sharding over ('data','fsdp') — the
      reference's DDP (SURVEY C19) falls out of pjit partitioning
    * prefetch-threaded data, per-step metrics, periodic eval
    * checkpoint every N steps + SIGTERM checkpoint-and-exit (SURVEY §5.3)
      with exact data-iterator resume

    Returns (state, info) with info = {"terminated": bool, "last_metrics": {}}.
    """
    from ..data.pipeline import BatchIterator, PrefetchIterator
    from ..parallel import multihost as mh
    from ..parallel.mesh import build_mesh_for_batch, shard_batch, shard_state
    from .checkpoints import TrainCheckpointer

    if mesh is None:
        mesh = build_mesh_for_batch(config.mesh, config.data.batch_size)
    model, loss_fn, tx, jitted_step = build_train_setup(config, params, mesh)
    state = init_state(config, tx, params, config.train.seed)
    # shard BEFORE restore: the sharded state is the restore template, so
    # each restored leaf is placed straight into its sharding
    state = shard_state(mesh, state)

    it = PrefetchIterator(
        BatchIterator(manifest, tokenizer, config.data),
        depth=max(config.data.num_host_workers, 1),
    )
    ckpt_dir = checkpoint_dir or config.train.checkpoint_dir
    ckpt = TrainCheckpointer(ckpt_dir, config.train.keep_checkpoints)
    start_step = 0
    if resume:
        step0, restored, extra = ckpt.restore(state)
        if restored is not None:
            state, start_step = restored, step0
            it.load_state_dict(extra.get("data_iter", it.state_dict()))

    # host-side IO (metrics, wandb) is primary-process-only — the DDP rank-0
    # convention (SURVEY C19); compute runs identically on every process
    own_logger = logger is None and mh.is_primary()
    if not mh.is_primary():
        logger = None
    if own_logger:
        logger = MetricsLogger(
            config.train.metrics_path, use_wandb=config.train.use_wandb
        )
    total = config.train.optimizer.total_steps
    t0 = time.time()
    if config.model_family == "whisper":
        from ..decode.whisper_generate import resolve_specials

        w_prompt, w_eot = resolve_specials(config.whisper)
    else:
        w_prompt = w_eot = None

    # graceful preemption (SURVEY §5.3): a SIGTERM (maintenance event /
    # scheduler preemption) checkpoints before exiting so resume is exact
    import signal
    import threading

    terminated = {"flag": False}

    def _on_term(signum, frame):
        terminated["flag"] = True

    old_handler = None
    if threading.current_thread() is threading.main_thread():
        old_handler = signal.signal(signal.SIGTERM, _on_term)
    last_metrics: Dict[str, Any] = {}
    for step in range(start_step, total):
        host_batch = next(it)
        batch = batch_to_device(
            host_batch, tokenizer, config.model_family, w_prompt, w_eot
        )
        batch = shard_batch(mesh, batch, global_rows=host_batch.global_rows)
        state, metrics = jitted_step(state, batch)
        last_metrics = metrics
        if logger is not None and (step + 1) % config.train.log_every_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_sec"] = config.train.log_every_steps / max(
                time.time() - t0, 1e-9
            )
            t0 = time.time()
            logger.log(step + 1, **m)
        if (
            eval_manifest is not None
            and mh.process_count() == 1  # mid-train transcribe-eval is a
            # host-local path; under multi-host it would need a param
            # allgather — run evaluate post-hoc from the checkpoint instead
            and (step + 1) % config.train.eval_every_steps == 0
        ):
            em = evaluate_manifest(config, state.params, tokenizer, eval_manifest)
            if logger is not None:
                logger.log(step + 1, **em)
            t0 = time.time()  # don't count eval time against steps/sec
        if (
            (step + 1) % config.train.checkpoint_every_steps == 0
            or step + 1 == total
            or terminated["flag"]
        ):
            ckpt.save(step + 1, state, {"data_iter": it.state_dict()})
        if terminated["flag"]:
            if logger is not None:
                logger.log(step + 1, event="sigterm_checkpoint_and_exit")
            break
    if old_handler is not None:
        signal.signal(signal.SIGTERM, old_handler)
    if own_logger:
        logger.close()
    info = {
        "terminated": terminated["flag"],
        "last_metrics": {k: float(v) for k, v in last_metrics.items()},
    }
    return state, info


def run_experiment(config: ExperimentConfig, resume: bool = False):
    """Full fine-tune loop (BASELINE configs[2]); multi-dialect stage
    scheduling (configs[3]) layers on top in train/schedules.py."""
    from ..data.manifest import read_manifest
    from ..models.bundle import ModelBundle

    manifest = read_manifest(config.data.train_manifest)
    if config.data.dialect_weights:
        # joint multi-dialect mixing by manifest dialect tags (SURVEY 3.4);
        # stage-level mixing lives in train/schedules.py, this covers the
        # single-run weighted-mixture setup
        from ..data.pipeline import mix_manifests
        from ..data.manifest import Manifest

        groups: dict = {}
        for row in manifest.rows:
            groups.setdefault(row.dialect or "default", []).append(row)
        manifest = mix_manifests(
            {k: Manifest(v) for k, v in groups.items()},
            dict(config.data.dialect_weights),
        )
    tokenizer = build_tokenizer_for(config, manifest)
    params = ModelBundle._init_params(config, seed=config.train.seed)

    eval_manifest = None
    if config.data.eval_manifest:
        try:
            eval_manifest = read_manifest(config.data.eval_manifest)
        except FileNotFoundError:
            eval_manifest = None

    state, _info = train_loop(
        config, manifest, tokenizer, params,
        resume=resume, eval_manifest=eval_manifest,
    )
    bundle = ModelBundle(config=config, params=state.params, tokenizer=tokenizer)
    if eval_manifest is not None:
        final = evaluate_manifest(config, state.params, tokenizer, eval_manifest)
        logger2 = MetricsLogger(config.train.metrics_path)
        logger2.log(config.train.optimizer.total_steps, **final)
        logger2.close()
    return state, bundle


def evaluate_manifest(config, params, tokenizer, manifest, batch_size: int = 16):
    """Greedy-transcribe a manifest and score corpus CER / jieba WER — the
    reference's held-out eval (SURVEY 3.3), callable mid-training."""
    from ..evals.metrics import corpus_cer, corpus_wer
    from ..models.bundle import ModelBundle

    bundle = ModelBundle(config=config, params=params, tokenizer=tokenizer)
    refs, hyps = [], []
    rows = manifest.rows
    for i in range(0, len(rows), batch_size):
        chunk = rows[i : i + batch_size]
        hyps.extend(bundle.transcribe([r.audio for r in chunk]))
        refs.extend(r.text for r in chunk)
    return {"eval_cer": corpus_cer(refs, hyps), "eval_wer": corpus_wer(refs, hyps),
            "eval_utts": len(refs)}
