"""Failure-recovery semantics (SURVEY.md §5.3): a job killed and restored
from its checkpoint replays exactly — params bit-identical to an
uninterrupted run, data iterator resuming mid-epoch."""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from jiao_liao_asr.data import (
    BatchIterator,
    CharTokenizer,
    ManifestRow,
    Manifest,
)
from jiao_liao_asr.frontend.audio_io import write_wav
from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.train.checkpoints import TrainCheckpointer
from jiao_liao_asr.train.engine import (
    batch_to_device,
    build_train_setup,
    init_state,
)
from jiao_liao_asr.utils.config import (
    CTCModelConfig,
    DataConfig,
    ExperimentConfig,
    OptimizerConfig,
    SpecAugmentConfig,
)


def _cfg():
    return ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=24, d_model=64, num_layers=1, num_heads=4, mlp_dim=128,
            conv_channels=32, dtype="float32", dropout=0.0,
        ),
        specaugment=SpecAugmentConfig(enabled=False),
        data=DataConfig(batch_size=2, bucket_boundaries_seconds=(1.5,),
                        min_audio_seconds=0.1, max_text_len=8),
    )


def _corpus(tmp_path, rng):
    rows = []
    for i, text in enumerate(["你好", "世界", "胶辽", "官话", "语音", "识别"]):
        wav = (rng.randn(int(16000 * 1.0)) * 0.1).astype(np.float32)
        p = tmp_path / f"r{i}.wav"
        write_wav(p, wav, 16000)
        rows.append(ManifestRow(str(p), text, 1.0, "jiaoliao"))
    return Manifest(rows)


def test_kill_and_resume_replays_exactly(tmp_path, rng):
    cfg = _cfg()
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=6, schedule="constant"
    )
    manifest = _corpus(tmp_path, rng)
    tok = CharTokenizer.build(manifest.texts())
    cfg.ctc_model.vocab_size = len(tok)

    def run(total, resume_at=None, ckpt_dir=None):
        params = ModelBundle._init_params(cfg)
        _, _, tx, step = build_train_setup(cfg, params)
        state = init_state(cfg, tx, params)
        it = BatchIterator(manifest, tok, cfg.data)
        start = 0
        ck = TrainCheckpointer(ckpt_dir, keep=2) if ckpt_dir else None
        if resume_at is not None:
            s, restored, extra = ck.restore(state)
            state, start = restored, s
            it.load_state_dict(extra["data_iter"])
        for i in range(start, total):
            batch = batch_to_device(next(it))
            state, _ = step(state, batch)
            if ck is not None and resume_at is None and i + 1 == 3:
                ck.save(3, state, {"data_iter": it.state_dict()})
        return state

    # uninterrupted 6 steps
    full = run(6)
    # interrupted: 3 steps + checkpoint, then fresh process resumes 3 more
    ckpt_dir = str(tmp_path / "ck")
    run(3, ckpt_dir=ckpt_dir)
    resumed = run(6, resume_at=3, ckpt_dir=ckpt_dir)

    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(),
        full.params, resumed.params,
    )
    assert max(jax.tree_util.tree_leaves(d)) == 0.0, "resume diverged from uninterrupted run"


import pytest


@pytest.mark.parametrize("fast_rng", [True, False])
def test_kill_and_resume_exact_with_dropout_rng_matrix(tmp_path, rng, fast_rng):
    """r4 verdict item 6: TrainConfig.fast_dropout_rng claims
    checkpoint-stable resume in BOTH settings — state.rng stays a threefry
    key and the step's rbg stream is derived from it deterministically
    (train/engine.py make_train_step). Pin it: kill-and-resume replays
    bit-exactly with dropout ACTIVE (the stream matters, unlike the
    dropout=0 base test) at each flag setting."""
    cfg = _cfg()
    cfg.ctc_model = dataclasses.replace(cfg.ctc_model, dropout=0.2)
    cfg.train.fast_dropout_rng = fast_rng
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=6, schedule="constant"
    )
    manifest = _corpus(tmp_path, rng)
    tok = CharTokenizer.build(manifest.texts())
    cfg.ctc_model.vocab_size = len(tok)

    def run(total, resume_at=None, ckpt_dir=None):
        params = ModelBundle._init_params(cfg)
        _, _, tx, step = build_train_setup(cfg, params)
        state = init_state(cfg, tx, params)
        it = BatchIterator(manifest, tok, cfg.data)
        start = 0
        ck = TrainCheckpointer(ckpt_dir, keep=2) if ckpt_dir else None
        if resume_at is not None:
            s, restored, extra = ck.restore(state)
            state, start = restored, s
            it.load_state_dict(extra["data_iter"])
        for i in range(start, total):
            batch = batch_to_device(next(it))
            state, _ = step(state, batch)
            if ck is not None and resume_at is None and i + 1 == 3:
                ck.save(3, state, {"data_iter": it.state_dict()})
        return state

    full = run(6)
    ckpt_dir = str(tmp_path / f"ck_{fast_rng}")
    run(3, ckpt_dir=ckpt_dir)
    resumed = run(6, resume_at=3, ckpt_dir=ckpt_dir)

    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(),
        full.params, resumed.params,
    )
    assert max(jax.tree_util.tree_leaves(d)) == 0.0, (
        f"resume diverged (fast_dropout_rng={fast_rng})"
    )


def test_fast_dropout_rng_consumed_and_rng_evolution_flag_independent(
    tmp_path, rng
):
    """The flag is CONSUMED (rbg vs threefry produce different dropout masks
    -> different params after one step) while the checkpointed state.rng
    evolves IDENTICALLY under both settings — the format-stability claim in
    utils/config.py:290-293 as a red/green test."""
    states = {}
    for fast_rng in (True, False):
        cfg = _cfg()
        cfg.ctc_model = dataclasses.replace(cfg.ctc_model, dropout=0.3)
        cfg.train.fast_dropout_rng = fast_rng
        cfg.train.optimizer = OptimizerConfig(
            learning_rate=1e-2, warmup_steps=0, total_steps=2,
            schedule="constant",
        )
        manifest = _corpus(tmp_path, rng)
        tok = CharTokenizer.build(manifest.texts())
        cfg.ctc_model.vocab_size = len(tok)
        params = ModelBundle._init_params(cfg)
        _, _, tx, step = build_train_setup(cfg, params)
        state = init_state(cfg, tx, params)
        batch = batch_to_device(next(BatchIterator(manifest, tok, cfg.data)))
        state, _ = step(state, batch)
        states[fast_rng] = state

    # identical rng evolution: the saved key never depends on the flag, so
    # a checkpoint written under one setting resumes exactly under either
    np.testing.assert_array_equal(
        np.asarray(states[True].rng), np.asarray(states[False].rng)
    )
    # but the masks differed: at least one param leaf moved differently
    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(),
        states[True].params, states[False].params,
    )
    assert max(jax.tree_util.tree_leaves(d)) > 0.0, (
        "fast_dropout_rng flag had no effect on the dropout stream"
    )
