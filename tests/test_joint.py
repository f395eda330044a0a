"""Joint CTC/attention model (models/joint.py, SURVEY C8) — structure,
hybrid loss, cached-decode parity, and joint decoding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jiao_liao_asr.models.joint import JointCTCAttentionModel
from jiao_liao_asr.utils.config import (
    AdapterConfig,
    DataConfig,
    ExperimentConfig,
    FrontendConfig,
    JointModelConfig,
    SpecAugmentConfig,
)


def tiny_cfg(**kw):
    base = dict(
        vocab_size=32, d_model=32, num_layers=2, decoder_layers=2,
        num_heads=2, mlp_dim=64, conv_channels=16, dropout=0.0,
        dtype="float32", max_target_positions=32,
    )
    base.update(kw)
    return JointModelConfig(**base)


def init_model(cfg, B=2, T=64, S=6, seed=0):
    model = JointCTCAttentionModel(cfg)
    rng = np.random.RandomState(seed)
    feats = jnp.asarray(rng.randn(B, cfg.num_mels, T).astype(np.float32))
    flens = jnp.asarray([T, T // 2], jnp.int32)[:B]
    toks = jnp.asarray(rng.randint(2, cfg.vocab_size, (B, S)), jnp.int32)
    toks = toks.at[:, 0].set(0)  # sos
    params = model.init(jax.random.PRNGKey(seed), feats, flens, toks)["params"]
    return model, params, feats, flens, toks


def test_joint_forward_shapes():
    cfg = tiny_cfg()
    model, params, feats, flens, toks = init_model(cfg)
    ctc_lp, out_lens, dec_logits = model.apply(
        {"params": params}, feats, flens, toks, deterministic=True
    )
    B, S = toks.shape
    assert ctc_lp.shape == (B, 64 // cfg.subsample_factor, cfg.vocab_size)
    assert dec_logits.shape == (B, S, cfg.vocab_size)
    # log-probs normalized
    np.testing.assert_allclose(
        np.asarray(jnp.exp(ctc_lp).sum(-1)), 1.0, atol=1e-4
    )
    assert int(out_lens[0]) == 64 // cfg.subsample_factor


@pytest.mark.heavy
def test_joint_decode_step_matches_teacher_forced():
    """Incremental KV-cached decode must reproduce teacher-forced logits —
    the AttAdapter-parity discipline applied to the joint family."""
    for kind in ("none", "wf", "att", "bottleneck"):
        cfg = tiny_cfg(adapter=AdapterConfig(
            kind=kind, wf_rank=2, bottleneck_dim=8, att_num_heads=1, att_key_dim=8,
        ))
        model, params, feats, flens, toks = init_model(cfg, seed=3)
        # make adapters non-trivial: zero-init adapters are identity
        if kind != "none":
            params = jax.tree_util.tree_map(
                lambda x: x + 0.02 * np.random.RandomState(0).randn(*x.shape).astype(x.dtype)
                if x.ndim >= 1 else x,
                params,
            )
        enc, enc_lens = model.apply(
            {"params": params}, feats, flens, method=model.encode
        )
        tf_logits = model.apply(
            {"params": params}, toks, enc, enc_lens, method=model.decode_teacher
        )
        B, S = toks.shape
        caches = model.apply(
            {"params": params}, B, enc, S, method=model.init_cache
        )
        step_logits = []
        for pos in range(S):
            lg, caches = model.apply(
                {"params": params}, toks[:, pos : pos + 1], jnp.int32(pos),
                enc, caches, enc_lens, method=model.decode_step,
            )
            step_logits.append(lg)
        step_logits = jnp.stack(step_logits, axis=1)
        np.testing.assert_allclose(
            np.asarray(step_logits), np.asarray(tf_logits), atol=2e-4,
            err_msg=f"adapter={kind}",
        )


def test_joint_loss_and_train_step():
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.train.engine import (
        batch_to_device,
        build_train_setup,
        init_state,
    )
    from jiao_liao_asr.data.pipeline import Batch

    config = ExperimentConfig(
        model_family="joint",
        joint=tiny_cfg(ctc_weight=0.3),
        frontend=FrontendConfig(chunk_seconds=1.0),
        specaugment=SpecAugmentConfig(enabled=False),
    )
    params = ModelBundle._init_params(config)
    model, loss_fn, tx, jitted_step = build_train_setup(config, params)
    state = init_state(config, tx, params)

    rng = np.random.RandomState(0)
    B, n = 2, 8000
    host = Batch(
        audio=rng.randn(B, n).astype(np.float32) * 0.1,
        audio_lengths=np.full((B,), n, np.int32),
        labels=rng.randint(2, 32, (B, 5)).astype(np.int32),
        label_lengths=np.full((B,), 5, np.int32),
        texts=[""] * B,
        bucket_seconds=0.5,
    )
    batch = batch_to_device(host, family="joint")
    # sos/eos convention: tokens start with blank 0, targets end with 0
    assert int(batch["tokens"][0, 0]) == 0
    tgt = np.asarray(batch["targets"][0])
    assert tgt[4] == host.labels[0, 4] and tgt[5] == 0

    losses = []
    for _ in range(4):
        state, metrics = jitted_step(state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
        assert {"loss", "loss_ctc", "loss_att"} <= set(metrics)
    w = config.joint.ctc_weight
    np.testing.assert_allclose(
        losses[-1],
        w * float(metrics["loss_ctc"]) + (1 - w) * float(metrics["loss_att"]),
        rtol=1e-5,
    )
    assert losses[-1] < losses[0]  # optimizing the joint objective


def test_joint_greedy_and_beam_decode():
    from jiao_liao_asr.decode.joint_generate import (
        joint_beam,
        joint_greedy,
    )

    cfg = tiny_cfg()
    model, params, feats, flens, _ = init_model(cfg, seed=1)
    gen, lens = joint_greedy(model, params, feats, flens, max_len=10)
    assert gen.shape == (2, 9) and lens.shape == (2,)
    assert np.all(np.asarray(lens) <= 9)

    # beam with ctc_weight=0 = pure attention beam; beam_size=1 == greedy
    gen_b1, lens_b1 = joint_beam(
        model, params, feats, flens, beam_size=1, max_len=10, ctc_weight=0.0
    )
    np.testing.assert_array_equal(np.asarray(gen_b1), np.asarray(gen))

    # joint rescoring runs and returns one of the K beams
    gen_j, lens_j = joint_beam(
        model, params, feats, flens, beam_size=3, max_len=10, ctc_weight=0.5
    )
    assert gen_j.shape == (2, 9)
    assert np.all(np.asarray(lens_j) <= 9)


def test_joint_bundle_transcribe_all_strategies():
    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models.bundle import ModelBundle

    tok = CharTokenizer.build(["你好世界测试"])
    config = ExperimentConfig(
        model_family="joint",
        joint=tiny_cfg(vocab_size=len(tok)),
        frontend=FrontendConfig(chunk_seconds=1.0),
    )
    config.decode.max_decode_len = 8
    bundle = ModelBundle.load(config=config, tokenizer=tok)
    wav = np.random.RandomState(0).randn(2, 16000).astype(np.float32) * 0.1
    for strategy in ("greedy", "beam", "ctc_greedy"):
        dc = dataclasses.replace(config.decode, strategy=strategy, beam_size=2)
        texts = bundle.transcribe(wav, decode_cfg=dc)
        assert len(texts) == 2 and all(isinstance(t, str) for t in texts)


def test_joint_train_loop_e2e(tmp_path):
    """run_experiment with model_family=joint end to end: corpus -> hybrid
    training -> checkpoint; attention decode overfits a 2-utterance corpus."""
    from jiao_liao_asr.data import ManifestRow, write_manifest
    from jiao_liao_asr.frontend.audio_io import write_wav
    from jiao_liao_asr.train.engine import run_experiment

    rng = np.random.RandomState(0)
    rows = []
    for i, text in enumerate(["你好", "世界"]):
        sr, dur = 16000, 0.5
        n = int(sr * dur)
        wav = 0.3 * np.sin(2 * np.pi * (300 + 200 * i) * np.arange(n) / sr)
        wav += 0.01 * rng.randn(n)
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), wav.astype(np.float32), sr)
        rows.append(ManifestRow(audio=str(p), text=text, duration=dur, dialect="d"))
    man = tmp_path / "train.jsonl"
    write_manifest(rows, str(man))

    config = ExperimentConfig(
        model_family="joint",
        joint=tiny_cfg(num_layers=1, decoder_layers=1, ctc_weight=0.5),
        frontend=FrontendConfig(chunk_seconds=0.5),
        specaugment=SpecAugmentConfig(enabled=False),
        data=DataConfig(
            train_manifest=str(man), batch_size=2,
            bucket_boundaries_seconds=(0.5,), max_text_len=4,
        ),
    )
    config.train.optimizer.total_steps = 150
    config.train.optimizer.learning_rate = 3e-3
    config.train.optimizer.warmup_steps = 10
    config.train.checkpoint_dir = str(tmp_path / "ckpt")
    config.train.metrics_path = str(tmp_path / "m.jsonl")
    config.decode.max_decode_len = 6

    state, bundle = run_experiment(config)
    texts = bundle.transcribe([r.audio for r in rows])
    assert texts == ["你好", "世界"], texts
