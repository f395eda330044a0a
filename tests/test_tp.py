"""Tensor-parallel whisper training step on the virtual mesh: TP+DP
sharded step == single-device step, and kernels really shard over 'model'."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.parallel.mesh import (
    batch_sharding,
    build_mesh,
    replicated,
)
from jiao_liao_asr.parallel.tp_rules import tp_param_sharding
from jiao_liao_asr.train.engine import (
    build_train_setup,
    init_state,
)
from jiao_liao_asr.utils.config import (
    ExperimentConfig,
    MeshConfig,
    OptimizerConfig,
    SpecAugmentConfig,
    WhisperConfig,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual CPU devices"
)

CFG = ExperimentConfig(
    model_family="whisper",
    whisper=WhisperConfig(
        vocab_size=64, d_model=64, encoder_layers=1, decoder_layers=1,
        num_heads=4, mlp_dim=128, max_target_positions=32, dtype="float32",
        max_source_positions=64,
    ),
    specaugment=SpecAugmentConfig(enabled=False),
)


def _batch(rng, B=8, samples=8000, V=64, S=5):
    from jiao_liao_asr.data.pipeline import Batch
    from jiao_liao_asr.train.engine import batch_to_device

    host = Batch(
        audio=rng.randn(B, samples).astype(np.float32) * 0.1,
        audio_lengths=np.full((B,), samples, np.int32),
        labels=rng.randint(3, V, (B, S)).astype(np.int32),
        label_lengths=np.full((B,), S, np.int32),
        texts=[""] * B,
        bucket_seconds=0.5,
    )
    return batch_to_device(host, family="whisper", whisper_prompt=(1, 2), eot_id=0)


def test_tp_sharding_rules():
    mesh = build_mesh(MeshConfig(model_axis=2), jax.devices())
    params = ModelBundle._init_params(CFG)
    sh = tp_param_sharding(mesh, params)
    flat = jax.tree_util.tree_leaves_with_path(sh)
    specs = {
        "/".join(str(getattr(k, "key", k)) for k in kp): s.spec for kp, s in flat
    }
    col = [k for k, s in specs.items() if tuple(s) == (None, "model")]
    row = [k for k, s in specs.items() if tuple(s) == ("model", None)]
    assert any("fc1" in k for k in col)
    assert any("q_proj" in k for k in col)
    assert any("fc2" in k for k in row)
    assert any("out_proj" in k for k in row)
    assert any("embedding" in k for k in row)


def test_tp_step_matches_single_device(rng):
    cfg = dataclasses.replace(CFG)
    cfg.train.optimizer = OptimizerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=5, schedule="constant"
    )
    batch = _batch(rng)

    params = ModelBundle._init_params(cfg)
    _, _, tx, step = build_train_setup(cfg, params)
    st = init_state(cfg, tx, params)
    st1, m1 = step(st, batch)

    params2 = ModelBundle._init_params(cfg)
    mesh = build_mesh(MeshConfig(model_axis=2), jax.devices())  # data=4, model=2
    _, _, tx2, step2 = build_train_setup(cfg, params2, mesh)
    st2 = init_state(cfg, tx2, params2)
    psh = tp_param_sharding(mesh, st2.params)
    st2 = st2.replace(
        params=jax.tree_util.tree_map(jax.device_put, st2.params, psh),
        opt_state=jax.device_put(st2.opt_state, replicated(mesh)),
        step=jax.device_put(st2.step, replicated(mesh)),
        rng=jax.device_put(st2.rng, replicated(mesh)),
    )
    bsh = batch_sharding(mesh)
    st2, m2 = step2(st2, {k: jax.device_put(v, bsh) for k, v in batch.items()})

    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-5
    d = jax.tree_util.tree_map(
        lambda a, b: np.abs(np.asarray(a) - np.asarray(b)).max(), st1.params, st2.params
    )
    assert max(jax.tree_util.tree_leaves(d)) < 1e-4


def test_tp_greedy_decode_matches_single_device(rng):
    """Megatron-TP-sharded whisper greedy decode (serving path) produces
    the same tokens as unsharded decode: params sharded over 'model' +
    'fsdp', inputs over 'data', XLA propagates through the KV-cached
    while_loop."""
    from jiao_liao_asr.decode.whisper_generate import (
        greedy_generate,
    )
    from jiao_liao_asr.models.whisper import WhisperModel
    from jiao_liao_asr.parallel.mesh import (
        build_mesh,
        shard_batch,
    )
    from jiao_liao_asr.parallel.tp_rules import (
        fsdp_tp_sharding,
    )

    model = WhisperModel(CFG.whisper)
    params = ModelBundle._init_params(CFG)
    mel = jnp.asarray(rng.randn(4, 80, 64).astype(np.float32) * 0.3)

    run = jax.jit(
        lambda p, m: greedy_generate(
            model, p, m, max_len=10, prompt=(1, 2), eot_id=0
        )
    )
    gen1, len1 = run(params, mel)

    mesh = build_mesh(MeshConfig(data_axis=2, fsdp_axis=2, model_axis=2),
                      jax.devices())
    psh = fsdp_tp_sharding(mesh, params)
    params_s = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, s), params, psh
    )
    mel_s = shard_batch(mesh, mel)
    gen2, len2 = run(params_s, mel_s)
    np.testing.assert_array_equal(np.asarray(len1), np.asarray(len2))
    np.testing.assert_array_equal(np.asarray(gen1), np.asarray(gen2))


def test_bundle_sharded_transcribe_matches_unsharded(tmp_path, rng):
    """ModelBundle.shard(): mesh-sharded inference through the public
    transcribe path returns the same texts as unsharded."""
    import dataclasses as dc

    from jiao_liao_asr.frontend.audio_io import write_wav
    from jiao_liao_asr.parallel.mesh import build_mesh

    cfg = dc.replace(CFG)
    cfg.frontend = dc.replace(cfg.frontend, chunk_seconds=0.5)
    wav = (0.2 * np.sin(2 * np.pi * 300 * np.arange(8000) / 16000)).astype(
        np.float32
    )
    p = tmp_path / "u.wav"
    write_wav(str(p), wav, 16000)

    from jiao_liao_asr.data.tokenizer import CharTokenizer

    tok = CharTokenizer.build(["abc def"])
    params = ModelBundle._init_params(cfg)
    b1 = ModelBundle(config=cfg, params=params, tokenizer=tok)
    t1 = b1.transcribe([str(p)])

    b2 = ModelBundle(config=cfg, params=params, tokenizer=tok)
    b2.shard(build_mesh(MeshConfig(data_axis=2, fsdp_axis=2, model_axis=2),
                        jax.devices()))
    assert b2.mesh is not None
    t2 = b2.transcribe([str(p)])
    assert t1 == t2


@pytest.mark.parametrize("entry", ["transcribe", "transcribe_timed"])
def test_bundle_sharded_entry_points_attend_per_shard(entry, rng):
    """A sharded bundle's entry points trace under its mesh: every attention
    call runs on one device's block (batch over data x fsdp, heads over
    model) and the result is that of the unsharded bundle."""
    import dataclasses as dc

    from jiao_liao_asr.data.tokenizer import CharTokenizer
    from jiao_liao_asr.models import layers

    cfg = dc.replace(CFG)
    cfg.frontend = dc.replace(cfg.frontend, chunk_seconds=0.5)
    wavs = [(0.2 * np.sin(2 * np.pi * f * np.arange(8000) / 16000)).astype(np.float32)
            for f in (200, 300, 450, 600)]
    tok = CharTokenizer.build(["abc def"])
    params = ModelBundle._init_params(cfg)
    want = getattr(ModelBundle(config=cfg, params=params, tokenizer=tok), entry)(wavs, 16000)
    b = ModelBundle(config=cfg, params=params, tokenizer=tok)
    b.shard(build_mesh(MeshConfig(data_axis=2, fsdp_axis=2, model_axis=2), jax.devices()))
    with layers.record_attention_choices() as seen:
        got = getattr(b, entry)(wavs, 16000)
    assert got == want
    H = cfg.whisper.num_heads
    assert seen and {(c[1][0], c[1][2]) for c in seen} == {(1, H // 2)}


def test_opt_state_tp_sharding_through_production_entry():
    """parallel.mesh.opt_state_sharding (what train_loop's shard_state
    uses) applies the Megatron TP rules to Adam mu/nu on a model-axis>1
    mesh — optimizer shards stay aligned with their params, including with
    an adapters-only masked optimizer in the tree."""
    import dataclasses as dc

    from jiao_liao_asr.parallel.mesh import (
        opt_state_sharding,
        param_sharding,
    )
    from jiao_liao_asr.utils.config import AdapterConfig

    mesh = build_mesh(MeshConfig(data_axis=2, fsdp_axis=2, model_axis=2),
                      jax.devices())

    def model_sharded(tree):
        return sum(
            1 for _, s in jax.tree_util.tree_flatten_with_path(tree)[0]
            if "model" in str(s.spec)
        )

    # full fine-tune: Adam mu/nu carry the param path as a suffix, so the
    # backbone kernels' TP specs must reappear in the optimizer state
    cfg = dc.replace(CFG)
    params = ModelBundle._init_params(cfg)
    _, _, tx, _ = build_train_setup(cfg, params, mesh)
    state = init_state(cfg, tx, params)
    n_p = model_sharded(param_sharding(mesh, state.params))
    n_o = model_sharded(opt_state_sharding(mesh, state.opt_state))
    assert n_p > 0, "no param got a TP spec"
    assert n_o >= 2 * n_p, (n_o, n_p)  # mu and nu per TP'd kernel

    # adapters-only masked optimizer: tracks only the (small, correctly
    # replicated) WF factors — the rules must traverse MaskedNode leaves
    # without crashing and shard the PARAMS regardless
    cfg2 = dc.replace(CFG)
    cfg2.whisper = dc.replace(
        CFG.whisper, adapter=AdapterConfig(kind="wf", wf_rank=4)
    )
    cfg2.train.train_adapters_only = True
    params2 = ModelBundle._init_params(cfg2)
    _, _, tx2, _ = build_train_setup(cfg2, params2, mesh)
    state2 = init_state(cfg2, tx2, params2)
    assert model_sharded(param_sharding(mesh, state2.params)) > 0
    opt_state_sharding(mesh, state2.opt_state)  # no crash on masked tree
