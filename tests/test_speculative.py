"""CTC-draft speculative greedy decoding (decode/speculative.py).

The load-bearing property is EXACTNESS: spec_greedy must emit the same text
as the sequential attention greedy decode for every utterance, whatever the
draft quality — a perfect draft only changes how many verification passes
it takes. Tested here on the f32 CPU path at three draft regimes (the real
CTC draft from a random-init head = adversarially bad; an injected perfect
draft; an empty draft), plus the pass-count mechanics that make it fast.
"""

import jax
import jax.numpy as jnp
import numpy as np

from jiao_liao_asr.decode.joint_generate import joint_greedy
from jiao_liao_asr.decode.speculative import (
    joint_spec_greedy,
    spec_greedy_from_enc,
)
from jiao_liao_asr.models.joint import JointCTCAttentionModel
from jiao_liao_asr.utils.config import JointModelConfig

MAX_LEN = 16


def tiny_cfg(**kw):
    base = dict(
        vocab_size=32, d_model=32, num_layers=2, decoder_layers=2,
        num_heads=2, mlp_dim=64, conv_channels=16, dropout=0.0,
        dtype="float32", max_target_positions=32,
    )
    base.update(kw)
    return JointModelConfig(**base)


def setup(B=3, T=64, seed=0):
    cfg = tiny_cfg()
    model = JointCTCAttentionModel(cfg)
    rng = np.random.RandomState(seed)
    feats = jnp.asarray(rng.randn(B, cfg.num_mels, T).astype(np.float32))
    flens = jnp.asarray([T, T // 2, T][:B], jnp.int32)
    toks = jnp.asarray(rng.randint(2, cfg.vocab_size, (B, 6)), jnp.int32)
    toks = toks.at[:, 0].set(0)
    params = model.init(jax.random.PRNGKey(seed), feats, flens, toks)["params"]
    return model, params, feats, flens


def _texts(gen, lens):
    gen, lens = np.asarray(gen), np.asarray(lens)
    return [tuple(int(t) for t in row[: int(n)]) for row, n in zip(gen, lens)]


def test_spec_matches_greedy_with_random_ctc_draft():
    # random-init CTC head -> a garbage draft: worst case for acceptance,
    # must still reproduce the greedy text exactly
    model, params, feats, flens = setup()
    gen_g, len_g = jax.jit(
        lambda p, f, fl: joint_greedy(model, p, f, fl, max_len=MAX_LEN)
    )(params, feats, flens)
    gen_s, len_s, passes = jax.jit(
        lambda p, f, fl: joint_spec_greedy(
            model, p, f, fl, max_len=MAX_LEN, return_passes=True
        )
    )(params, feats, flens)
    assert _texts(gen_s, len_s) == _texts(gen_g, len_g)
    assert 1 <= int(passes) <= MAX_LEN - 1


def test_perfect_draft_verifies_in_one_pass():
    # inject the greedy output itself as the draft: one teacher-forced pass
    # must confirm everything (the speedup mechanism, deterministically)
    model, params, feats, flens = setup(seed=1)
    enc, enc_lengths = model.apply(
        {"params": params}, feats, flens, method=model.encode
    )
    from jiao_liao_asr.decode.whisper_generate import (
        greedy_from_enc,
    )

    gen_g, len_g = greedy_from_enc(
        model, params, enc, enc_lengths, max_len=MAX_LEN, prompt=(0,), eot_id=0
    )
    gen_s, len_s, passes = spec_greedy_from_enc(
        model, params, enc, enc_lengths, gen_g, len_g,
        max_len=MAX_LEN, return_passes=True,
    )
    assert _texts(gen_s, len_s) == _texts(gen_g, len_g)
    # every token matches -> each row closes on its verified eos (or the
    # length cap) in the first pass; a second pass would mean a mismatch
    assert int(passes) == 1
    # padded tail is canonical eos, not stale draft
    gen_s = np.asarray(gen_s)
    for row, n in zip(gen_s, np.asarray(len_s)):
        assert (row[int(n):] == 0).all()


def test_empty_draft_degenerates_to_greedy():
    model, params, feats, flens = setup(seed=2)
    enc, enc_lengths = model.apply(
        {"params": params}, feats, flens, method=model.encode
    )
    from jiao_liao_asr.decode.whisper_generate import (
        greedy_from_enc,
    )

    gen_g, len_g = greedy_from_enc(
        model, params, enc, enc_lengths, max_len=MAX_LEN, prompt=(0,), eot_id=0
    )
    B = enc.shape[0]
    empty = jnp.zeros((B, 1), jnp.int32)
    gen_s, len_s, passes = spec_greedy_from_enc(
        model, params, enc, enc_lengths, empty, jnp.zeros((B,), jnp.int32),
        max_len=MAX_LEN, return_passes=True,
    )
    assert _texts(gen_s, len_s) == _texts(gen_g, len_g)
    # with nothing to accept, each pass advances exactly one frontier token:
    # pure AR via parallel passes (the documented worst case)
    assert int(passes) == int(np.asarray(len_g).max()) + 1 or int(passes) == MAX_LEN - 1


def test_bundle_spec_greedy_strategy():
    # the ModelBundle 'spec_greedy' strategy emits the same texts as 'greedy'
    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.utils.config import (
        DecodeConfig,
        ExperimentConfig,
    )

    cfg = ExperimentConfig(model_family="joint", joint=tiny_cfg())
    cfg.decode = DecodeConfig(strategy="greedy", max_decode_len=MAX_LEN)
    params = ModelBundle._init_params(cfg, seed=3)
    rng = np.random.RandomState(3)
    feats = jnp.asarray(rng.randn(2, cfg.joint.num_mels, 64).astype(np.float32))
    flens = jnp.asarray([64, 32], jnp.int32)

    from jiao_liao_asr.models.bundle import _joint_generate_fn_for

    g = _joint_generate_fn_for(cfg, cfg.decode)(params, feats, flens)
    cfg.decode.strategy = "spec_greedy"
    s = _joint_generate_fn_for(cfg, cfg.decode)(params, feats, flens)
    assert _texts(*s) == _texts(*g)
