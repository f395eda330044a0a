"""Streaming-matched limited-context attention (CTCModelConfig.
attention_left_context / attention_right_context / position_mode).

Pins three properties:

* banded_length_mask builds the right band;
* a limited-context encoder's output at frame t is INDEPENDENT of inputs
  beyond its band (+ the conv subsampler's 1-frame receptive slack) — the
  contract that makes early streaming commits safe;
* the headline guarantee: with position_mode="none" (shift-invariant
  encoder) and local features (whisper_norm off), sliding-window streaming
  reproduces the OFFLINE transcription exactly once window/lookahead cover
  the band — the train/serve consistency that examples/streaming_quality.py
  measures the lack of for offline-trained models.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.data.tokenizer import CharTokenizer
from jiao_liao_asr.models.bundle import ModelBundle
from jiao_liao_asr.models.ctc_model import CTCEncoderModel
from jiao_liao_asr.models.layers import banded_length_mask
from jiao_liao_asr.utils.config import (
    CTCModelConfig,
    ExperimentConfig,
)

SR = 16000


def test_banded_length_mask_values():
    m = np.asarray(banded_length_mask(jnp.asarray([4, 6]), 6, left=1, right=2))
    assert m.shape == (2, 1, 6, 6)
    # row q=2, batch 0 (length 4): keys 1..4 allowed by band, key 4+ invalid
    assert m[0, 0, 2].tolist() == [False, True, True, True, False, False]
    assert m[1, 0, 2].tolist() == [False, True, True, True, True, False]
    # unbounded sides
    full = np.asarray(banded_length_mask(jnp.asarray([6]), 6, -1, -1))
    assert full.all()
    left_only = np.asarray(banded_length_mask(jnp.asarray([6]), 6, 2, -1))
    assert left_only[0, 0, 4].tolist() == [False, False, True, True, True, True]


def _model(left, right, position_mode="none"):
    cfg = CTCModelConfig(
        vocab_size=8, d_model=32, num_layers=2, num_heads=2, mlp_dim=64,
        conv_channels=16, dtype="float32", dropout=0.0, attention_left_context=left,
        attention_right_context=right, position_mode=position_mode,
    )
    model = CTCEncoderModel(cfg)
    feats = jnp.zeros((1, 80, 64), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), feats)["params"]
    return model, params


def test_limited_context_independence():
    """Logits at frame t must not change when features beyond t + right +
    conv-slack change (and symmetrically for the left side)."""
    model, params = _model(left=4, right=2)
    rng = np.random.RandomState(0)
    base = rng.randn(1, 80, 64).astype(np.float32)
    # frame t=6 (enc) -> mel frames <= 4*(6+2)+3 = 35 influence it; perturb
    # from mel 40 on (enc frame 10 = t + right + slack(2))
    pert = base.copy()
    pert[:, :, 40:] += rng.randn(1, 80, 24).astype(np.float32)
    lp0, _ = model.apply({"params": params}, jnp.asarray(base))
    lp1, _ = model.apply({"params": params}, jnp.asarray(pert))
    np.testing.assert_array_equal(np.asarray(lp0)[0, :6], np.asarray(lp1)[0, :6])
    # sanity: WITHOUT the band the same perturbation changes frame 6
    full_model, full_params = _model(left=-1, right=-1)
    f0, _ = full_model.apply({"params": full_params}, jnp.asarray(base))
    f1, _ = full_model.apply({"params": full_params}, jnp.asarray(pert))
    assert np.abs(np.asarray(f0)[0, :6] - np.asarray(f1)[0, :6]).max() > 0

    # left side: enc frame 20 with left=4 ignores mels < 4*(20-4)-3 = 61
    pert_l = base.copy()
    pert_l[:, :, :48] += rng.randn(1, 80, 48).astype(np.float32)  # < enc 12
    lp2, _ = model.apply({"params": params}, jnp.asarray(pert_l))
    np.testing.assert_array_equal(
        np.asarray(lp0)[0, 20:22], np.asarray(lp2)[0, 20:22]
    )


def test_streaming_matches_offline_exactly_with_band():
    """The guarantee limited-context training buys: sliding-window streamed
    text == offline text, bit for bit, on ANY audio (random-init model)."""
    from jiao_liao_asr.serve.streaming import (
        StreamingConfig,
        StreamingTranscriber,
    )

    cfg = ExperimentConfig(
        model_family="ctc",
        ctc_model=CTCModelConfig(
            vocab_size=8, d_model=32, num_layers=2, num_heads=2, mlp_dim=64,
            conv_channels=16, dtype="float32", dropout=0.0, attention_left_context=8, attention_right_context=4,
            position_mode="none",
        ),
    )
    cfg.frontend.chunk_seconds = 3.2
    cfg.frontend.whisper_norm = False  # per-window max would break locality
    params = ModelBundle._init_params(cfg)
    bundle = ModelBundle(
        config=cfg, params=params,
        tokenizer=CharTokenizer([chr(0x4E00 + i) for i in range(6)]),
    )
    rng = np.random.RandomState(7)
    for seed in range(3):
        audio = (np.random.RandomState(seed).randn(int(3.2 * SR)) * 0.1
                 ).astype(np.float32)
        offline = bundle.transcribe(audio)[0]
        st = StreamingTranscriber(
            bundle,
            StreamingConfig(window_seconds=1.92, hop_seconds=0.32,
                            lookahead_seconds=0.32),
        )
        # ragged real-time chunks
        cuts = np.sort(rng.randint(1, len(audio), size=5))
        for c in np.split(audio, cuts):
            st.feed(c)
        assert st.finish().text == offline, f"seed {seed}"


def test_position_mode_validation():
    with pytest.raises(ValueError, match="position_mode"):
        _model(-1, -1, position_mode="bogus")
