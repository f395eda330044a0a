"""Every config field must be consumed somewhere (a config that silently
ignores values is a correctness trap).

The static check walks every dataclass field and requires its name to appear
in non-config source; the behavioral checks prove the previously-dead knobs
actually change behavior.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jiao_liao_asr.utils import config as C

PKG = pathlib.Path(C.__file__).resolve().parents[1]


def _non_config_source() -> str:
    src = []
    for p in PKG.rglob("*.py"):
        if p.name != "config.py":
            src.append(p.read_text(encoding="utf-8"))
    root = PKG.parent
    for extra in ("__graft_entry__.py", "bench.py"):
        f = root / extra
        if f.exists():
            src.append(f.read_text(encoding="utf-8"))
    return "\n".join(src)


def test_every_config_field_is_consumed():
    src = _non_config_source()
    missing = []
    for cls in [
        C.FrontendConfig, C.SpecAugmentConfig, C.AugmentConfig,
        C.AdapterConfig, C.CTCModelConfig, C.WhisperConfig, C.MeshConfig,
        C.DataConfig, C.OptimizerConfig, C.TrainConfig, C.DecodeConfig,
        C.DialectStage, C.ExperimentConfig,
    ]:
        for f in dataclasses.fields(cls):
            if f.name not in src:
                missing.append(f"{cls.__name__}.{f.name}")
    assert not missing, f"config fields consumed nowhere: {missing}"


def test_subsample_factor_consumed():
    from jiao_liao_asr.models.ctc_model import CTCEncoderModel

    base = dict(vocab_size=12, d_model=32, num_layers=1, num_heads=2,
                mlp_dim=64, conv_channels=16, dtype="float32")
    feats = jnp.zeros((1, 80, 64), jnp.float32)
    for factor, t_out in [(2, 32), (4, 16), (8, 8)]:
        model = CTCEncoderModel(C.CTCModelConfig(subsample_factor=factor, **base))
        params = model.init(jax.random.PRNGKey(0), feats)["params"]
        lp, lens = model.apply({"params": params}, feats, jnp.asarray([64]))
        assert lp.shape[1] == t_out, (factor, lp.shape)
        assert int(lens[0]) == t_out
    with pytest.raises(ValueError, match="power of 2"):
        model = CTCEncoderModel(C.CTCModelConfig(subsample_factor=3, **base))
        model.init(jax.random.PRNGKey(0), feats)


def test_max_frames_enforced():
    from jiao_liao_asr.models.ctc_model import CTCEncoderModel

    cfg = C.CTCModelConfig(
        vocab_size=12, d_model=32, num_layers=1, num_heads=2, mlp_dim=64,
        conv_channels=16, dtype="float32", max_frames=32,
    )
    model = CTCEncoderModel(cfg)
    with pytest.raises(ValueError, match="max_frames"):
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64), jnp.float32))


def test_whisper_max_source_positions_enforced():
    from jiao_liao_asr.models.whisper import WhisperModel

    cfg = C.WhisperConfig(
        vocab_size=32, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=2, mlp_dim=64, max_source_positions=8, dtype="float32",
    )
    model = WhisperModel(cfg)
    with pytest.raises(ValueError, match="max_source_positions"):
        model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 80, 64), jnp.float32),
            jnp.zeros((1, 4), jnp.int32),
        )


def test_dialect_weights_mixing(tmp_path, rng):
    """run_experiment's dialect_weights groups rows by manifest dialect tag
    and samples a weighted mixture (verified at the mixer level)."""
    from jiao_liao_asr.data.manifest import Manifest, ManifestRow
    from jiao_liao_asr.data.pipeline import mix_manifests

    rows_a = [ManifestRow(f"a{i}.wav", "甲", 1.0, "jiaoliao") for i in range(10)]
    rows_b = [ManifestRow(f"b{i}.wav", "乙", 1.0, "neighbor") for i in range(10)]
    mixed = mix_manifests(
        {"jiaoliao": Manifest(rows_a), "neighbor": Manifest(rows_b)},
        {"jiaoliao": 9.0, "neighbor": 1.0},
    )
    frac_a = sum(1 for r in mixed.rows if r.dialect == "jiaoliao") / len(mixed)
    assert frac_a > 0.7
