"""Config files are JSON read with the standard library: every shipped
config loads in a process where `yaml` cannot be imported, overrides parse
as JSON with the bare text as fallback, and the compile-cache rule follows
JAX_COMPILATION_CACHE_DIR."""

import glob
import json
import os
import subprocess
import sys

import pytest

from jiao_liao_asr.utils import compile_cache
from jiao_liao_asr.utils.config import (
    ExperimentConfig,
    apply_overrides,
    load_config,
    parse_override_value,
    save_config,
    to_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))

BLOCK_YAML = """
import sys
class _NoYaml:
    def find_spec(self, name, path=None, target=None):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("yaml is blocked")
sys.meta_path.insert(0, _NoYaml())
"""


def test_configs_are_json():
    assert len(CONFIGS) == 6
    assert not glob.glob(os.path.join(ROOT, "configs", "*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_without_yaml(path):
    code = BLOCK_YAML + f"""
from jiao_liao_asr.utils.config import load_config
cfg = load_config({path!r})
import jiao_liao_asr.models.bundle, jiao_liao_asr.train.engine, jiao_liao_asr.cli
assert "yaml" not in sys.modules
print(cfg.model_family)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == json.load(open(path)).get("model_family", "ctc")


@pytest.mark.parametrize("raw,want", [
    ("3", 3),
    ("2.5e-4", 2.5e-4),
    ("true", True),
    ("null", None),
    ("[1, 2]", [1, 2]),
    ('"quoted"', "quoted"),
    ("greedy", "greedy"),
    ("", ""),
])
def test_override_value_parsing(raw, want):
    assert parse_override_value(raw) == want


def test_overrides_apply_and_unknown_keys_fail():
    cfg = apply_overrides(ExperimentConfig(), [
        "model_family=whisper", "train.optimizer.learning_rate=3e-5",
        "data.bucket_boundaries_seconds=[4, 8]", "ctc_model.adapter.kind=wf",
    ])
    assert cfg.model_family == "whisper"
    assert cfg.train.optimizer.learning_rate == 3e-5
    assert cfg.data.bucket_boundaries_seconds == (4, 8)
    assert cfg.ctc_model.adapter.kind == "wf"
    with pytest.raises(KeyError):
        apply_overrides(cfg, ["train.no_such_key=1"])
    with pytest.raises(ValueError):
        apply_overrides(cfg, ["train.seed"])


def test_save_load_round_trip(tmp_path):
    cfg = apply_overrides(ExperimentConfig(), ["whisper.prompt_ids=[1, 2]"])
    save_config(cfg, str(tmp_path / "c.json"))
    assert to_dict(load_config(str(tmp_path / "c.json"))) == to_dict(cfg)


def test_load_ignores_keys_no_longer_in_the_dataclasses(tmp_path):
    p = tmp_path / "old.json"
    p.write_text(json.dumps({"frontend": {"use_pallas": True, "num_mels": 128}}))
    assert load_config(str(p)).frontend.num_mels == 128


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # set in the environment: nothing is set in code
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored
