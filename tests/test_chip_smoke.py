"""chip_smoke.py: every phase at tiny widths on the CPU, the script's exit
on a machine without a GPU, and the same phases at the published widths on
a GPU (gpu-marked)."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from jiao_liao_asr.utils.config import (  # noqa: E402
    CTCModelConfig,
    WhisperConfig,
)

TINY = chip_smoke.Sizes(
    ctc=CTCModelConfig(
        vocab_size=40, d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
        conv_channels=32,
    ),
    whisper=WhisperConfig(
        vocab_size=64, num_mels=128, d_model=64, encoder_layers=1,
        decoder_layers=2, num_heads=4, mlp_dim=128, max_source_positions=100,
        max_target_positions=48, prompt_ids=(60,), eot_id=61,
    ),
    offline_batch=2, offline_secs=1.0, ft_batch=2, ft_secs=2.0, ft_steps=2,
    window_secs=2.0, w_train_batch=2, gen_tokens=6,
    serve_secs=(0.5, 2.0, 1.2), attn_shapes=((2, 16, 2, 8), (2, 24, 4, 16)),
)


@pytest.fixture(scope="module")
def tiny_bundle():
    return chip_smoke.whisper_bundle(TINY, 0)


@pytest.mark.parametrize("phase", ["offline", "finetune", "whisper_train"])
def test_phase_runs_at_tiny_width(phase):
    out = getattr(chip_smoke, f"phase_{phase}")(TINY, 0)
    assert set(out) == {"compile_s", "run_s"}


@pytest.mark.parametrize("phase", ["whisper_generate", "whisper_serve", "compare"])
def test_whisper_phase_runs_at_tiny_width(phase, tiny_bundle):
    out = getattr(chip_smoke, f"phase_{phase}")(TINY, 0, tiny_bundle)
    assert set(out) == {"compile_s", "run_s"}


def test_phase_environment_reports_device(capsys):
    device = chip_smoke.phase_environment()
    assert device["platform"] == "cpu" and device["count"] >= 1
    out = capsys.readouterr().out
    assert "card:" in out and "compile cache" in out and "package yaml" in out


def test_check_fails_over_bound():
    chip_smoke.check("within", 1e-3, 1e-2)
    with pytest.raises(AssertionError, match="over bound"):
        chip_smoke.check("over", 2e-2, 1e-2)


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    assert '"ok": true' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo the
    script exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_full_sizes_keep_published_widths():
    sz = chip_smoke.full_sizes(whisper_layers=4)
    assert (sz.ctc.d_model, sz.ctc.num_layers, sz.ctc.num_heads) == (512, 12, 4)
    assert (sz.ctc.mlp_dim, sz.ctc.vocab_size) == (2048, 4336)
    w = sz.whisper
    assert (w.d_model, w.num_heads, w.mlp_dim, w.num_mels) == (1280, 20, 5120, 128)
    assert w.vocab_size == 51866 and w.encoder_layers == w.decoder_layers == 4
    assert chip_smoke.full_sizes().whisper.encoder_layers == 32


def test_four_card_path_on_four_cpu_devices():
    """--four-cards at tiny widths on 4 virtual CPU devices: both training
    meshes and the sharded inference agree with one device."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {tests!r}]\n"
        "import chip_smoke\n"
        "from test_chip_smoke import TINY\n"
        "chip_smoke.four_cards(TINY, 0)\n"
    ).format(root=ROOT, tests=os.path.join(ROOT, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for phase in ("mesh data2 x fsdp2", "mesh fsdp2 x model2", "sharded inference"):
        assert f"phase {phase}: ok" in r.stdout


def test_int8_agreement_counts_exact_top1():
    rng = np.random.RandomState(0)
    ref = rng.randn(4, 100).astype(np.float32)
    top = ref.argmax(-1)
    got = ref.copy()
    # row 0: a far token overtakes the top one
    got[0, (top[0] + 1) % 100] = ref[0].max() + 5.0
    # row 1: the runner-up of a near tie moves just past the top one: a
    # flip all the same
    second = np.argsort(ref[1])[-2]
    ref[1, second] = ref[1].max() - 0.01
    got[1, second] = ref[1].max() + 0.01
    cos, agree = chip_smoke.int8_agreement(got, ref)
    assert agree == 0.5 and 0.9 < cos < 1.0


@pytest.mark.gpu
def test_one_card_phases_on_gpu(gpu_device):
    chip_smoke.run_one_card(chip_smoke.full_sizes(), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", chip_smoke.full_sizes().attn_shapes)
def test_attention_matches_reference_on_gpu(gpu_device, shape):
    chip_smoke.compare_attention(shape, 0)
