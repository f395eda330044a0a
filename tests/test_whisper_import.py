"""Whisper weight import parity (SURVEY.md §7 step 8): build a random
transformers WhisperForConditionalGeneration locally (no network), export to
safetensors, import into the model, and check logits match torch."""

import numpy as np
import pytest

import jax.numpy as jnp

from jiao_liao_asr.models.whisper import WhisperModel
from jiao_liao_asr.models.whisper_import import (
    hf_state_dict_to_flax,
    load_hf_whisper,
    read_safetensors,
    write_safetensors,
)
from jiao_liao_asr.utils.config import WhisperConfig


def test_safetensors_roundtrip(tmp_path, rng):
    tensors = {
        "a": rng.randn(3, 4).astype(np.float32),
        "b": rng.randint(0, 10, (2, 2)).astype(np.int32),
        "c": rng.randn(5).astype(np.float16),
    }
    p = tmp_path / "x.safetensors"
    write_safetensors(p, tensors)
    back = read_safetensors(p)
    for k in tensors:
        assert np.array_equal(back[k], tensors[k]), k


def test_safetensors_matches_reference_lib(tmp_path, rng):
    """Our reader against the official safetensors writer (installed)."""
    st = pytest.importorskip("safetensors.numpy")
    tensors = {"w": rng.randn(4, 6).astype(np.float32)}
    p = tmp_path / "ref.safetensors"
    st.save_file(tensors, str(p))
    back = read_safetensors(p)
    assert np.array_equal(back["w"], tensors["w"])


@pytest.fixture(scope="module")
def hf_whisper(tmp_path_factory):
    torch = pytest.importorskip("torch")
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    hf_cfg = HFConfig(
        vocab_size=200,
        num_mel_bins=80,
        d_model=64,
        encoder_layers=2,
        decoder_layers=2,
        encoder_attention_heads=4,
        decoder_attention_heads=4,
        encoder_ffn_dim=128,
        decoder_ffn_dim=128,
        max_source_positions=150,
        max_target_positions=32,
        # HF defaults point special ids at the full 51865 vocab; shrink them
        pad_token_id=0,
        bos_token_id=1,
        eos_token_id=2,
        decoder_start_token_id=1,
        suppress_tokens=[],
        begin_suppress_tokens=[],
    )
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    d = tmp_path_factory.mktemp("hfw")
    model.save_pretrained(d, safe_serialization=True)
    return model, hf_cfg, d


def test_whisper_import_logit_parity(hf_whisper, rng):
    torch = pytest.importorskip("torch")
    model_t, hf_cfg, ckpt_dir = hf_whisper

    cfg = WhisperConfig(
        vocab_size=200, num_mels=80, d_model=64, encoder_layers=2,
        decoder_layers=2, num_heads=4, mlp_dim=128, max_source_positions=150,
        max_target_positions=32, dtype="float32", )
    params = load_hf_whisper(ckpt_dir, cfg)

    mel = rng.randn(1, 80, 300).astype(np.float32) * 0.5
    toks = np.array([[3, 17, 44, 160]], np.int64)

    with torch.no_grad():
        ref = model_t(
            input_features=torch.tensor(mel), decoder_input_ids=torch.tensor(toks)
        ).logits.numpy()

    import jax

    model_j = WhisperModel(cfg)
    # full f32 matmuls for the parity check (the default JAX matmul precision
    # is bf16-grade, which alone costs ~2e-3 on logits)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(
            model_j.apply(
                {"params": params}, jnp.asarray(mel), jnp.asarray(toks.astype(np.int32))
            )
        )
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err < 2e-4, f"logit mismatch {err}"


def test_generate_token_parity_with_transformers(hf_whisper, rng):
    """BASELINE text-level parity: our lax.while_loop greedy decode produces
    the same token sequence as transformers' generate() on the same imported
    weights and mel input."""
    torch = pytest.importorskip("torch")
    import jax

    from jiao_liao_asr.decode.whisper_generate import greedy_generate
    from jiao_liao_asr.models.whisper import WhisperModel

    model_t, hf_cfg, ckpt_dir = hf_whisper
    cfg = WhisperConfig(
        vocab_size=200, num_mels=80, d_model=64, encoder_layers=2,
        decoder_layers=2, num_heads=4, mlp_dim=128, max_source_positions=150,
        max_target_positions=32, dtype="float32", )
    params = load_hf_whisper(ckpt_dir, cfg)

    mel = rng.randn(2, 80, 300).astype(np.float32) * 0.5
    max_new = 12

    with torch.no_grad():
        ref_ids = model_t.generate(
            input_features=torch.tensor(mel),
            max_new_tokens=max_new,
            do_sample=False,
            num_beams=1,
        ).numpy()
    # HF output row: [decoder_start(=1), generated..., eos?(=2)]

    model_j = WhisperModel(cfg)
    with jax.default_matmul_precision("highest"):
        gen, lengths = greedy_generate(
            model_j, params, jnp.asarray(mel), max_len=max_new + 1,
            prompt=(1,), eot_id=2,
        )
    for b in range(2):
        ours = list(np.asarray(gen)[b][: int(lengths[b])])
        ref = [int(t) for t in ref_ids[b][1:] if t != 2][:max_new]
        # HF's max_new_tokens accounting can differ by one at the horizon;
        # parity means identical tokens along the common prefix
        n = min(len(ours), len(ref))
        assert n >= max_new - 2, (b, ours, ref)
        assert [int(t) for t in ours[:n]] == ref[:n], (b, ours, ref)


def test_generate_parity_with_hf_suppression(hf_whisper, rng):
    """Token suppression parity: suppress_tokens (every step) and
    begin_suppress_tokens (first generated step) match transformers'
    generate() semantics on the same imported weights."""
    torch = pytest.importorskip("torch")
    import jax

    from jiao_liao_asr.decode.whisper_generate import greedy_generate
    from jiao_liao_asr.models.whisper import WhisperModel

    model_t, hf_cfg, ckpt_dir = hf_whisper
    cfg = WhisperConfig(
        vocab_size=200, num_mels=80, d_model=64, encoder_layers=2,
        decoder_layers=2, num_heads=4, mlp_dim=128, max_source_positions=150,
        max_target_positions=32, dtype="float32", )
    params = load_hf_whisper(ckpt_dir, cfg)
    mel = rng.randn(1, 80, 300).astype(np.float32) * 0.5
    max_new = 10

    # find what unsuppressed greedy decode would emit, then suppress exactly
    # those ids so the constraint provably changes the output
    model_j = WhisperModel(cfg)
    with jax.default_matmul_precision("highest"):
        gen0, n0 = greedy_generate(
            model_j, params, jnp.asarray(mel), max_len=max_new + 1,
            prompt=(1,), eot_id=2,
        )
    first = int(np.asarray(gen0)[0][0])
    later = int(np.asarray(gen0)[0][1])
    suppress = [later]
    begin_suppress = [first] if first != later else []

    from transformers.generation import GenerationConfig

    gen_cfg = GenerationConfig(
        max_new_tokens=max_new, do_sample=False, num_beams=1,
        suppress_tokens=suppress, begin_suppress_tokens=begin_suppress,
        decoder_start_token_id=1,
    )
    with torch.no_grad():
        ref_ids = model_t.generate(
            input_features=torch.tensor(mel), generation_config=gen_cfg
        ).numpy()

    with jax.default_matmul_precision("highest"):
        gen, lengths = greedy_generate(
            model_j, params, jnp.asarray(mel), max_len=max_new + 1,
            prompt=(1,), eot_id=2,
            suppress_ids=tuple(suppress),
            begin_suppress_ids=tuple(begin_suppress),
        )
    ours = [int(t) for t in np.asarray(gen)[0][: int(lengths[0])]]
    ref = [int(t) for t in ref_ids[0][1:] if t != 2][:max_new]
    n = min(len(ours), len(ref))
    assert n >= max_new - 2, (ours, ref)
    assert ours[:n] == ref[:n], (ours, ref)
    assert later not in ours
    if begin_suppress:
        assert (not ours) or ours[0] != first


def test_load_hf_generation_constraints(tmp_path):
    import json as _json

    from jiao_liao_asr.models.whisper_import import (
        load_hf_generation_constraints,
    )

    d = tmp_path / "ckpt"
    d.mkdir()
    assert load_hf_generation_constraints(d) == {
        "suppress_ids": (), "begin_suppress_ids": (), "alignment_heads": (),
    }
    (d / "generation_config.json").write_text(
        _json.dumps({"suppress_tokens": [5, 6], "begin_suppress_tokens": [7]})
    )
    got = load_hf_generation_constraints(d)
    assert got == {
        "suppress_ids": (5, 6), "begin_suppress_ids": (7,),
        "alignment_heads": (),
    }


def test_import_hf_checkpoint_cli_roundtrip(hf_whisper, tmp_path):
    """import-whisper builds a loadable bundle dir from an HF checkpoint:
    config fields come from config.json, params match a direct import."""
    import jax
    import numpy as np

    from jiao_liao_asr.models.bundle import ModelBundle
    from jiao_liao_asr.models.whisper_import import (
        import_hf_checkpoint,
        whisper_config_from_hf,
    )

    _, hf_cfg, ckpt_dir = hf_whisper
    wcfg = whisper_config_from_hf(ckpt_dir)
    assert wcfg.d_model == hf_cfg.d_model
    assert wcfg.encoder_layers == hf_cfg.encoder_layers
    assert wcfg.num_heads == hf_cfg.encoder_attention_heads
    assert wcfg.mlp_dim == hf_cfg.encoder_ffn_dim
    assert wcfg.vocab_size == hf_cfg.vocab_size
    assert wcfg.max_target_positions == hf_cfg.max_target_positions

    out = tmp_path / "bundle"
    bundle = import_hf_checkpoint(ckpt_dir, out)
    assert (out / "config.json").exists()

    loaded = ModelBundle.load(checkpoint=str(out))
    assert loaded.config.model_family == "whisper"
    assert loaded.config.whisper.d_model == hf_cfg.d_model
    flat_a = jax.tree_util.tree_leaves(bundle.params)
    flat_b = jax.tree_util.tree_leaves(loaded.params)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_export_hf_checkpoint_roundtrip_and_transformers_load(hf_whisper, tmp_path):
    """Export back to HF format: transformers loads the exported dir and its
    logits match the original torch model (full import -> export -> torch
    roundtrip)."""
    torch = pytest.importorskip("torch")
    from transformers import WhisperForConditionalGeneration

    from jiao_liao_asr.models.whisper_import import (
        export_hf_checkpoint,
        import_hf_checkpoint,
    )

    model_t, hf_cfg, ckpt_dir = hf_whisper
    bundle = import_hf_checkpoint(ckpt_dir, tmp_path / "bundle")
    out = export_hf_checkpoint(bundle, tmp_path / "hf_out")

    model_rt = WhisperForConditionalGeneration.from_pretrained(out).eval()
    rng_l = np.random.RandomState(3)
    mel = torch.tensor(
        rng_l.randn(1, hf_cfg.num_mel_bins, 2 * hf_cfg.max_source_positions)
        .astype(np.float32)
    )
    toks = torch.tensor(rng_l.randint(0, hf_cfg.vocab_size, (1, 6)))
    with torch.no_grad():
        want = model_t(input_features=mel, decoder_input_ids=toks).logits
        got = model_rt(input_features=mel, decoder_input_ids=toks).logits
    np.testing.assert_allclose(
        got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5
    )
