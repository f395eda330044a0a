"""Import reference Whisper weights from HF safetensors checkpoints.

The reference stores weights in safetensors / HF hub layout
(/root/reference/requirements.txt:61,23; SURVEY.md C18/N11). This module
contains (a) a from-scratch pure-numpy safetensors reader — the format is an
8-byte little-endian header length, a JSON tensor index {name: {dtype,
shape, data_offsets}}, then raw row-major buffers — and (b) the name/layout
mapping from transformers WhisperForConditionalGeneration state dicts onto
this framework's param tree (torch [out,in] linears transpose to [in,out]
kernels; conv [out,in,k] -> [k,in,out]).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": None,  # handled specially below
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path: str | Path) -> Dict[str, np.ndarray]:
    """Read a .safetensors file into {name: numpy array} without any
    third-party dependency. bfloat16 tensors are upcast to float32."""
    raw = Path(path).read_bytes()
    (hlen,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + hlen].decode("utf-8"))
    base = 8 + hlen
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        buf = raw[base + start : base + end]
        shape = meta["shape"]
        dt = meta["dtype"]
        if dt == "BF16":
            u16 = np.frombuffer(buf, dtype=np.uint16)
            u32 = u16.astype(np.uint32) << 16
            arr = u32.view(np.float32)
        else:
            arr = np.frombuffer(buf, dtype=_DTYPES[dt])
        out[name] = arr.reshape(shape).copy()
    return out


def write_safetensors(path: str | Path, tensors: Dict[str, np.ndarray]) -> None:
    """Minimal safetensors writer (export / test fixtures)."""
    header: Dict[str, Any] = {}
    bufs = []
    offset = 0
    dmap = {v: k for k, v in _DTYPES.items() if v is not None}
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        b = arr.tobytes()
        header[name] = {
            "dtype": dmap[arr.dtype.type],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(b)],
        }
        bufs.append(b)
        offset += len(b)
    hjson = json.dumps(header).encode("utf-8")
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(hjson)))
        fh.write(hjson)
        for b in bufs:
            fh.write(b)


# ---------------------------------------------------------------------------
# HF Whisper -> param tree mapping
# ---------------------------------------------------------------------------


def _linear(sd, prefix, has_bias=True):
    out = {"dense": {"kernel": sd[f"{prefix}.weight"].T}}
    if has_bias and f"{prefix}.bias" in sd:
        out["dense"]["bias"] = sd[f"{prefix}.bias"]
    return out


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _attn(sd, prefix):
    return {
        "q_proj": _linear(sd, f"{prefix}.q_proj"),
        "k_proj": _linear(sd, f"{prefix}.k_proj", has_bias=False),
        "v_proj": _linear(sd, f"{prefix}.v_proj"),
        "out_proj": _linear(sd, f"{prefix}.out_proj"),
    }


def _block(sd, prefix, cross: bool):
    blk = {
        "self_attn": _attn(sd, f"{prefix}.self_attn"),
        "self_attn_ln": _ln(sd, f"{prefix}.self_attn_layer_norm"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.fc1"),
            "fc2": _linear(sd, f"{prefix}.fc2"),
        },
        "mlp_ln": _ln(sd, f"{prefix}.final_layer_norm"),
    }
    if cross:
        blk["cross_attn"] = _attn(sd, f"{prefix}.encoder_attn")
        blk["cross_attn_ln"] = _ln(sd, f"{prefix}.encoder_attn_layer_norm")
    return blk


def hf_state_dict_to_flax(sd: Dict[str, np.ndarray], cfg) -> Dict:
    """Map a transformers Whisper state dict onto the WhisperModel tree.

    Accepts both `model.encoder...` (WhisperForConditionalGeneration) and
    `encoder...` (WhisperModel) key styles.
    """
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model.") :]: v for k, v in sd.items() if k.startswith("model.")}

    enc: Dict[str, Any] = {
        "conv1": {
            "kernel": sd["encoder.conv1.weight"].transpose(2, 1, 0),
            "bias": sd["encoder.conv1.bias"],
        },
        "conv2": {
            "kernel": sd["encoder.conv2.weight"].transpose(2, 1, 0),
            "bias": sd["encoder.conv2.bias"],
        },
        "ln_post": _ln(sd, "encoder.layer_norm"),
    }
    for i in range(cfg.encoder_layers):
        enc[f"block_{i}"] = _block(sd, f"encoder.layers.{i}", cross=False)

    dec: Dict[str, Any] = {
        "embed_tokens": {"embedding": sd["decoder.embed_tokens.weight"]},
        "embed_positions": sd["decoder.embed_positions.weight"],
        "ln": _ln(sd, "decoder.layer_norm"),
    }
    for i in range(cfg.decoder_layers):
        dec[f"block_{i}"] = _block(sd, f"decoder.layers.{i}", cross=True)

    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# param tree -> HF Whisper state dict (export; exact inverse of the import
# mapping above: [in,out] kernels transpose back to torch [out,in] linears,
# [k,in,out] convs back to [out,in,k])
# ---------------------------------------------------------------------------


def _inv_linear(out, prefix, tree):
    out[f"{prefix}.weight"] = np.asarray(tree["dense"]["kernel"]).T
    if "bias" in tree["dense"]:
        out[f"{prefix}.bias"] = np.asarray(tree["dense"]["bias"])


def _inv_ln(out, prefix, tree):
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _inv_attn(out, prefix, tree):
    _inv_linear(out, f"{prefix}.q_proj", tree["q_proj"])
    _inv_linear(out, f"{prefix}.k_proj", tree["k_proj"])
    _inv_linear(out, f"{prefix}.v_proj", tree["v_proj"])
    _inv_linear(out, f"{prefix}.out_proj", tree["out_proj"])


def _inv_block(out, prefix, tree, cross: bool):
    _inv_attn(out, f"{prefix}.self_attn", tree["self_attn"])
    _inv_ln(out, f"{prefix}.self_attn_layer_norm", tree["self_attn_ln"])
    _inv_linear(out, f"{prefix}.fc1", tree["mlp"]["fc1"])
    _inv_linear(out, f"{prefix}.fc2", tree["mlp"]["fc2"])
    _inv_ln(out, f"{prefix}.final_layer_norm", tree["mlp_ln"])
    if cross:
        _inv_attn(out, f"{prefix}.encoder_attn", tree["cross_attn"])
        _inv_ln(out, f"{prefix}.encoder_attn_layer_norm", tree["cross_attn_ln"])


def flax_to_hf_state_dict(params: Dict, cfg) -> Dict[str, np.ndarray]:
    """Map a WhisperModel param tree back onto a transformers
    WhisperForConditionalGeneration state dict (`model.*` key style;
    adapter params — `adapter_*` subtrees — are skipped: HF has no slot
    for them, use the adapter-only artifact for those)."""
    sd: Dict[str, np.ndarray] = {}
    enc, dec = params["encoder"], params["decoder"]
    sd["model.encoder.conv1.weight"] = np.asarray(
        enc["conv1"]["kernel"]
    ).transpose(2, 1, 0)
    sd["model.encoder.conv1.bias"] = np.asarray(enc["conv1"]["bias"])
    sd["model.encoder.conv2.weight"] = np.asarray(
        enc["conv2"]["kernel"]
    ).transpose(2, 1, 0)
    sd["model.encoder.conv2.bias"] = np.asarray(enc["conv2"]["bias"])
    _inv_ln(sd, "model.encoder.layer_norm", enc["ln_post"])
    for i in range(cfg.encoder_layers):
        _inv_block(sd, f"model.encoder.layers.{i}", enc[f"block_{i}"], cross=False)

    sd["model.decoder.embed_tokens.weight"] = np.asarray(
        dec["embed_tokens"]["embedding"]
    )
    sd["model.decoder.embed_positions.weight"] = np.asarray(dec["embed_positions"])
    _inv_ln(sd, "model.decoder.layer_norm", dec["ln"])
    for i in range(cfg.decoder_layers):
        _inv_block(sd, f"model.decoder.layers.{i}", dec[f"block_{i}"], cross=True)
    # transformers ties proj_out to the embedding; fixed sinusoidal encoder
    # positions are non-persistent there, so neither is exported
    return sd


def export_hf_checkpoint(bundle, out: str | Path) -> Path:
    """ModelBundle (whisper family) -> an HF checkpoint directory
    transformers can `from_pretrained`: model.safetensors (f32, torch
    layout) + config.json + generation_config.json."""
    import jax

    cfg = bundle.config.whisper
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), bundle.params
    )
    sd = flax_to_hf_state_dict(params, cfg)
    write_safetensors(out / "model.safetensors", sd)
    heads = cfg.num_heads
    config = {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "vocab_size": cfg.vocab_size,
        "num_mel_bins": cfg.num_mels,
        "d_model": cfg.d_model,
        "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": heads,
        "decoder_attention_heads": heads,
        "encoder_ffn_dim": cfg.mlp_dim,
        "decoder_ffn_dim": cfg.mlp_dim,
        "max_source_positions": cfg.max_source_positions,
        "max_target_positions": cfg.max_target_positions,
        "activation_function": "gelu",
        "is_encoder_decoder": True,
        "tie_word_embeddings": True,
    }
    # special ids must lie inside the (possibly small) vocab or torch's
    # Embedding(padding_idx=...) asserts; Whisper convention: bos == pad ==
    # eot, decoder start = <|startoftranscript|>. Clamp for non-standard
    # small vocabs (resolve_specials defaults assume the 51865 vocab).
    from ..decode.whisper_generate import resolve_specials

    prompt, eot = resolve_specials(cfg)
    eot = int(eot) if eot < cfg.vocab_size else cfg.vocab_size - 1
    start = int(prompt[0]) if prompt and prompt[0] < cfg.vocab_size else eot
    config["eos_token_id"] = eot
    config["pad_token_id"] = eot
    config["bos_token_id"] = eot
    config["decoder_start_token_id"] = start
    (out / "config.json").write_text(json.dumps(config, indent=2), encoding="utf-8")
    gc = {
        "suppress_tokens": list(cfg.suppress_ids),
        "begin_suppress_tokens": list(cfg.begin_suppress_ids),
    }
    if cfg.alignment_heads:
        gc["alignment_heads"] = [list(lh) for lh in cfg.alignment_heads]
    (out / "generation_config.json").write_text(
        json.dumps(gc, indent=2), encoding="utf-8"
    )
    return out


def load_hf_generation_constraints(path: str | Path) -> Dict[str, tuple]:
    """Read generation_config.json (HF layout) for the decode-time token
    constraints transformers' generate() applies by default: suppress_tokens
    (masked every step), begin_suppress_tokens (first generated step), and
    alignment_heads (the (layer, head) pairs whose cross-attention tracks
    time — decode/align.py's timestamp DTW). Returns empty entries when
    absent so callers can cfg-merge unconditionally.
    """
    p = Path(path)
    gc = p / "generation_config.json" if p.is_dir() else None
    out = {"suppress_ids": (), "begin_suppress_ids": (), "alignment_heads": ()}
    if gc is not None and gc.exists():
        data = json.loads(gc.read_text(encoding="utf-8"))
        out["suppress_ids"] = tuple(int(t) for t in data.get("suppress_tokens") or ())
        out["begin_suppress_ids"] = tuple(
            int(t) for t in data.get("begin_suppress_tokens") or ()
        )
        out["alignment_heads"] = tuple(
            (int(l), int(h)) for l, h in data.get("alignment_heads") or ()
        )
    return out


def whisper_config_from_hf(path: str | Path):
    """Build a WhisperConfig from an HF checkpoint directory's config.json
    (+ generation_config.json decode constraints when present), so
    `import-whisper` needs no preset guessing: every shape field comes from
    the checkpoint itself."""
    from ..utils.config import WhisperConfig

    p = Path(path)
    data = json.loads((p / "config.json").read_text(encoding="utf-8"))
    heads = data.get("encoder_attention_heads", 6)
    if data.get("decoder_attention_heads", heads) != heads:
        raise ValueError("asymmetric encoder/decoder head counts unsupported")
    ffn = data.get("encoder_ffn_dim", 4 * data.get("d_model", 384))
    if data.get("decoder_ffn_dim", ffn) != ffn:
        raise ValueError("asymmetric encoder/decoder ffn dims unsupported")
    gc = load_hf_generation_constraints(p)
    return WhisperConfig(
        name=Path(data.get("_name_or_path", "") or "whisper_imported").name
        or "whisper_imported",
        vocab_size=data.get("vocab_size", 51865),
        num_mels=data.get("num_mel_bins", 80),
        d_model=data.get("d_model", 384),
        encoder_layers=data.get("encoder_layers", 4),
        decoder_layers=data.get("decoder_layers", 4),
        num_heads=heads,
        mlp_dim=ffn,
        max_source_positions=data.get("max_source_positions", 1500),
        max_target_positions=data.get("max_target_positions", 448),
        suppress_ids=gc["suppress_ids"],
        begin_suppress_ids=gc["begin_suppress_ids"],
        alignment_heads=gc["alignment_heads"],
    )


def import_hf_checkpoint(src: str | Path, out: str | Path) -> "Any":
    """HF Whisper checkpoint directory -> a ModelBundle checkpoint directory
    loadable by `load(checkpoint=out)` / `transcribe --checkpoint out`.

    Copies the HF BPE tokenizer files (vocab.json/merges.txt/
    added_tokens.json/tokenizer.json) alongside so the bundle loads the
    byte-level BPE tokenizer (data/bpe.py) instead of a char vocab.
    Returns the saved ModelBundle."""
    import shutil

    from ..utils.config import ExperimentConfig, FrontendConfig
    from .bundle import ModelBundle

    src = Path(src)
    wcfg = whisper_config_from_hf(src)
    config = ExperimentConfig(
        model_family="whisper",
        whisper=wcfg,
        frontend=FrontendConfig(num_mels=wcfg.num_mels),
    )
    params = load_hf_whisper(src, wcfg)
    tokenizer = None
    if (src / "vocab.json").exists() and (src / "merges.txt").exists():
        from ..data.bpe import ByteLevelBPE

        tokenizer = ByteLevelBPE.from_hf_dir(src)
    bundle = ModelBundle(config=config, params=params, tokenizer=tokenizer)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    from ..train.checkpoints import save_params
    from ..utils.config import save_config

    save_config(config, str(out / "config.json"))
    save_params(str(out), params)
    for name in ("vocab.json", "merges.txt", "added_tokens.json", "tokenizer.json"):
        if (src / name).exists():
            shutil.copy(src / name, out / name)
    return bundle


def load_hf_whisper(path: str | Path, cfg) -> Dict:
    """Load an HF Whisper checkpoint directory or .safetensors file into a
    param tree matching models.whisper.WhisperModel."""
    p = Path(path)
    if p.is_dir():
        files = sorted(p.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors under {p}")
        sd: Dict[str, np.ndarray] = {}
        for f in files:
            sd.update(read_safetensors(f))
    else:
        sd = read_safetensors(p)
    import jax.numpy as jnp
    import jax

    tree = hf_state_dict_to_flax(sd, cfg)
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), tree)
