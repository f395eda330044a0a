"""Dataclass config system with JSON round-trip and CLI overrides.

Replaces the reference's HyperPyYAML (/root/reference/requirements.txt:24) —
SpeechBrain's code-executing YAML dialect — with plain dataclasses serialized
to/from JSON (no object construction from config files; read with the
standard library) plus ``key.subkey=value`` CLI overrides. One JSON file per
BASELINE.json config scenario lives in configs/.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Type, TypeVar

T = TypeVar("T")


# ---------------------------------------------------------------------------
# Config dataclasses (mirrors of SURVEY.md §1.b layers)
# ---------------------------------------------------------------------------


@dataclass
class FrontendConfig:
    """Log-mel frontend, Whisper-compatible defaults (SURVEY.md C3: n_fft=400,
    hop=160, 16 kHz, 80 mels; 128 for large-v3)."""

    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    num_mels: int = 80
    chunk_seconds: float = 30.0  # Whisper fixed receptive field
    mel_scale: str = "slaney"  # slaney | htk
    preemphasis: float = 0.0  # SB-style fbank uses 0.97; Whisper uses none
    log_floor: float = 1e-10
    whisper_norm: bool = True  # clamp to max-8 then (x+4)/4, Whisper-style
    cmvn: str = "none"  # none | utterance | global
    # corpus stats (.npz with mean/std) for cmvn="global"; produced by
    # `cli prepare --cmvn` / frontend.cmvn.compute_corpus_cmvn
    cmvn_stats_path: str = ""

    @property
    def num_frames(self) -> int:
        return int(self.chunk_seconds * self.sample_rate) // self.hop_length


@dataclass
class SpecAugmentConfig:
    """SpecAugment (SURVEY.md C5): time/freq masking on features."""

    enabled: bool = True
    num_freq_masks: int = 2
    freq_mask_width: int = 27
    num_time_masks: int = 2
    time_mask_fraction: float = 0.05  # max width as a fraction of frames
    replace_with_zero: bool = True  # else mean


@dataclass
class AugmentConfig:
    """Waveform augmentation (SURVEY.md C4): on-device jax.random equivalents
    of audiomentations/torch-audiomentations."""

    enabled: bool = False
    gain_db: Tuple[float, float] = (-6.0, 6.0)
    noise_snr_db: Tuple[float, float] = (10.0, 40.0)
    pitch_semitones: Tuple[float, float] = (-2.0, 2.0)
    speed_rates: Tuple[float, ...] = (0.9, 1.0, 1.1)
    probability: float = 0.5
    # filter augmentation (julius / audiomentations Low|High|BandPassFilter,
    # reference requirements.txt:30,7): windowed-sinc FIR with a per-example
    # random cutoff, applied as a depthwise conv on device. Probabilities
    # default 0 = off (matches the r3 behavior unless enabled).
    lowpass_hz: Tuple[float, float] = (2000.0, 7500.0)
    lowpass_probability: float = 0.0
    highpass_hz: Tuple[float, float] = (20.0, 400.0)
    highpass_probability: float = 0.0
    # band-pass passes (highpass_hz-draw, lowpass_hz-draw)
    bandpass_probability: float = 0.0
    filter_taps: int = 101
    # standalone time stretch (audiomentations TimeStretch): static discrete
    # rate set (shape-static branches); pitch preserved via granular OLA.
    # () = off; gated by `probability` like the other transforms.
    time_stretch_rates: Tuple[float, ...] = ()


@dataclass
class AdapterConfig:
    """WFAdapter / AttAdapter / bottleneck baseline (README.md:1; SURVEY C9-C11)."""

    kind: str = "none"  # none | bottleneck | wf | att
    bottleneck_dim: int = 64
    wf_rank: int = 8  # weight-factorization rank of WFAdapter
    att_num_heads: int = 4
    att_key_dim: int = 64
    scale: float = 1.0
    dropout: float = 0.1
    # which sublayers get adapters
    after_attention: bool = True
    after_mlp: bool = True


@dataclass
class CTCModelConfig:
    """Conv-subsampled transformer encoder + CTC head (SURVEY C8)."""

    name: str = "ctc_base"
    vocab_size: int = 4336  # Mandarin char vocab + blank (see data/tokenizer)
    d_model: int = 512
    num_layers: int = 12
    num_heads: int = 4  # dh=128
    mlp_dim: int = 2048
    conv_channels: int = 512
    subsample_factor: int = 4  # two stride-2 convs: 3000 -> 750 frames
    dropout: float = 0.1
    num_mels: int = 80
    max_frames: int = 3000
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    remat: bool = False  # jax.checkpoint each block (memory for FLOPs)
    # MLP activation: 'tanh' (tanh-form GELU, the flagship family's trained
    # form) or 'erf' (exact GELU, the form Whisper checkpoints pin —
    # WhisperConfig has no knob, HF logit parity requires erf there)
    gelu_form: str = "tanh"
    # streaming-matched training: limit encoder self-attention to a band of
    # (left, right) ENCODER frames around each query; -1 = unbounded (the
    # offline default). A model trained with a band decodes identically
    # under sliding-window streaming (serve/streaming.py) once the window
    # covers the left context and lookahead covers the right.
    attention_left_context: int = -1
    attention_right_context: int = -1
    # "sinusoidal" = absolute positions (offline default); "none" = drop
    # them — the conv subsampler provides local order, making the encoder
    # shift-invariant, which sliding-window streaming requires for
    # train/serve consistency.
    position_mode: str = "sinusoidal"
    adapter: AdapterConfig = field(default_factory=AdapterConfig)


@dataclass
class WhisperConfig:
    """Whisper encoder-decoder (SURVEY C7). Defaults = whisper-tiny shape;
    large-v3 preset available via `whisper_preset('large-v3')`."""

    name: str = "whisper_tiny"
    vocab_size: int = 51865
    num_mels: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    mlp_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    dropout: float = 0.0
    dtype: str = "bfloat16"
    remat: bool = False  # jax.checkpoint each block (memory for FLOPs)
    # decode special tokens; prompt_ids=() -> standard Whisper zh-transcribe
    # prompt (decode/whisper_generate.default_prompt), eot_id<0 -> standard EOT
    eot_id: int = -1
    prompt_ids: Tuple[int, ...] = ()
    # HF-generate-parity token suppression: suppress_ids masked at EVERY
    # step, begin_suppress_ids only at the first generated position
    # (imported from generation_config.json by whisper_import)
    suppress_ids: Tuple[int, ...] = ()
    begin_suppress_ids: Tuple[int, ...] = ()
    # (layer, head) pairs whose cross-attention aligns with time — HF
    # generation_config.json "alignment_heads"; empty -> all heads averaged
    # (decode/align.py timestamp DTW)
    alignment_heads: Tuple[Tuple[int, int], ...] = ()
    adapter: AdapterConfig = field(default_factory=AdapterConfig)


@dataclass
class JointModelConfig:
    """Joint CTC/attention transformer (SURVEY C8: the SpeechBrain
    TransformerASR recipe shape — conv-subsampled encoder with BOTH a CTC
    head and an attention decoder, trained with the weighted hybrid loss
    ctc_weight*CTC + (1-ctc_weight)*CE)."""

    name: str = "joint_base"
    vocab_size: int = 4336
    d_model: int = 512
    num_layers: int = 12
    decoder_layers: int = 6
    num_heads: int = 4
    mlp_dim: int = 2048
    conv_channels: int = 512
    subsample_factor: int = 4
    dropout: float = 0.1
    num_mels: int = 80
    max_frames: int = 3000
    max_target_positions: int = 448
    dtype: str = "bfloat16"
    remat: bool = False
    gelu_form: str = "tanh"  # see CTCModelConfig.gelu_form
    # encoder streaming-matched training knobs; see CTCModelConfig
    attention_left_context: int = -1
    attention_right_context: int = -1
    position_mode: str = "sinusoidal"
    # SpeechBrain's default hybrid weighting (ctc_weight 0.3)
    ctc_weight: float = 0.3
    adapter: AdapterConfig = field(default_factory=AdapterConfig)


@dataclass
class MeshConfig:
    """Device mesh / parallelism (SURVEY §2.3): DP for parity, FSDP-style
    param sharding + optional TP as extensions."""

    data_axis: int = -1  # -1 = all remaining devices
    fsdp_axis: int = 1
    model_axis: int = 1
    axis_names: Tuple[str, str, str] = ("data", "fsdp", "model")
    remat: bool = False  # jax.checkpoint on transformer blocks


@dataclass
class DataConfig:
    train_manifest: str = ""
    eval_manifest: str = ""
    batch_size: int = 16
    max_audio_seconds: float = 30.0
    min_audio_seconds: float = 0.3
    bucket_boundaries_seconds: Tuple[float, ...] = (5.0, 10.0, 20.0, 30.0)
    max_text_len: int = 128
    shuffle_seed: int = 0
    num_host_workers: int = 4
    tokenizer_dir: str = ""  # HF BPE files dir (whisper); else char vocab built
    # SP-unigram vocab (data/unigram.py: JSON save or spm_export_vocab TSV);
    # "" = char vocab. Train one with `cli train-unigram` (SURVEY N9)
    unigram_vocab: str = ""
    dialect_weights: Optional[Dict[str, float]] = None  # joint multi-dialect mix
    # "float32" | "int16": wire format for host->device audio. "int16" ships
    # native PCM (half the bytes over PCIe); featurize_batch dequantizes
    # on device as pcm/32768, bit-identical for 16-bit-sourced WAV/FLAC.
    transfer_dtype: str = "float32"


@dataclass
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant | noam
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.98
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1


@dataclass
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train_adapters_only: bool = False  # frozen backbone, adapter params only
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_steps: int = 500
    keep_checkpoints: int = 3
    log_every_steps: int = 10
    eval_every_steps: int = 1000
    seed: int = 0
    metrics_path: Optional[str] = None
    use_wandb: bool = False
    # dropout/augment RNG inside the train step: True derives the per-step
    # stream as an 'rbg' key (lax.rng_bit_generator) instead of threefry.
    # Whether it pays on the GPU is not measured yet. The checkpointed
    # state.rng stays a threefry key (format-stable); the rbg key is derived
    # from it deterministically, so resume stays exact.
    fast_dropout_rng: bool = True


@dataclass
class DecodeConfig:
    # greedy | beam | beam_device (+ for the joint family: ctc_greedy = the
    # CTC branch's fused fast path; greedy/beam decode the attention branch,
    # beam with CTC joint rescoring — decode/joint_generate.py; spec_greedy =
    # greedy-identical text via CTC-draft speculative verification —
    # decode/speculative.py)
    strategy: str = "greedy"
    beam_size: int = 8
    # per-frame proposal-set width for CTC prefix beam (host, native C++,
    # and device searchers); >= vocab-1 makes the pruned searchers exact.
    # 16 is the usual CTC-beam pruning width; it also bounds the
    # device->host posterior transfer, the pipeline's bottleneck link
    beam_topk: int = 16
    # pruned-prefix-beam cutoff for the native CTC beam: drop per-frame
    # candidates more than |beam_prune_logp| nats below the frame's best
    # mass. 0.0 disables (exact w.r.t. the top-k proposal set). On trained
    # (peaked) posteriors most frames become an O(beams) blank-only update.
    beam_prune_logp: float = 0.0
    ctc_blank_id: int = 0
    max_decode_len: int = 224  # Whisper AR decode cap
    length_penalty: float = 1.0
    temperature: float = 0.0  # whisper greedy: >0 samples softmax(logits/T)
    # external-LM shallow fusion (decode/lm.py): .npz from `cli train-lm`
    lm_path: str = ""
    lm_weight: float = 0.0


@dataclass
class DialectStage:
    """One stage of the multi-dialect knowledge-transfer schedule (SURVEY 3.4)."""

    name: str = ""
    manifests: Tuple[str, ...] = ()
    steps: int = 1000
    train_adapters_only: bool = True
    mix_weights: Optional[Tuple[float, ...]] = None  # joint mixing, else concat


@dataclass
class ExperimentConfig:
    """Top-level config = one BASELINE.json scenario."""

    model_family: str = "ctc"  # ctc | whisper | joint
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    specaugment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    ctc_model: CTCModelConfig = field(default_factory=CTCModelConfig)
    whisper: WhisperConfig = field(default_factory=WhisperConfig)
    joint: JointModelConfig = field(default_factory=JointModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    stages: Tuple[DialectStage, ...] = ()  # multi-dialect transfer schedule


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a dataclass from a nested dict, recursing into dataclass fields."""
    kwargs: Dict[str, Any] = {}
    for f in fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ft = f.type if isinstance(f.type, type) else _resolve_type(cls, f.name)
        if ft is not None and is_dataclass(ft) and isinstance(v, dict):
            kwargs[f.name] = from_dict(ft, v)
        elif f.name == "stages" and isinstance(v, (list, tuple)):
            kwargs[f.name] = tuple(
                from_dict(DialectStage, s) if isinstance(s, dict) else s for s in v
            )
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def _resolve_type(cls: Type, name: str) -> Optional[Type]:
    import typing

    hints = typing.get_type_hints(cls)
    t = hints.get(name)
    if t is None:
        return None
    if is_dataclass(t):
        return t
    return None


def save_config(cfg: Any, path: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(
        json.dumps(to_dict(cfg), indent=2, ensure_ascii=False) + "\n",
        encoding="utf-8",
    )


def load_config(path: str, cls: Type[T] = ExperimentConfig) -> T:
    """Read a JSON config. Keys the dataclasses no longer have are ignored,
    so configs saved by older versions still load."""
    data = json.loads(Path(path).read_text(encoding="utf-8") or "{}")
    return from_dict(cls, data or {})


def parse_override_value(raw: str) -> Any:
    """An override's value: JSON (numbers, true/false/null, lists, quoted
    strings), with the bare text as a string otherwise."""
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def apply_overrides(cfg: T, overrides: Sequence[str]) -> T:
    """Apply ``key.subkey=value`` CLI overrides (parse_override_value)."""
    data = to_dict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        node = data
        parts = key.strip().lstrip("-").split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        node[parts[-1]] = parse_override_value(raw)
    return from_dict(type(cfg), data)


def whisper_preset(name: str) -> WhisperConfig:
    """Shape presets matching the HF Whisper family (verified in SURVEY C7)."""
    presets = {
        "tiny": dict(d_model=384, encoder_layers=4, decoder_layers=4, num_heads=6,
                     mlp_dim=1536, num_mels=80, vocab_size=51865),
        "base": dict(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8,
                     mlp_dim=2048, num_mels=80, vocab_size=51865),
        "small": dict(d_model=768, encoder_layers=12, decoder_layers=12, num_heads=12,
                      mlp_dim=3072, num_mels=80, vocab_size=51865),
        "medium": dict(d_model=1024, encoder_layers=24, decoder_layers=24, num_heads=16,
                       mlp_dim=4096, num_mels=80, vocab_size=51865),
        "large-v2": dict(d_model=1280, encoder_layers=32, decoder_layers=32, num_heads=20,
                         mlp_dim=5120, num_mels=80, vocab_size=51865),
        "large-v3": dict(d_model=1280, encoder_layers=32, decoder_layers=32, num_heads=20,
                         mlp_dim=5120, num_mels=128, vocab_size=51866),
    }
    if name not in presets:
        raise KeyError(f"unknown whisper preset {name!r}; have {sorted(presets)}")
    return WhisperConfig(name=f"whisper_{name}", **presets[name])
