"""Public north-star API: ``load`` / ``featurize`` / ``transcribe`` /
``fine_tune`` (BASELINE.json).

Mirrors the reference's user surface (HF ``from_pretrained`` + processor +
``generate`` / SpeechBrain recipe entry points, SURVEY.md §3) as four plain
functions over explicit config dataclasses. Implementations live in the
layer packages; this module only wires them together.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from .utils.config import ExperimentConfig, FrontendConfig


def load(
    checkpoint: Optional[str] = None,
    config: Optional[Union[str, ExperimentConfig]] = None,
):
    """Load a model bundle (config + params + tokenizer) ready for
    :func:`transcribe` / :func:`fine_tune`.

    `checkpoint` may be a checkpoint dir (ModelBundle.save), a safetensors file exported
    by this framework, or an HF-format Whisper safetensors file (imported via
    models.whisper_import). With no checkpoint, returns a randomly
    initialized model from `config`.
    """
    from .models.bundle import ModelBundle

    return ModelBundle.load(checkpoint=checkpoint, config=config)


def featurize(
    wav: Union[str, np.ndarray, Sequence[np.ndarray]],
    cfg: Optional[FrontendConfig] = None,
    sample_rate: Optional[int] = None,
):
    """Audio (path, PCM array, or list thereof) -> log-mel features
    [B, num_mels, frames] on device. Resamples to cfg.sample_rate if needed."""
    import jax.numpy as jnp

    from .frontend import audio_io, features, resample

    cfg = cfg or FrontendConfig()
    if isinstance(wav, (str,)) or hasattr(wav, "__fspath__"):
        wav, sample_rate = audio_io.read_audio(wav)
    if isinstance(wav, np.ndarray) and wav.ndim == 1:
        wavs = [wav]
    elif isinstance(wav, np.ndarray):
        wavs = list(wav)
    else:
        wavs = [np.asarray(w, dtype=np.float32) for w in wav]
    if sample_rate is not None and sample_rate != cfg.sample_rate:
        wavs = [
            np.asarray(resample.resample(jnp.asarray(w), sample_rate, cfg.sample_rate))
            for w in wavs
        ]
    batch = np.stack([features.pad_or_trim(w, cfg) for w in wavs])
    return features.featurize_batch(jnp.asarray(batch), cfg)


def transcribe(
    bundle,
    audio: Union[str, np.ndarray, Sequence],
    sample_rate: Optional[int] = None,
    decode_cfg=None,
    timestamps: bool = False,
):
    """Audio -> text via the bundle's model family (CTC greedy/beam or
    Whisper AR generate). Returns one transcript per input utterance; with
    ``timestamps=True``, one ``[{"token", "start", "end"}, ...]`` list per
    utterance instead (greedy; CTC frame alignment or whisper cross-attention
    DTW — see ModelBundle.transcribe_timed)."""
    if timestamps:
        return bundle.transcribe_timed(audio, sample_rate=sample_rate)
    return bundle.transcribe(audio, sample_rate=sample_rate, decode_cfg=decode_cfg)


def stream(
    bundle,
    chunks: Iterable[np.ndarray],
    stream_cfg=None,
):
    """Incremental transcription of a live audio stream (CTC families).

    Beyond-reference serving surface (the reference decodes complete
    recordings only): yields a StreamingResult after every fed chunk —
    `res.text` is final committed text, `res.preview` the unstable tail —
    and a final result (is_final=True) after the source is exhausted.

    >>> for res in stream(bundle, microphone_chunks()):
    ...     print(res.text + res.preview)
    """
    from .serve.streaming import StreamingTranscriber

    st = StreamingTranscriber(bundle, stream_cfg)
    for chunk in chunks:
        yield st.feed(chunk)
    yield st.finish()


def fine_tune(config: Union[str, ExperimentConfig], resume: bool = False):
    """Run the (adapter) fine-tuning loop described by `config`; returns the
    final TrainState. Covers BASELINE configs[2] (adapter fine-tune) and,
    with `config.stages`, configs[3] (multi-dialect knowledge transfer)."""
    from .train.engine import run_experiment

    if isinstance(config, str):
        from .utils.config import load_config

        config = load_config(config)
    return run_experiment(config, resume=resume)
