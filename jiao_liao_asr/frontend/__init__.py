"""Audio frontend: host decode -> on-device fused featurization.

Replacement for the reference's CPU feature stack
(soundfile/audioread decode, soxr resample, librosa/WhisperFeatureExtractor
log-mel — /root/reference/requirements.txt:8,32,69,70; SURVEY.md C2-C5).
The hot path (frame -> window -> GEMM-native DFT -> mel matmul -> log ->
norm) runs on-device as XLA-fused jnp.
"""

from .audio_io import read_audio, read_flac, read_wav, write_wav  # noqa: F401
from .resample import resample  # noqa: F401
from .features import (  # noqa: F401
    log_mel_spectrogram,
    mel_filterbank,
    featurize_batch,
)
from .specaugment import spec_augment  # noqa: F401
from .augment import augment_waveform  # noqa: F401
