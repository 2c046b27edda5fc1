"""Audio feature extraction and waveform reconstruction (PyTorch)."""

from matcha_tpu_torch.audio.filters import mel_filterbank
from matcha_tpu_torch.audio.griffin_lim import griffin_lim, inverse_mel, mel_to_audio
from matcha_tpu_torch.audio.mel import (
    MelConfig,
    load_and_process_audio,
    load_wav,
    mel_spectrogram,
    num_frames,
)

__all__ = [
    "MelConfig",
    "mel_spectrogram",
    "load_wav",
    "load_and_process_audio",
    "num_frames",
    "mel_filterbank",
    "griffin_lim",
    "inverse_mel",
    "mel_to_audio",
]
