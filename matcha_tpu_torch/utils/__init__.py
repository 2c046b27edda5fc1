"""Profiling, timing and plotting helpers, and wav output."""

import numpy as np


def save_wav(path, waveform, sample_rate: int = 22050):
    """Save a waveform as 16-bit PCM. Accepts a numpy array or a tensor, float
    in [-1, 1] (clipped, scaled by 32767) or int16 samples (the serving
    engine's `output_dtype="int16"` mode is already PCM16); (1, T) is squeezed."""
    from scipy.io import wavfile

    if hasattr(waveform, "detach"):  # a torch tensor (bf16 has no numpy dtype)
        waveform = waveform.detach().cpu()
        waveform = (waveform.float() if waveform.is_floating_point() else waveform).numpy()
    wav = np.asarray(waveform)
    if wav.ndim == 2:
        wav = wav[0]
    if wav.dtype != np.int16:
        wav = (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16)
    wavfile.write(path, sample_rate, wav)


__all__ = ["save_wav"]
