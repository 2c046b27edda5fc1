"""Mel filterbank construction (numpy, host side, computed once per config).

A copy of the JAX package's slaney-style filterbank (`matcha_tpu/audio/filters.py`),
the filters the reference takes from `librosa.filters.mel` with htk=False and
norm="slaney" (sr 22050, n_fft 1024, 80 mels, fmin 0, fmax 8000). The port keeps
its own copy because it imports nothing of `matcha_tpu`.
"""

import numpy as np

_F_MIN = 0.0
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = (_MIN_LOG_HZ - _F_MIN) / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies):
    """Slaney-scale Hz -> mel (linear below 1 kHz, log above)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    mels = (frequencies - _F_MIN) / _F_SP
    log_region = frequencies >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )


def mel_to_hz(mels):
    """Slaney-scale mel -> Hz."""
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_MIN + _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    return np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )


def mel_frequencies(n_mels, fmin, fmax):
    """`n_mels` frequencies evenly spaced on the slaney mel scale."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None, dtype=np.float32):
    """Triangular slaney-normalized mel filterbank, shape (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = float(sr) / 2

    fft_freqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sr)
    mel_f = mel_frequencies(n_mels + 2, fmin=fmin, fmax=fmax)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fft_freqs)

    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0, np.minimum(lower, upper))

    # Slaney normalization: each filter integrates to ~2 / bandwidth.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]

    return weights.astype(dtype)
