"""The port's audio modules against the JAX package's `matcha_tpu.audio` (CPU).

Same numpy inputs through both; the bars are tests/test_mel.py's where it has
one (filterbank, STFT magnitude, log-mel), and otherwise those of two float32
implementations of the same sums in other orders: the STFT and ISTFT of
Griffin-Lim 1e-5, inverse mel rtol 1e-4 (200 iterations), and the waveform
after Griffin-Lim's 32 iterations 1e-3, the bar of tests/test_serve.py, with
the JAX phase injected.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu_torch import audio

J = {n: importlib.import_module(f"matcha_tpu.audio.{n}") for n in ("filters", "mel", "griffin_lim")}
P = {n: importlib.import_module(f"matcha_tpu_torch.audio.{n}")
     for n in ("filters", "mel", "griffin_lim")}
CONFIGS = [{}, {"n_mels": 8}, {"n_fft": 512, "win_size": 512, "hop_size": 128, "fmax": 11025.0}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU thread pool oversubscribes the test workers' cores; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kw):
    return J["mel"].MelConfig(**kw), P["mel"].MelConfig(**kw)


@pytest.fixture(scope="module")
def wav_batch():
    """Tones and noise, and windowed noise: tests/test_mel.py's signals, 0.5 s."""
    rng = np.random.default_rng(0)
    t = np.arange(11025) / 22050.0
    y = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 3211 * t)
    y = y + 0.02 * rng.standard_normal(t.size)
    y2 = 0.5 * rng.standard_normal(t.size) * np.hanning(t.size)
    return np.stack([y, y2]).astype(np.float32)


def test_public_names_match_jax_package():
    jax_audio = importlib.import_module("matcha_tpu.audio")
    assert sorted(audio.__all__) == sorted(jax_audio.__all__)


@pytest.mark.parametrize("kw", CONFIGS)
def test_mel_filterbank_matches_jax(kw):
    jc, pc = _cfgs(kw)
    args = (pc.sample_rate, pc.n_fft, pc.n_mels, pc.fmin, pc.fmax)
    np.testing.assert_allclose(P["filters"].mel_filterbank(*args),
                               J["filters"].mel_filterbank(*args), atol=1e-7)
    freqs = np.linspace(0, 11025, 97)
    np.testing.assert_array_equal(P["filters"].hz_to_mel(freqs), J["filters"].hz_to_mel(freqs))
    mels = np.linspace(0, 40, 97)
    np.testing.assert_array_equal(P["filters"].mel_to_hz(mels), J["filters"].mel_to_hz(mels))


@pytest.mark.parametrize("kw", CONFIGS)
def test_stft_magnitude_matches_jax(kw, wav_batch):
    jc, pc = _cfgs(kw)
    want = np.asarray(J["mel"].stft_magnitude(jc, wav_batch))
    got = P["mel"].stft_magnitude(pc, torch.from_numpy(wav_batch)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kw", CONFIGS[:2])
def test_mel_spectrogram_matches_jax(kw, wav_batch):
    jc, pc = _cfgs(kw)
    want = np.asarray(J["mel"].mel_spectrogram(jc, wav_batch))
    got = P["mel"].mel_spectrogram(pc, torch.from_numpy(wav_batch)).numpy()
    assert got.shape == want.shape == (2, pc.n_mels, P["mel"].num_frames(pc, 11025))
    loud = want > np.log(1e-3)
    assert loud.mean() > 0.5
    np.testing.assert_allclose(got[loud], want[loud], atol=1e-3)
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("n", [256, 1000, 11025, 22050])
def test_num_frames_matches_jax(n):
    jc, pc = _cfgs({})
    assert P["mel"].num_frames(pc, n) == J["mel"].num_frames(jc, n)
    y = np.random.default_rng(n).standard_normal((1, n + 2 * pc.pad_size)).astype(np.float32)
    got = P["mel"].frame_signal(torch.from_numpy(y), pc.n_fft, pc.hop_size).numpy()
    want = np.asarray(J["mel"].frame_signal(jnp.asarray(y), jc.n_fft, jc.hop_size))
    assert got.shape == want.shape == (1, P["mel"].num_frames(pc, n), pc.n_fft)
    np.testing.assert_array_equal(got, want)


def test_load_and_process_audio_matches_jax(tmp_path, wav_batch):
    from scipy.io import wavfile

    path = tmp_path / "a.wav"
    wavfile.write(path, 22050, np.round(wav_batch[0] * 32767).astype(np.int16))
    y, sr = P["mel"].load_wav(path)
    y_jax, _ = J["mel"].load_wav(path)
    assert sr == 22050 and y.dtype == np.float32
    np.testing.assert_array_equal(y, y_jax)
    got = audio.load_and_process_audio(path, device="cpu").numpy()
    want = np.asarray(J["mel"].load_and_process_audio(path))
    loud = want > np.log(1e-3)
    np.testing.assert_allclose(got[loud], want[loud], atol=1e-3)
    np.testing.assert_allclose(got, want, atol=2e-2)
    with pytest.raises(ValueError, match="sample rate"):
        audio.load_and_process_audio(path, P["mel"].MelConfig(sample_rate=16000), device="cpu")


@pytest.mark.parametrize("kw", CONFIGS[::2])
def test_stft_and_istft_match_jax(kw, wav_batch):
    """Griffin-Lim's center=True STFT, and the windowed overlap-add ISTFT of
    its output at a crop that is not the whole signal."""
    jc, pc = _cfgs(kw)
    y = wav_batch[:, : 40 * pc.hop_size]
    want = np.asarray(J["griffin_lim"]._stft(jc, jnp.asarray(y)))
    got = P["griffin_lim"]._stft(pc, torch.from_numpy(y))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    n = y.shape[1] - pc.hop_size
    want_y = np.asarray(J["griffin_lim"]._istft(jc, jnp.asarray(want), n))
    got_y = P["griffin_lim"]._istft(pc, torch.from_numpy(want.copy()), n).numpy()
    assert got_y.shape == want_y.shape == (2, n)
    np.testing.assert_allclose(got_y, want_y, atol=1e-5)


def _log_mel(n_mels, frames, seed=0):
    """A log-mel in speech's range (about [-11.5, 2])."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, n_mels, frames)) * 1.5 - 4.0).astype(np.float32)


@pytest.mark.parametrize("kw", CONFIGS[:2])
def test_inverse_mel_matches_jax(kw):
    """rtol 1e-4 where the projection is not clamped; atol 1e-5 (1e-7 of the
    largest bin) where it clamps a bin to 0 and one side keeps a residue."""
    jc, pc = _cfgs(kw)
    mel = np.exp(_log_mel(pc.n_mels, 40))
    want = np.asarray(J["griffin_lim"].inverse_mel(jc, jnp.asarray(mel)))
    got = P["griffin_lim"].inverse_mel(pc, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, pc.n_fft // 2 + 1, 40) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", CONFIGS[:2])
def test_griffin_lim_and_mel_to_audio_match_jax_with_its_phase(kw):
    jc, pc = _cfgs(kw)
    log_mel = _log_mel(pc.n_mels, 48, seed=1)
    key = jax.random.PRNGKey(7)
    n_freq = pc.n_fft // 2 + 1
    phase = torch.from_numpy(np.array(jax.random.uniform(key, (2, n_freq, 48), minval=-np.pi,
                                                         maxval=np.pi)))
    mag = np.array(J["griffin_lim"].inverse_mel(jc, jnp.exp(jnp.asarray(log_mel))))
    want = np.asarray(J["griffin_lim"].griffin_lim(jc, jnp.asarray(mag), rng=key))
    got = P["griffin_lim"].griffin_lim(pc, torch.from_numpy(mag), phase=phase).numpy()
    assert got.shape == want.shape == (2, 48 * pc.hop_size)
    np.testing.assert_allclose(got, want, atol=1e-3)
    want = np.asarray(J["griffin_lim"].mel_to_audio(jc, jnp.asarray(log_mel), rng=key))
    got = P["griffin_lim"].mel_to_audio(pc, torch.from_numpy(log_mel), phase=phase).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert 0.01 < np.abs(want).max() < 10  # the bar is absolute at audio's amplitude


def test_griffin_lim_draws_its_phase_from_the_generator():
    _, pc = _cfgs({"n_mels": 8})
    mag = torch.rand(1, 513, 16, generator=torch.Generator().manual_seed(0))
    a = P["griffin_lim"].griffin_lim(pc, mag, n_iter=2, generator=torch.Generator().manual_seed(3))
    phase = P["griffin_lim"].draw_phase((1, 513, 16), torch.Generator().manual_seed(3), "cpu")
    assert phase.min() >= -np.pi and phase.max() < np.pi
    np.testing.assert_array_equal(a.numpy(),
                                  P["griffin_lim"].griffin_lim(pc, mag, n_iter=2,
                                                               phase=phase).numpy())
