"""The port's serving engine on the CPU: tiny Matcha + reduced HiFi-GAN.

- `synthesise(seeds=...)` equals the port's model + generator run by hand on the
  same `torch.Generator` noise;
- a request's waveform does not depend on its batch mates;
- int16 output is round(clip(wav) * 32767) of the float32 output;
- truncation past the largest budget is flagged;
- `synthesise_lowlatency` runs at a fixed budget.
Also the tokenizer copy against the JAX package's.
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.serve import ServeConfig, TTSEngine
from matcha_tpu_torch.text import simple_text_to_sequence, symbols


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU thread pool oversubscribes the test workers' cores and
    runs these small convolutions many times slower; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = tiny_config()
HCFG = HiFiGANConfig(upsample_initial_channel=32, num_mels=8)
HOP = 256
TEXTS = ["hello world", "flow matching is fast", "abc"]


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    model_sd = MatchaTTS(CFG).state_dict()
    # ~2 frames per token, so the texts land in the 32- and 64-frame budgets
    model_sd["encoder.duration_predictor.output_projection.bias"].fill_(0.7)
    return model_sd, Generator(HCFG).state_dict()


def _engine(weights, mel_budgets=(32, 64, 128), **kw):
    cfg = ServeConfig(n_timesteps=2, mel_budgets=mel_budgets, max_batch=4, **kw)
    return TTSEngine(weights[0], CFG, cfg, weights[1], HCFG, device="cpu")


@pytest.fixture(scope="module")
def engine(weights):
    return _engine(weights)


def test_synthesise_matches_model_and_generator(engine):
    """Same ids, same per-seed noise: the engine adds nothing but packing.
    Exact: the same CPU ops in the same order on both sides."""
    seeds = [11, 12]
    wavs, info = engine.synthesise(TEXTS[:2], seeds=seeds)
    budget = info["budget"]
    x, xl = engine._tokenize(TEXTS[:2])
    z = torch.stack([torch.randn((budget, CFG.n_feats),
                                 generator=torch.Generator().manual_seed(s)) for s in seeds])
    out = engine.model.synthesise_fixed(x, xl, budget, 2, z=z)
    want = torch.clamp(engine.vocoder(out["mel"]), -1, 1).numpy()
    assert info["mel_lengths"] == out["mel_lengths"].tolist()
    for i, wav in enumerate(wavs):
        assert wav.dtype == np.float32 and wav.shape == (info["mel_lengths"][i] * HOP,)
        np.testing.assert_array_equal(wav, want[i, : wav.shape[0]])


def test_request_independent_of_batch_mates(weights):
    """One budget, so every request decodes at 64 frames alone or batched.
    Tolerance 1e-5: the batch pads the text to another length, so the
    encoder's masked convs and softmaxes sum over other (zero) padding."""
    engine = _engine(weights, mel_budgets=(64,))
    batch, info = engine.synthesise(TEXTS, seeds=[5, 6, 7])
    assert not any(info["truncated"])
    for i, (text, seed) in enumerate(zip(TEXTS, [5, 6, 7])):
        solo, _ = engine.synthesise([text], seeds=[seed])
        np.testing.assert_allclose(solo[0], batch[i], atol=1e-5)


def test_int16_output_is_quantized_float(weights, engine):
    f32, info = engine.synthesise(TEXTS[:2], seeds=[3, 4])
    i16, info16 = _engine(weights, output_dtype="int16").synthesise(TEXTS[:2], seeds=[3, 4])
    assert info16["mel_lengths"] == info["mel_lengths"]
    for a, b in zip(f32, i16):
        assert b.dtype == np.int16
        np.testing.assert_array_equal(b, np.round(np.clip(a, -1, 1) * 32767).astype(np.int16))


def test_truncation_is_flagged(weights):
    eng = TTSEngine(weights[0], CFG, ServeConfig(n_timesteps=1, mel_budgets=(8,)),
                    weights[1], HCFG, device="cpu")
    with pytest.warns(UserWarning, match="truncated"):
        wavs, info = eng.synthesise(["a much longer sentence than eight frames", "a"],
                                    seeds=[1, 2])
    assert info["budget"] == 8 and info["truncated"] == [True, False]
    assert wavs[0].shape == (8 * HOP,)
    with pytest.warns(UserWarning, match="truncated"):
        _, info = eng.synthesise_lowlatency("a much longer sentence", seed=1)
    assert info["truncated"] is True


def test_lowlatency_at_fixed_budget(engine):
    wav, info = engine.synthesise_lowlatency(TEXTS[0], seed=9, budget=64)
    assert info["budget"] == 64 and not info["truncated"]
    assert wav.shape == (info["mel_lengths"][0] * HOP,) and np.isfinite(wav).all()
    # the same request through the two-stage path, when it picks the same budget
    wavs, info2 = engine.synthesise([TEXTS[0]], seeds=[9])
    if info2["budget"] == 64:
        np.testing.assert_allclose(wavs[0], wav, atol=1e-6)


def test_griffin_lim_is_not_ported(weights):
    with pytest.raises(NotImplementedError, match="M7"):
        TTSEngine(weights[0], CFG, ServeConfig(vocoder="griffin_lim"), weights[1], HCFG,
                  device="cpu")


def test_tokenizer_matches_jax_package():
    from matcha_tpu.text import simple_text_to_sequence as jax_tok
    from matcha_tpu.text.symbols import symbols as jax_symbols

    assert symbols == jax_symbols and len(symbols) == 150
    for text in TEXTS + ["Hello, World! It's 3 o'clock; café?"]:
        assert simple_text_to_sequence(text) == jax_tok(text)
