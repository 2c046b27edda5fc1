"""The port's reference-checkpoint loaders (`compat/torch_import.py`), on the CPU.

- `golden_parity.npz`'s reduced-width Matcha weights, saved as a Lightning
  checkpoint with an unrelated extra key, load into the port and give the
  frozen encoder and decoder outputs within tests/test_golden_parity.py's bars;
- its weight-normed generator, saved as `{"generator": ...}`, loads folded and
  gives the frozen waveform within 2e-5;
- the full-width `golden_e2e.npz` weights through a file load the same model as
  the dict itself, and synthesise as the JAX package's loader of the same file
  does, on the injected noise, within tests/test_golden_e2e.py's bars;
- a missing key or a wrong shape raises, naming the key.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu_torch.compat.torch_import import (
    load_hifigan_torch_checkpoint,
    load_matcha_torch_checkpoint,
)
from matcha_tpu_torch.models.hifigan import HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
from matcha_tpu_torch.nn.decoder import DecoderConfig
from matcha_tpu_torch.nn.encoder import EncoderConfig
from tests.golden_utils import synth_state_dict

FIXDIR = Path(__file__).parent / "fixtures"
# reduced widths of golden_parity.npz (tests/make_golden_fixtures.py)
ENC_KW = dict(n_feats=16, n_channels=64, filter_channels=128, n_heads=2, n_layers=6,
              filter_channels_dp=32)
DEC_KW = dict(in_channels=32, out_channels=16, channels=(64, 64), num_heads=2,
              attention_head_dim=32, num_mid_blocks=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parity_fx():
    return np.load(FIXDIR / "golden_parity.npz")


def _sd(fx, prefix):
    return {k[len(prefix):]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith(prefix)}


def _reduced_model():
    return MatchaTTS(MatchaConfig(n_feats=16, encoder=EncoderConfig(**ENC_KW),
                                  decoder=DecoderConfig(**DEC_KW))).eval()


@pytest.fixture(scope="module")
def lightning_ckpt(parity_fx, tmp_path_factory):
    """The reduced weights as a Lightning checkpoint, with an unrelated key."""
    sd = _sd(parity_fx, "sd/")
    sd["unrelated.running_stat"] = torch.zeros(3)
    path = tmp_path_factory.mktemp("ckpt") / "matcha.ckpt"
    torch.save({"state_dict": sd, "epoch": 7, "hyper_parameters": {"n_vocab": 150}}, path)
    return path


def test_lightning_checkpoint_reproduces_golden_encoder_and_decoder(parity_fx, lightning_ckpt):
    model = _reduced_model()
    sd = load_matcha_torch_checkpoint(lightning_ckpt, model)
    assert "unrelated.running_stat" not in sd and set(sd) == set(model.state_dict())
    with torch.no_grad():
        mu, logw, _ = model.encoder(torch.from_numpy(parity_fx["enc/x"]),
                                    torch.from_numpy(parity_fx["enc/xl"]))
        f = {k: torch.from_numpy(parity_fx[f"dec/{k}"]) for k in ("x", "mask", "mu", "t")}
        out = model.decoder.estimator(f["x"], f["mask"], f["mu"], f["t"])
    np.testing.assert_allclose(mu.numpy(), parity_fx["enc/mu"], atol=2e-4)
    np.testing.assert_allclose(logw.numpy(), parity_fx["enc/logw"], atol=2e-4)
    np.testing.assert_allclose(out.numpy(), parity_fx["dec/out"], atol=5e-4)


def test_generator_checkpoint_reproduces_golden_waveform(parity_fx, tmp_path):
    gsd = _sd(parity_fx, "gsd/")
    assert any(k.endswith(".weight_g") for k in gsd)  # weight-normed, as generator_v1
    path = tmp_path / "generator_v1"
    torch.save({"generator": gsd}, path)
    gen = load_hifigan_torch_checkpoint(path, HiFiGANConfig(upsample_initial_channel=64))
    assert not gen.training and not any(k.endswith("weight_g") for k in gen.state_dict())
    wav = gen(torch.from_numpy(parity_fx["gen/mel"].transpose(0, 2, 1)))
    assert wav.shape == parity_fx["gen/wav"].shape
    np.testing.assert_allclose(wav.numpy(), parity_fx["gen/wav"], atol=2e-5)
    # a bare state dict (no "generator" entry) loads the same
    torch.save(gsd, path)
    bare = load_hifigan_torch_checkpoint(path, HiFiGANConfig(upsample_initial_channel=64))
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(bare.state_dict()[k], v, rtol=0, atol=0)


def test_full_width_file_matches_dict_and_jax_loader(tmp_path):
    from matcha_tpu.compat.torch_import import load_matcha_torch_checkpoint as jax_load
    from matcha_tpu.models.matcha import MatchaConfig as JaxConfig
    from matcha_tpu.models.matcha import MatchaTTS as JaxMatcha

    fx = np.load(FIXDIR / "golden_e2e.npz")
    spec = {k[len("spec/"):]: tuple(fx[k]) for k in fx.files if k.startswith("spec/")}
    weights = {k: torch.from_numpy(v) for k, v in synth_state_dict(spec).items()}
    path = tmp_path / "matcha_final.ckpt"
    torch.save({"state_dict": weights, "epoch": 1}, path)

    sd = load_matcha_torch_checkpoint(path)  # default: the full-width MatchaConfig()
    direct = MatchaTTS(MatchaConfig()).eval()
    direct.load_state_dict(weights)
    assert set(sd) == set(direct.state_dict())
    for k, v in direct.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    model = MatchaTTS(MatchaConfig()).eval()
    model.load_state_dict(sd)

    args = (int(fx["y_max_length"]), int(fx["n_timesteps"]), float(fx["temperature"]),
            float(fx["length_scale"]))
    out = model.synthesise_fixed(torch.from_numpy(fx["x"]), torch.from_numpy(fx["xl"]),
                                 *args, z=torch.from_numpy(fx["z"].transpose(0, 2, 1)))
    jmodel = JaxMatcha(JaxConfig())
    jparams = jax_load(path)  # no tree check (a 15 s flax init): the run reads every key
    jout = jmodel.apply({"params": jparams}, jnp.asarray(fx["x"], jnp.int32),
                        jnp.asarray(fx["xl"], jnp.int32), *args,
                        method=JaxMatcha.synthesise_fixed,
                        z=jnp.asarray(fx["z"].transpose(0, 2, 1)))
    np.testing.assert_array_equal(out["mel_lengths"].numpy(), np.asarray(jout["mel_lengths"]))
    np.testing.assert_array_equal(out["attn"].numpy(), np.asarray(jout["attn"]))
    t_pad = fx["mel_masked"].shape[-1]
    mask = (np.arange(t_pad)[None, :, None] < fx["mel_lengths"][:, None, None])
    np.testing.assert_allclose(out["encoder_outputs"].numpy() * mask,
                               np.asarray(jout["encoder_outputs"]) * mask, atol=5e-4)
    np.testing.assert_allclose(out["mel"].numpy() * mask, np.asarray(jout["mel"]) * mask,
                               atol=1e-3)
    np.testing.assert_allclose(out["mel"].numpy().transpose(0, 2, 1) * mask.transpose(0, 2, 1),
                               fx["mel_masked"], atol=1e-3)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_matcha_loader_raises_on_missing_key_or_wrong_shape(parity_fx, tmp_path, fault):
    sd = _sd(parity_fx, "sd/")
    key = "decoder.estimator.final_proj.weight"
    if fault == "missing":
        del sd[key]
    else:
        sd[key] = sd[key][:, :-1]
    path = tmp_path / "bad.ckpt"
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        load_matcha_torch_checkpoint(path, _reduced_model())


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_generator_loader_raises_on_missing_key_or_wrong_shape(parity_fx, tmp_path, fault):
    gsd = _sd(parity_fx, "gsd/")
    if fault == "missing":
        del gsd["conv_post.bias"]
        key = "conv_post.bias"
    else:
        gsd["ups.0.weight_v"] = gsd["ups.0.weight_v"][:, :, :-1]
        key = "ups.0.weight"
    path = tmp_path / "bad_generator"
    torch.save({"generator": gsd}, path)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        load_hifigan_torch_checkpoint(path, HiFiGANConfig(upsample_initial_channel=64))
