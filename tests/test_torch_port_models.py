"""The port's models against the frozen fixtures and the live JAX package (CPU).

- encoder, decoder and generator load the reduced-width reference state dicts of
  `golden_parity.npz` and meet the bars of tests/test_golden_parity.py;
- full-width `synthesise_fixed` loads the synthesized state dicts of
  `golden_e2e*.npz` directly and meets the bars of tests/test_golden_e2e.py;
- `tiny_config` and a reduced generator carried from JAX `init` parameters by
  `compat/jax_params.py` match the JAX modules on the same inputs and noise;
- the weight bridge inverts the JAX package's torch converters.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.compat.torch_import import convert_hifigan_state_dict, convert_matcha_state_dict
from matcha_tpu_torch.compat.jax_params import hifigan_state_dict_from_jax, matcha_state_dict_from_jax
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig, fold_weight_norm
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS, tiny_config
from matcha_tpu_torch.nn.decoder import DecoderConfig
from matcha_tpu_torch.nn.encoder import EncoderConfig
from tests.golden_utils import synth_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU thread pool oversubscribes the test workers' cores and
    runs these small convolutions many times slower; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FIXDIR = Path(__file__).parent / "fixtures"
# reduced widths of golden_parity.npz (tests/make_golden_fixtures.py)
ENC_KW = dict(n_feats=16, n_channels=64, filter_channels=128, n_heads=2, n_layers=6,
              filter_channels_dp=32)
DEC_KW = dict(in_channels=32, out_channels=16, channels=(64, 64), num_heads=2,
              attention_head_dim=32, num_mid_blocks=2)


def _sd(fx, prefix):
    return {k[len(prefix):]: torch.from_numpy(fx[k]) for k in fx.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def parity_fx():
    return np.load(FIXDIR / "golden_parity.npz")


@pytest.fixture(scope="module")
def reduced_model(parity_fx):
    model = MatchaTTS(MatchaConfig(n_feats=16, encoder=EncoderConfig(**ENC_KW),
                                   decoder=DecoderConfig(**DEC_KW))).eval()
    model.load_state_dict(_sd(parity_fx, "sd/"))
    return model


def test_encoder_matches_golden(parity_fx, reduced_model):
    with torch.no_grad():
        mu, logw, _ = reduced_model.encoder(torch.from_numpy(parity_fx["enc/x"]),
                                            torch.from_numpy(parity_fx["enc/xl"]))
    np.testing.assert_allclose(mu.numpy(), parity_fx["enc/mu"], atol=2e-4)
    np.testing.assert_allclose(logw.numpy(), parity_fx["enc/logw"], atol=2e-4)


def test_decoder_matches_golden(parity_fx, reduced_model):
    f = {k: torch.from_numpy(parity_fx[f"dec/{k}"]) for k in ("x", "mask", "mu", "t")}
    with torch.no_grad():
        out = reduced_model.decoder.estimator(f["x"], f["mask"], f["mu"], f["t"])
    np.testing.assert_allclose(out.numpy(), parity_fx["dec/out"], atol=5e-4)


def test_generator_matches_golden_weight_normed(parity_fx):
    gen = Generator(HiFiGANConfig(upsample_initial_channel=64)).eval()
    gen.load_state_dict(_sd(parity_fx, "gsd/"))  # weight_g/weight_v, folded on load
    wav = gen(torch.from_numpy(parity_fx["gen/mel"].transpose(0, 2, 1)))
    assert wav.shape == parity_fx["gen/wav"].shape
    np.testing.assert_allclose(wav.numpy(), parity_fx["gen/wav"], atol=2e-5)


@pytest.mark.parametrize("name", ["golden_e2e.npz", "golden_e2e_midpoint.npz"])
def test_full_width_synthesise_matches_golden(name):
    fx = np.load(FIXDIR / name)
    spec = {k[len("spec/"):]: tuple(fx[k]) for k in fx.files if k.startswith("spec/")}
    solver = str(fx["solver"]) if "solver" in fx.files else "euler"
    model = MatchaTTS(MatchaConfig(solver=solver)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in synth_state_dict(spec).items()})
    out = model.synthesise_fixed(
        torch.from_numpy(fx["x"]), torch.from_numpy(fx["xl"]), int(fx["y_max_length"]),
        int(fx["n_timesteps"]), float(fx["temperature"]), float(fx["length_scale"]),
        z=torch.from_numpy(fx["z"].transpose(0, 2, 1)))

    np.testing.assert_array_equal(out["mel_lengths"].numpy(), fx["mel_lengths"])
    np.testing.assert_array_equal(out["attn"].numpy(), fx["attn"])
    t_pad = fx["mel_masked"].shape[-1]
    mask = (np.arange(t_pad)[None, None, :] < fx["mel_lengths"][:, None, None]).astype(np.float32)
    mu_y = out["encoder_outputs"].numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(mu_y * mask, fx["mu_y_masked"], atol=5e-4)
    mel = out["mel"].numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(mel * mask, fx["mel_masked"], atol=1e-3)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("solver", ["euler", "midpoint"])
def test_tiny_synthesise_matches_live_jax(solver):
    """JAX `init` parameters carried across; same ids and noise; f32 both sides.
    Tolerance 1e-4: two f32 implementations of the whole chain (encoder, path,
    3 ODE steps of the U-Net) summing in different orders."""
    import dataclasses

    from matcha_tpu.models import matcha as jm

    jcfg = dataclasses.replace(jm.tiny_config(), solver=solver)
    jmodel = jm.MatchaTTS(jcfg)
    params = jm.init_params(jmodel, jax.random.PRNGKey(3))
    model = MatchaTTS(dataclasses.replace(tiny_config(), solver=solver)).eval()
    model.load_state_dict(matcha_state_dict_from_jax(_np_tree(params)))

    rng = np.random.default_rng(0)
    x = rng.integers(3, 140, size=(2, 16))
    xl = np.array([16, 11])
    budget, steps = 64, 3
    z = rng.standard_normal((2, budget, 8)).astype(np.float32)
    want = jax.jit(lambda p, x_, xl_, z_: jmodel.apply(
        {"params": p}, x_, xl_, budget, steps, 0.667, 1.0,
        method=jm.MatchaTTS.synthesise_fixed, z=z_))(
        params, jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32), jnp.asarray(z))
    got = model.synthesise_fixed(torch.from_numpy(x), torch.from_numpy(xl), budget, steps,
                                 0.667, 1.0, z=torch.from_numpy(z))
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(want["attn"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]), atol=1e-4)


# resblock "2" with the reference's v3 dilations
@pytest.mark.parametrize("resblock,dilations", [("1", ((1, 3, 5),) * 3),
                                                ("2", ((1, 2), (2, 6), (3, 12)))])
def test_reduced_generator_matches_live_jax(resblock, dilations):
    """A JAX Generator parameter tree carried across; the tiny model's mel in.
    The tree's structure comes from `init` (traced, not compiled); its values
    are seeded normals of std 0.05, a signal that survives the MRF steps."""
    from matcha_tpu.models import hifigan as jh

    kw = dict(upsample_initial_channel=32, num_mels=8, resblock=resblock,
              resblock_dilation_sizes=dilations)
    jgen = jh.Generator(jh.HiFiGANConfig(**kw))
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                          shapes)
    gen = Generator(HiFiGANConfig(**kw)).eval()
    gen.load_state_dict(hifigan_state_dict_from_jax(_np_tree(params), resblock))

    torch.manual_seed(0)
    model = MatchaTTS(tiny_config()).eval()
    mel = model.synthesise_fixed(torch.tensor([[20, 30, 40, 50, 60]]), torch.tensor([5]),
                                 16, 2, z=torch.randn(1, 16, 8))["mel"]
    want = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel.numpy())))
    got = gen(mel).numpy()
    assert got.shape == want.shape == (1, 16 * 256)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_matcha_bridge_inverts_converter():
    fx = np.load(FIXDIR / "golden_e2e.npz")
    spec = {k[len("spec/"):]: tuple(fx[k]) for k in fx.files if k.startswith("spec/")}
    sd = synth_state_dict(spec)
    back = matcha_state_dict_from_jax(convert_matcha_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_hifigan_bridge_inverts_converter(parity_fx):
    gsd = {k[len("gsd/"):]: parity_fx[k] for k in parity_fx.files if k.startswith("gsd/")}
    cfg_j = __import__("matcha_tpu.models.hifigan", fromlist=["HiFiGANConfig"]).HiFiGANConfig(
        upsample_initial_channel=64)
    back = hifigan_state_dict_from_jax(convert_hifigan_state_dict(gsd, cfg_j))
    folded = fold_weight_norm({k: torch.from_numpy(v) for k, v in gsd.items()})
    assert set(back) == set(folded)
    assert not any(k.endswith(("weight_g", "weight_v")) for k in back)
    for k, v in folded.items():  # two f32 folds of g*v/||v||: rounding apart
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-8, err_msg=k)
