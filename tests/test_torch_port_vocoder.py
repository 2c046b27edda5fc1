"""The port's vocoder-training models against the JAX package (CPU, tiny widths).

- the discriminators (MPD and MSD, tiny and v1's full width): scores and
  every feature map, transposed to the JAX layout, rtol 1e-4 / atol 1e-5 on
  random weights carried by `discriminators_state_dict_from_jax`;
- the three GAN losses, rtol 1e-5;
- the weight-normed generator against `Generator(weight_norm=True)` on
  carried weights with perturbed scales, atol 1e-5; the carried scales lie on
  torch's dim 0 (a transposed conv's input channels), and folding them gives
  the JAX package's `fold_weight_norm`; a fresh port generator starts as
  flax's does (g = 1, kernels N(0, 0.01), biases 0) under the reference's key
  names;
- the folded serving form against the training form (the JAX test
  `test_fold_weight_norm_matches_weight_normed_generator`);
- one GAN step from carried state against `make_vocoder_step`: the five
  metrics within rtol 1e-4, every parameter within 2.5 lr of JAX's (Adam's
  first update is +-lr wherever a gradient's sign is in doubt) and nearly all
  within lr / 10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.audio.mel import MelConfig as JaxMelConfig
from matcha_tpu.models import hifigan as jax_hifigan
from matcha_tpu.train import vocoder as jax_vocoder
from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.compat.jax_params import (
    discriminators_state_dict_from_jax,
    hifigan_state_dict_from_jax,
)
from matcha_tpu_torch.data.audio_dataset import SyntheticWavDataset
from matcha_tpu_torch.models import hifigan
from matcha_tpu_torch.train import vocoder

SEG = 2048  # 8 mel frames at hop 256
TINY_GEN = dict(upsample_initial_channel=16)
TINY_DISC = dict(mpd_channels=(4, 8),
                 msd_spec=((8, 15, 1, 1, 7), (8, 41, 4, 4, 20), (8, 5, 1, 1, 2)))
RESBLOCKS = {"1": {}, "2": dict(resblock="2", resblock_dilation_sizes=((1, 3),) * 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _name(path) -> str:
    return "/".join(str(getattr(p, "key", p)) for p in path)


@functools.lru_cache(maxsize=None)
def _shapes(module, *shapes):
    """The parameter shapes of a flax module's init on zero inputs (traced, not compiled)."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          *(jnp.zeros(s) for s in shapes))["params"]


def _params(module, *shapes, seed, kernel_std=None, scale=(1.0, 1.0)):
    """A flax module's parameter tree drawn with numpy: kernels N(0,
    kernel_std^2), or N(0, 1 / fan-in) when None (activations of order 1);
    biases 0 with `kernel_std`, else N(0, 0.1^2); WeightNorm scales uniform
    in `scale`."""
    shapes = _shapes(module, *shapes)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = _name(path)
        if name.endswith("scale"):
            return rng.uniform(*scale, leaf.shape).astype(np.float32)
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("bias"):
            return np.zeros_like(n) if kernel_std is not None else 0.1 * n
        return n * (kernel_std if kernel_std is not None else 1 / np.sqrt(np.prod(leaf.shape[:-1])))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _waves(n, seed):
    ds = SyntheticWavDataset(n_items=n, segment_size=SEG, seed=seed)
    return np.stack([ds.get_segment(i, np.random.default_rng(0)) for i in range(n)])


def _jax_wn_generator(kw, seed=0, **draw):
    gen = jax_hifigan.Generator(jax_hifigan.HiFiGANConfig(**kw), weight_norm=True)
    return gen, _params(gen, (1, SEG // 256, 80), seed=seed, **draw)


def _jax_discriminators(kw, seed=0, **draw):
    disc = jax_vocoder.Discriminators(**kw)
    return disc, _params(disc, (1, SEG), (1, SEG), seed=seed, **draw)


# ------------------------------------------------------------ discriminators
@pytest.mark.parametrize("width", ["tiny", "v1"])
def test_discriminators_match_jax(width):
    kw = TINY_DISC if width == "tiny" else {}
    b = 2 if width == "tiny" else 1
    jdisc, params = _jax_discriminators(kw, seed=1)
    y, y_hat = _waves(b, 0), _waves(b, 7)
    want = jax.jit(jdisc.apply)({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
    disc = vocoder.Discriminators(**kw)
    disc.load_state_dict(discriminators_state_dict_from_jax(params))
    with torch.no_grad():
        got = disc(torch.from_numpy(y), torch.from_numpy(y_hat))
    for group, g, w in zip(("mpd", "msd"), got, want):
        outs_r, outs_g, fmaps_r, fmaps_g = g
        w_outs_r, w_outs_g, w_fmaps_r, w_fmaps_g = w
        assert len(outs_r) == len(w_outs_r) == (5 if group == "mpd" else 3)
        for o, wo in zip(outs_r + outs_g, w_outs_r + w_outs_g):
            np.testing.assert_allclose(o.numpy(), np.asarray(wo), rtol=1e-4, atol=1e-5)
        for fm, wfm in zip(fmaps_r + fmaps_g, w_fmaps_r + w_fmaps_g):
            assert len(fm) == len(wfm)
            for f, wf in zip(fm, wfm):
                wf = np.asarray(wf)
                wf = wf.transpose(0, 3, 1, 2) if wf.ndim == 4 else wf.transpose(0, 2, 1)
                np.testing.assert_allclose(f.numpy(), wf, rtol=1e-4, atol=1e-5)


def test_discriminators_keep_reference_names_and_init():
    disc = vocoder.Discriminators(**TINY_DISC)
    sd = disc.state_dict()
    assert "mpd.discriminators.4.convs.2.weight" in sd  # period 11, the unstrided conv
    assert sd["mpd.discriminators.0.conv_post.weight"].shape == (1, 8, 3, 1)
    assert sd["msd.discriminators.2.convs.1.weight"].shape == (8, 2, 41)  # groups 4
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith("bias"))
    kernels = torch.cat([v.flatten() for k, v in sd.items() if k.endswith("weight")])
    assert 0.008 < float(kernels.std()) < 0.012


def test_gan_losses_match_jax():
    rng = np.random.default_rng(3)
    shapes = [[(2, 4, 10, 2), (2, 1, 10, 2)], [(2, 8, 30), (2, 1, 30)]]
    fr, fg = ([[rng.standard_normal(s).astype(np.float32) for s in d] for d in shapes]
              for _ in range(2))
    outs_r, outs_g = ([rng.standard_normal((2, n)).astype(np.float32) for n in (20, 30, 7)]
                      for _ in range(2))
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    np.testing.assert_allclose(
        float(hifigan.feature_loss([t(d) for d in fr], [t(d) for d in fg])),
        float(jax_hifigan.feature_loss(fr, fg)), rtol=1e-5)
    got, want = hifigan.discriminator_loss(t(outs_r), t(outs_g)), \
        jax_hifigan.discriminator_loss(outs_r, outs_g)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    got, want = hifigan.generator_loss(t(outs_g)), jax_hifigan.generator_loss(outs_g)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


# ------------------------------------------------------------------ generator
@pytest.mark.parametrize("resblock", sorted(RESBLOCKS))
def test_weight_normed_generator_matches_jax(resblock):
    kw = {**TINY_GEN, **RESBLOCKS[resblock]}
    jgen, params = _jax_wn_generator(kw, seed=2, scale=(0.5, 2.0))
    mel = np.random.default_rng(4).standard_normal((2, SEG // 256, 80)).astype(np.float32)
    want = np.asarray(jax.jit(jgen.apply)({"params": params}, jnp.asarray(mel)))
    gen = hifigan.Generator(hifigan.HiFiGANConfig(**kw), weight_norm=True)
    gen.load_state_dict(hifigan_state_dict_from_jax(params, resblock))
    got = gen(torch.from_numpy(mel))
    assert got.requires_grad  # the training form keeps autograd
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_carried_scales_fold_as_jax_folds():
    """weight_g sits on torch's dim 0: a conv's output channels, a transposed
    conv's input channels (flax's feature axis is its kernel's last, and a
    ConvTranspose kernel is (k, C_out, C_in)); folding it gives JAX's fold."""
    _, params = _jax_wn_generator(TINY_GEN, seed=5, scale=(0.5, 2.0))
    sd = hifigan_state_dict_from_jax(params)
    assert sd["conv_pre.weight_g"].shape == (16, 1, 1)
    assert sd["ups.0.weight_g"].shape == (16, 1, 1) and sd["ups.0.weight_v"].shape == (16, 8, 16)
    assert sd["ups.3.weight_g"].shape == (2, 1, 1)  # C_in 2, C_out 1
    assert sd["conv_post.weight_g"].shape == (1, 1, 1)
    folded = hifigan.fold_weight_norm(sd)
    want = hifigan_state_dict_from_jax(_np_tree(jax_hifigan.fold_weight_norm(params)))
    assert set(folded) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(folded[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=k)


def test_fresh_generator_starts_as_flax_does():
    gen = hifigan.Generator(hifigan.HiFiGANConfig(**TINY_GEN), weight_norm=True)
    sd = gen.state_dict()
    _, params = _jax_wn_generator(TINY_GEN)
    carried = hifigan_state_dict_from_jax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in carried.items()}
    assert all(float((v - 1).abs().max()) == 0 for k, v in sd.items() if k.endswith("weight_g"))
    assert all(float(v.abs().max()) == 0 for k, v in sd.items() if k.endswith("bias"))
    directions = torch.cat([v.flatten() for k, v in sd.items() if k.endswith("weight_v")])
    assert 0.009 < float(directions.std()) < 0.011
    assert not any(k.endswith(".weight") for k in sd)


@pytest.mark.parametrize("resblock", sorted(RESBLOCKS))
def test_folded_serving_form_matches_training_form(resblock):
    kw = {**TINY_GEN, **RESBLOCKS[resblock]}
    cfg = hifigan.HiFiGANConfig(**kw)
    torch.manual_seed(0)
    train_form = hifigan.Generator(cfg, weight_norm=True)
    with torch.no_grad():
        for name, p in train_form.named_parameters():
            if name.endswith("weight_g"):
                p.uniform_(0.5, 2.0)
    serving = hifigan.Generator(cfg)
    serving.load_state_dict(train_form.state_dict())  # folds weight_g / weight_v
    mel = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, SEG // 256, 80)).astype(np.float32))
    want = train_form(mel).detach()
    got = serving(mel)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- GAN step
def test_gan_step_matches_jax():
    cfg = vocoder.VocoderTrainConfig()
    jcfg = jax_vocoder.VocoderTrainConfig()
    # the trainer's starting point: kernels N(0, 0.01), biases 0, scales 1
    jgen, gen_p = _jax_wn_generator(TINY_GEN, seed=6, kernel_std=0.01)
    jdisc, disc_p = _jax_discriminators(TINY_DISC, seed=7, kernel_std=0.01)
    tx_g, tx_d = jax_vocoder.make_optimizers(jcfg, steps_per_epoch=4)
    step, _ = jax_vocoder.make_vocoder_step(jgen, jdisc, tx_g, tx_d, jcfg, JaxMelConfig())
    y = _waves(2, 0)
    gen_j, disc_j, _, _, metrics = step(gen_p, disc_p, tx_g.init(gen_p), tx_d.init(disc_p),
                                        jnp.asarray(y))

    gen = hifigan.Generator(hifigan.HiFiGANConfig(**TINY_GEN), weight_norm=True)
    gen.load_state_dict(hifigan_state_dict_from_jax(gen_p))
    disc = vocoder.Discriminators(**TINY_DISC)
    disc.load_state_dict(discriminators_state_dict_from_jax(disc_p))
    opt_g, opt_d = vocoder.make_optimizers(cfg, 4, gen.parameters(), disc.parameters())
    port_step = vocoder.make_vocoder_step(gen, disc, opt_g, opt_d, cfg, MelConfig())
    row = np.concatenate([opt_g.advance(1), opt_d.advance(1)], axis=1)[0]
    got = port_step(torch.from_numpy(y), torch.from_numpy(row))

    for name, value in zip(vocoder.METRICS, got.tolist()):
        np.testing.assert_allclose(value, float(metrics[name]), rtol=1e-4, err_msg=name)
    for module, want in ((gen, hifigan_state_dict_from_jax(_np_tree(gen_j))),
                         (disc, discriminators_state_dict_from_jax(_np_tree(disc_j)))):
        sd = module.state_dict()
        assert set(sd) == set(want)
        gaps = torch.cat([(sd[k] - v).abs().flatten() for k, v in want.items()])
        assert float(gaps.max()) <= 2.5 * cfg.lr, float(gaps.max())
        assert float((gaps > cfg.lr / 10).float().mean()) < 0.01
