"""The port's training losses and gradients against the JAX package (CPU).

The JAX side is assembled from the JAX package's modules and ops with the
noise (t, z) and crop offsets injected, as tests/test_loss_parity.py does
(its `compute_losses` draws them from PRNG keys the port cannot reproduce):
encoder, Gaussian log-prior, `maximum_path_ref`, `duration_loss`, the U-Net
and the CFM and prior losses, each line as in `matcha_tpu/models/matcha.py`.
Bars: losses rtol 2e-4 (duration, prior) and 2e-3 (flow matching), as in
tests/test_loss_parity.py; gradients 1e-4 after dividing by max |grad|.
"""

import functools
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.compat.torch_import import convert_matcha_state_dict
from matcha_tpu.models.matcha import MatchaConfig as JaxConfig
from matcha_tpu.models.matcha import MatchaTTS as JaxMatcha
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.matcha import tiny_config as jax_tiny_config
from matcha_tpu.models.precision import mixed_precision_params as jax_mixed_precision
from matcha_tpu.nn.decoder import Decoder as JaxDecoder
from matcha_tpu.nn.encoder import TextEncoder as JaxEncoder
from matcha_tpu.ops import denormalize as jax_denormalize
from matcha_tpu.ops import duration_loss as jax_duration_loss
from matcha_tpu.ops import maximum_path_ref, sequence_mask
from matcha_tpu.ops import normalize as jax_normalize
from matcha_tpu_torch.compat.jax_params import matcha_state_dict_from_jax
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS, tiny_config
from matcha_tpu_torch.models.precision import mixed_precision_params
from matcha_tpu_torch.ops.masks import denormalize, duration_loss, normalize
from tests.golden_utils import synth_state_dict

SIGMA_MIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.partial(jax.jit, static_argnames=("cfg", "out_size", "decoder_dtype"))
def jax_losses(params, cfg, x, xl, y, yl, t, z, offsets=None, out_size=None,
               decoder_dtype=None):
    """The JAX package's training forward with (t, z) and crop offsets injected."""
    f = cfg.n_feats
    mu_x, logw, x_mask = JaxEncoder(cfg.encoder).apply({"params": params["encoder"]}, x, xl,
                                                      deterministic=True)
    y_mask = sequence_mask(yl, y.shape[1]).astype(x_mask.dtype)[:, :, None]
    attn_mask = x_mask[:, :, 0][:, :, None] * y_mask[:, :, 0][:, None, :]
    mu_sg = jax.lax.stop_gradient(mu_x)
    const = -0.5 * math.log(2 * math.pi) * f
    log_prior = (-0.5 * jnp.sum(y ** 2, axis=-1)[:, None, :]
                 + jnp.einsum("bxf,byf->bxy", mu_sg, y)
                 + (-0.5 * jnp.sum(mu_sg ** 2, axis=-1))[:, :, None] + const)
    attn = jax.lax.stop_gradient(maximum_path_ref(log_prior, attn_mask))
    logw_target = jnp.log(1e-8 + jnp.sum(attn, axis=-1))[:, :, None] * x_mask
    dur = jax_duration_loss(logw, logw_target, xl)
    if out_size is not None:
        off = jnp.minimum(offsets, jnp.maximum(yl - out_size, 0))
        y = jax.vmap(lambda a, o: jax.lax.dynamic_slice_in_dim(a, o, out_size, 0))(y, off)
        attn = jax.vmap(lambda a, o: jax.lax.dynamic_slice_in_dim(a, o, out_size, 1))(attn, off)
        y_mask = sequence_mask(jnp.minimum(yl, out_size), out_size).astype(y.dtype)[:, :, None]
        y = y * y_mask
        attn = attn * y_mask[:, :, 0][:, None, :]
    mu_y = jnp.einsum("bxy,bxf->byf", attn, mu_x)
    tt = t[:, None, None]
    phi = (1 - (1 - SIGMA_MIN) * tt) * z + tt * y
    u_target = y - (1 - SIGMA_MIN) * z
    dec_params, cast = params["decoder"], (lambda a: a)
    if decoder_dtype is not None:
        dec_params = jax_mixed_precision(params, decoder_dtype)["decoder"]
        cast = (lambda a: a.astype(decoder_dtype))
    u_pred = JaxDecoder(cfg.decoder).apply({"params": dec_params}, cast(phi), cast(y_mask),
                                           cast(mu_y), t, deterministic=True)
    u_pred = u_pred.astype(jnp.float32)
    diff = jnp.sum((u_pred - u_target) ** 2 * y_mask) / (jnp.sum(y_mask) * f)
    prior = jnp.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask)
    prior = prior / (jnp.sum(y_mask) * f)
    return dur + prior + diff, {"dur_loss": dur, "prior_loss": prior, "diff_loss": diff,
                                "attn": attn}


def _batch(seed, b, tx, ty, f, xl, yl):
    rng = np.random.default_rng(seed)
    x = rng.integers(3, 140, size=(b, tx)).astype(np.int32)
    y = rng.standard_normal((b, ty, f)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, size=b).astype(np.float32)
    z = rng.standard_normal((b, ty, f)).astype(np.float32)
    return x, np.asarray(xl, np.int32), y, np.asarray(yl, np.int32), t, z


def _port_losses(model, arrays, **kw):
    x, xl, y, yl, t, z = (torch.from_numpy(a) for a in arrays)
    return model.compute_losses(x, xl, y, yl, t=t, z=z, **kw)


def _check_losses(got, want, rtol=(2e-4, 2e-4, 2e-3)):
    np.testing.assert_array_equal(got["attn"].detach().numpy(), np.asarray(want["attn"]))
    for name, tol in zip(("dur_loss", "prior_loss", "diff_loss"), rtol):
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=tol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    """tiny_config with dropout 0, JAX decoder attention through the Pallas
    kernel (custom_vjp, interpret mode), the port on the same weights."""
    jcfg = jax_tiny_config()
    jcfg = replace(jcfg, decoder=replace(jcfg.decoder, attn_impl="pallas", dropout=0.0),
                   encoder=replace(jcfg.encoder, p_dropout=0.0, dp_p_dropout=0.0))
    params = jax.tree.map(np.asarray, init_params(JaxMatcha(jcfg), jax.random.PRNGKey(0),
                                                  tx=8, ty=16))
    # the prenet projection starts at zero; give it weights so its gradient path is live
    pre = params["encoder"]["ConvReluNorm_0"]["Dense_0"]
    pre["kernel"] = 0.1 * np.random.default_rng(0).standard_normal(
        pre["kernel"].shape).astype(np.float32)
    model = MatchaTTS(tiny_config()).eval()
    model.load_state_dict(matcha_state_dict_from_jax(params))
    return jcfg, params, model


def test_full_width_losses_match_jax():
    """MatchaConfig() at b = 2, Tx = 10, Ty = 24, with injected noise."""
    model = MatchaTTS(MatchaConfig()).eval()
    spec = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = synth_state_dict(spec)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    arrays = _batch(0, 2, 10, 24, 80, [10, 7], [24, 18])
    with torch.no_grad():
        got = _port_losses(model, arrays)
    _, want = jax_losses(convert_matcha_state_dict(sd), JaxConfig(), *arrays)
    _check_losses(got, want)


def test_tiny_gradients_match_jax(tiny):
    jcfg, params, model = tiny
    arrays = _batch(1, 3, 12, 32, 8, [12, 9, 5], [32, 27, 20])
    (_, want), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_losses(p, jcfg, *arrays), has_aux=True))(params)
    out = _port_losses(model, arrays)
    _check_losses(out, want)
    model.zero_grad()
    (out["dur_loss"] + out["prior_loss"] + out["diff_loss"]).backward()
    want_grads = matcha_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for key, w in want_grads.items():
        g = got_grads[key].numpy()
        w = w.numpy()
        ref = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g / ref, w / ref, atol=1e-4, err_msg=key)


def test_crop_with_injected_offsets_matches_jax(tiny):
    jcfg, params, model = tiny
    x, xl, y, yl, t, z = _batch(2, 2, 10, 48, 8, [10, 6], [48, 20])
    arrays = (x, xl, y, yl, t, z[:, :16])  # the noise has the window's shape
    offsets = np.array([20, 7], np.int32)  # the second is clamped to 20 - 16 = 4
    with torch.no_grad():
        got = _port_losses(model, arrays, out_size=16, offsets=torch.from_numpy(offsets))
    _, want = jax_losses(params, jcfg, *arrays, offsets=jnp.asarray(offsets), out_size=16)
    assert got["attn"].shape == (2, 10, 16)
    _check_losses(got, want)


def test_crop_offsets_are_drawn_within_range(tiny):
    _, _, model = tiny
    x, xl, y, yl, _, _ = (torch.from_numpy(a) for a in _batch(3, 2, 10, 48, 8, [10, 6], [48, 20]))
    for seed in range(4):
        with torch.no_grad():
            out = model.compute_losses(x, xl, y, yl, out_size=16,
                                       generator=torch.Generator().manual_seed(seed))
        # every window lies inside its sample: each of its 16 frames has one token
        torch.testing.assert_close(out["attn"].sum(dim=1), torch.ones(2, 16))
        assert torch.isfinite(out["diff_loss"])


def test_bf16_decoder_losses_match_jax_mixed_precision(tiny):
    """decoder_dtype=bf16: the U-Net on a bf16 view of the f32 masters. The
    duration and prior losses do not pass through the U-Net (2e-4); the flow
    loss takes a bf16 bar, 2e-2."""
    jcfg, params, model = tiny
    arrays = _batch(4, 2, 10, 32, 8, [10, 8], [32, 25])
    out = _port_losses(model, arrays, decoder_dtype=torch.bfloat16)
    _, want = jax_losses(params, jcfg, *arrays, decoder_dtype=jnp.bfloat16)
    _check_losses(out, want, rtol=(2e-4, 2e-4, 2e-2))
    (out["dur_loss"] + out["prior_loss"] + out["diff_loss"]).backward()
    for p in model.decoder.parameters():  # gradients reach the f32 masters
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32
    model.zero_grad()


def test_mixed_precision_view_leaves_the_masters():
    lin = torch.nn.Linear(4, 3)
    view = mixed_precision_params(lin)
    assert view["weight"].dtype == torch.bfloat16 and lin.weight.dtype == torch.float32
    out = torch.func.functional_call(lin, view, (torch.ones(2, 4, dtype=torch.bfloat16),))
    out.float().sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    torch.testing.assert_close(lin.weight.grad, torch.full((3, 4), 2.0))


def test_duration_loss_and_normalisation_match_jax():
    rng = np.random.default_rng(6)
    logw, tgt = (rng.standard_normal((3, 7, 1)).astype(np.float32) for _ in range(2))
    lengths = np.array([7, 5, 2], np.int32)
    np.testing.assert_allclose(
        float(duration_loss(*(torch.from_numpy(a) for a in (logw, tgt, lengths)))),
        float(jax_duration_loss(logw, tgt, lengths)), rtol=1e-6)
    mel = rng.standard_normal((2, 5, 9)).astype(np.float32)
    for mean, std in ((-5.5, 2.1), (rng.standard_normal(5), 1 + rng.random(5))):
        np.testing.assert_allclose(normalize(torch.from_numpy(mel), mean, std).numpy(),
                                   np.asarray(jax_normalize(mel, mean, std)), rtol=1e-6)
        np.testing.assert_allclose(denormalize(torch.from_numpy(mel), mean, std).numpy(),
                                   np.asarray(jax_denormalize(mel, mean, std)), rtol=1e-6)
