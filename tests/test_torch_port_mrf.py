"""K2's plain version and the port's ResBlock1 against JAX (CPU).

The JAX side is the Pallas kernel `fused_mrf_step` in interpret mode, which
only takes a T with a power-of-two tiling (a multiple of 64 here); a ragged T
is held against the JAX `ResBlock1(impl="xla")` conv chain. Bar: f32 atol
2e-5, that of tests/test_vocoder.py. The CUDA kernel itself is held against
`mrf_step_plain` on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.hifigan import ResBlock1 as JaxResBlock1
from matcha_tpu.ops.mrf_pallas import fused_mrf_step
from matcha_tpu_torch.models.hifigan import ResBlock1
from matcha_tpu_torch.ops.mrf import mrf_step, mrf_step_plain, pack_weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU thread pool oversubscribes the test workers' cores and
    runs these small convolutions many times slower; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(rng, c, k):
    w1, w2 = (rng.standard_normal((c, c, k)).astype(np.float32) / np.sqrt(c * k) for _ in range(2))
    b1, b2 = (0.05 * rng.standard_normal((c,)).astype(np.float32) for _ in range(2))
    return w1, b1, w2, b2


@pytest.mark.parametrize("c", [32, 128])
@pytest.mark.parametrize("k,d", [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)])
def test_mrf_step_plain_matches_pallas(c, k, d):
    rng = np.random.default_rng(100 * k + d)
    x = rng.standard_normal((1, c, 64)).astype(np.float32)
    w1, b1, w2, b2 = _weights(rng, c, k)
    want = fused_mrf_step(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(w1.transpose(2, 1, 0)),
                          jnp.asarray(b1), jnp.asarray(w2.transpose(2, 1, 0)), jnp.asarray(b2),
                          dilation=d)
    got = mrf_step_plain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1), atol=2e-5)


def _carry(params):
    """JAX ResBlock1 tree -> port ResBlock1 state dict."""
    sd = {}
    for m in range(3):
        for s, name in ((0, "convs1"), (1, "convs2")):
            conv = params[f"WNConv_{2 * m + s}"]["Conv_0"]
            sd[f"{name}.{m}.weight"] = torch.from_numpy(
                np.array(conv["kernel"], np.float32).transpose(2, 1, 0).copy())
            sd[f"{name}.{m}.bias"] = torch.from_numpy(np.array(conv["bias"], np.float32))
    return sd


@pytest.mark.parametrize("impl,t", [("xla", 200), ("pallas", 128)])
def test_resblock1_matches_jax(impl, t):
    """A whole port ResBlock1 (three K2 steps) on weights carried from JAX; a
    ragged T against the XLA chain, a tiled T against the Pallas blocks."""
    c, k = 32, 7
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    jblk = JaxResBlock1(c, k, (1, 3, 5), impl=impl)
    params = JaxResBlock1(c, k, (1, 3, 5)).init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a * 5.0, params)  # std 0.05 weights
    want = jblk.apply({"params": params}, jnp.asarray(x))
    blk = ResBlock1(c, k, (1, 3, 5)).eval()
    blk.load_state_dict(_carry(params))
    with torch.no_grad():
        got = blk(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1), atol=2e-5)


def test_mrf_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 10)).astype(np.float32))
    w = [torch.from_numpy(a) for a in _weights(rng, 8, 3)]
    before = mrf_step.launches
    torch.testing.assert_close(mrf_step(x, *w, 3), mrf_step_plain(x, *w, 3), rtol=0, atol=0)
    assert mrf_step.launches == before


def test_pack_weights_is_tap_major():
    """The kernel reads packed[s, co, j, ci] = (w1, w2)[s][co, ci, j]."""
    rng = np.random.default_rng(1)
    w1, _, w2, _ = (torch.from_numpy(a) for a in _weights(rng, 32, 7))
    packed = pack_weights(w1, w2)
    assert packed.shape == (2, 32, 7, 32) and packed.is_contiguous()
    for s, w in enumerate((w1, w2)):
        for co, ci, j in ((0, 0, 0), (5, 17, 3), (31, 2, 6)):
            assert packed[s, co, j, ci] == w[co, ci, j]


def test_resblock1_packs_weights_once_until_they_change():
    """ResBlock1 keeps each step's packing until a load or a cast changes the
    weights, then packs again from the new weights."""
    c, k = 32, 3
    blk = ResBlock1(c, k, (1, 3, 5)).eval()
    first = blk._packed_weights(1)
    assert blk._packed_weights(1) is first
    torch.testing.assert_close(first, pack_weights(blk.convs1[1].weight, blk.convs2[1].weight),
                               rtol=0, atol=0)
    sd = {key: torch.full_like(v, 0.5) for key, v in blk.state_dict().items()}
    blk.load_state_dict(sd)
    loaded = blk._packed_weights(1)
    assert loaded is not first and bool((loaded == 0.5).all())
    blk.to(torch.bfloat16)
    cast = blk._packed_weights(1)
    assert cast.dtype == torch.bfloat16 and bool((cast == 0.5).all())
