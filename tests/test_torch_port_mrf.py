"""K2's plain version and the port's ResBlock1 against JAX (CPU).

The JAX side is the Pallas kernel `fused_mrf_step` in interpret mode, which
only takes a T with a power-of-two tiling (a multiple of 64 here); a ragged T
is held against the JAX `ResBlock1(impl="xla")` conv chain. Bar: f32 atol
2e-5, that of tests/test_vocoder.py. The CUDA kernel itself is held against
`mrf_step_plain` on the card by chip_smoke.py; its tile plan (`mrf_plan`),
computed in Python, is checked here: coverage, shared memory, grid size and
the halo arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.hifigan import ResBlock1 as JaxResBlock1
from matcha_tpu.ops.mrf_pallas import fused_mrf_step
from matcha_tpu_torch.models.hifigan import ResBlock1
from matcha_tpu_torch.ops.mrf import (SMEM_LIMIT, mrf_plan, mrf_plans, mrf_step,
                                      mrf_step_plain, pack_weights)


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
    """The kernel reads weight (s, co, ci, j) at byte b = (j C + ci) * elt of
    output channel co's tap-major row: 16-byte unit b // 16 of the conv's
    [unit][C_out][16 B] core-matrix layout; in bf16 and f32."""
    rng = np.random.default_rng(1)
    for c, dtype in ((32, torch.bfloat16), (32, torch.float32), (64, torch.bfloat16)):
        w1, _, w2, _ = (torch.from_numpy(a).to(dtype) for a in _weights(rng, c, 7))
        packed = pack_weights(w1, w2)
        elt = w1.element_size()
        assert packed.shape == (2, 7 * c * elt // 16, c, 16 // elt) and packed.is_contiguous()
        for s, w in enumerate((w1, w2)):
            for co, ci, j in ((0, 0, 0), (5, 17, 3), (31, 2, 6), (c - 1, c - 1, 6)):
                b = (j * c + ci) * elt
                assert packed[s, b // 16, co, (b % 16) // elt] == w[co, ci, j]


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


V1_STAGES = [(c, k, d) for c in (256, 128, 64, 32) for k in (3, 7, 11) for d in (1, 3, 5)]
PLAN_T = (1, 7, 64, 4099, 8192, 262144)


def _tiles(plan, t):
    """[(first, end)) output frames of each block of `plan` along time."""
    return [(t0, min(t0 + plan.tt, t)) for t0 in range(0, t, plan.tt)]


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [256, 128, 64, 32])
def test_mrf_plan_covers_fits_and_fills_the_card(c, elt):
    """At every (k, d) of HiFi-GAN v1's C-channel stage and T in PLAN_T: the
    plan's tiles cover each output frame exactly once, start on 8-frame (16-byte)
    boundaries, fit a Hopper block's shared memory (232,448 bytes), keep the
    z tile's halo, and give at least 132 blocks wherever the smallest tile the
    kernel has (16 frames a warp) would, at batch 1 and 4."""
    for _, k, d in (s for s in V1_STAGES if s[0] == c):
        for t in PLAN_T:
            for b in (1, 4):
                plan = mrf_plan(b, c, t, k, d, elt)
                tiles = _tiles(plan, t)
                assert [f for lo, hi in tiles for f in range(lo, hi)] == list(range(t))
                assert all(lo % 8 == 0 for lo, _ in tiles) and plan.tt % 8 == 0
                assert plan.blocks == b * len(tiles)
                assert plan.smem <= SMEM_LIMIT == 232448
                assert plan.tt + (k - 1) <= plan.lz and plan.lz % 16 == 0
                assert plan.chunk % (32 if elt == 2 else 128) == 0 and plan.chunk <= k * c * elt
                most = max(p.blocks for p in mrf_plans(b, c, t, k, d, elt))
                assert plan.blocks >= min(132, most)


def test_mrf_plan_fills_the_card_at_the_serving_shapes():
    """Every stage of a 1024-frame request at batch 1 (T = 8192 .. 262144)
    gets at least 132 blocks, in both dtypes."""
    frames = {256: 8192, 128: 65536, 64: 131072, 32: 262144}
    for c, k, d in V1_STAGES:
        for elt in (2, 4):
            assert mrf_plan(1, c, frames[c], k, d, elt).blocks >= 132


@pytest.mark.parametrize("c,k,d,elt", [(32, 11, 5, 2), (256, 11, 5, 4), (128, 3, 1, 2),
                                       (64, 7, 3, 4), (256, 7, 3, 2)])
def test_mrf_plan_tiles_stitch_to_the_whole_step(c, k, d, elt):
    """The halo arithmetic: mrf_step_plain on each planned tile's x window
    (its output frames +- d(k-1)/2 + (k-1)/2, cut at the sequence's ends,
    where the plain version's own zero padding is the step's), kept to the
    tile's frames and concatenated, equals the whole step (f32, atol 1e-6)."""
    rng = np.random.default_rng(c + k + d)
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _weights(rng, c, k))
    h = d * (k - 1) // 2 + (k - 1) // 2
    t = 2 * mrf_plan(2, c, 1, k, d, elt).tt + 13  # at least two whole tiles, one ragged
    plan = mrf_plan(2, c, t, k, d, elt)
    x = torch.from_numpy(rng.standard_normal((2, c, t)).astype(np.float32))
    parts = []
    for lo, hi in _tiles(plan, t):
        w0, w1_ = max(0, lo - h), min(t, hi + h)
        parts.append(mrf_step_plain(x[:, :, w0:w1_], w1, b1, w2, b2, d)[:, :, lo - w0:hi - w0])
    assert len(parts) >= 3 and t % plan.tt
    torch.testing.assert_close(torch.cat(parts, dim=2), mrf_step_plain(x, w1, b1, w2, b2, d),
                               rtol=0, atol=1e-6)
