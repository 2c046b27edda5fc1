"""K1's plain version and the port's decoder transformer block against JAX (CPU).

The JAX side is the Pallas kernel `fused_attention`, run in interpret mode (its
default off the TPU), and for the row log-sum-exp that K1 hands its backward,
`jax.nn.logsumexp` of the scores. Bars are those of
tests/test_attention_pallas.py: f32 atol/rtol 1e-5, bf16 2e-2. The CUDA kernel
itself is held against `attention_plain` on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.attention_pallas import fused_attention
from matcha_tpu_torch.compat import jax_params
from matcha_tpu_torch.nn.transformer import BasicTransformerBlock
from matcha_tpu_torch.ops.attention import (
    attention,
    attention_forward,
    attention_plain,
    key_splits,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU thread pool oversubscribes the test workers' cores and
    runs these small convolutions many times slower; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ragged_bias(rng, b, t):
    """Raw 0/1 key mask of ragged lengths, as the decoder passes it."""
    lengths = np.array([t, max(1, t - 37)][:b])
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("t", [64, 200])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_attention_plain_matches_pallas(dtype, tol, t, with_bias):
    b, h, d = 2, 4, 64
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    bias = _ragged_bias(rng, b, t) if with_bias else None
    jdt = getattr(jnp, dtype)
    want = fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                           None if bias is None else jnp.asarray(bias, jdt), scale=d ** -0.5)
    tdt = getattr(torch, dtype)
    got = attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          None if bias is None else torch.from_numpy(bias).to(tdt), d ** -0.5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("t", [64, 200])
def test_attention_plain_lse_matches_jax_logsumexp(t, with_bias):
    """The lse K1 writes for its backward: logsumexp over keys of
    q k^T * scale + bias, f32 (1e-5)."""
    b, h, d = 2, 4, 64
    rng = np.random.default_rng(t + 1)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    bias = _ragged_bias(rng, b, t) if with_bias else np.zeros((b, t), np.float32)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k),
                   precision=jax.lax.Precision.HIGHEST) * d ** -0.5
    want = jax.nn.logsumexp(s + jnp.asarray(bias)[:, None, None, :], axis=-1)
    o, lse = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.from_numpy(bias) if with_bias else None, d ** -0.5,
                             with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(o, attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                                  torch.from_numpy(bias) if with_bias else None,
                                                  d ** -0.5), rtol=0, atol=0)


def test_attention_forward_with_lse_on_cpu_is_plain():
    q, k, v = (torch.randn(2, 2, 40, 64, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    before = attention.launches
    got = attention_forward(q, k, v, None, 0.125, with_lse=True)
    want = attention_plain(q, k, v, None, 0.125, with_lse=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert attention.launches == before


@pytest.mark.parametrize("dtype,b,t,want", [
    ("bfloat16", 1, 1024, 2),   # low-latency request at budget 1024: 64 blocks, 132 SMs
    ("bfloat16", 1, 512, 4),    # its second U-Net level: 32 blocks of 8 key tiles
    ("bfloat16", 4, 512, 1),    # batch 4 at budget 512: 128 blocks, about a wave
    ("bfloat16", 4, 256, 1),    # its second level: 64 blocks of only 4 key tiles
    ("bfloat16", 1, 64, 1),     # one key tile: nothing to split
    ("bfloat16", 16, 448, 1),   # training at batch 16: 448 blocks, more than a wave
    ("float32", 1, 1024, 4),    # f32 splits up to two waves,
    ("float32", 4, 512, 2),
    ("float32", 4, 256, 2),     # and blocks of 4 key tiles
    ("float32", 2, 1000, 2),    # 128 blocks of 16 tiles: two waves hold 2 splits
    ("float32", 16, 448, 1),
])
def test_key_splits_fill_the_card(dtype, b, t, want):
    """K1 splits the keys of blocks that walk many key tiles (8 in bf16, 4 in
    f32) into a power of two of ranges of at least 2 tiles, while the grid
    stays within one (bf16) or two (f32) waves of an H100's 132 SMs."""
    assert key_splits(b, 4, t, getattr(torch, dtype), 132) == want


def test_attention_wrapper_takes_plain_path_on_cpu():
    q = torch.randn(1, 2, 8, 64)
    before = attention.launches
    out = attention(q, q, q, None, 0.125)
    torch.testing.assert_close(out, attention_plain(q, q, q, None, 0.125), rtol=0, atol=0)
    assert attention.launches == before  # the plain version is no launch


def test_transformer_block_matches_jax_pallas():
    """Port block on weights carried from a JAX `attn_impl="pallas"` block.
    Tolerance 1e-5: f32 on both sides, one block."""
    from matcha_tpu.nn.transformer import BasicTransformerBlock as JaxBlock

    dim, heads, head_dim, b, t = 64, 4, 16, 2, 48
    jblk = JaxBlock(dim, heads, head_dim, attn_impl="pallas")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, dim)).astype(np.float32)
    mask = _ragged_bias(rng, b, t)
    shapes = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))["params"]

    def leaf(path, a):  # seeded: norms near 1, biases near 0, kernels fan-in scaled
        n = rng.standard_normal(a.shape).astype(np.float32)
        name = path[-1].key
        if name == "scale":
            return 1 + 0.05 * n
        return 0.05 * n if name == "bias" else n / np.sqrt(a.shape[0])

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    want = jblk.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))

    sd = {}
    jax_params._transformer(sd, "blk", jax.tree.map(np.asarray, params))
    blk = BasicTransformerBlock(dim, heads, head_dim).eval()
    blk.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
