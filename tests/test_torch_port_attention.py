"""K1's plain version and the port's decoder transformer block against JAX (CPU).

The JAX side is the Pallas kernel `fused_attention`, run in interpret mode (its
default off the TPU). Bars are those of tests/test_attention_pallas.py: f32
atol/rtol 1e-5, bf16 2e-2. The CUDA kernel itself is held against
`attention_plain` on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.attention_pallas import fused_attention
from matcha_tpu_torch.compat import jax_params
from matcha_tpu_torch.nn.transformer import BasicTransformerBlock
from matcha_tpu_torch.ops.attention import attention, attention_plain


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
