"""The decoder block's feed-forward variants against the JAX package (CPU).

Each `activation_fn` of `matcha_tpu.nn.transformer.BasicTransformerBlock`
("gelu", "gelu-approximate", "geglu", "snake", "snakebeta"), its attention
the Pallas kernel in interpret mode, against the port's block on the same
weights, carried by `compat/jax_params.py`: f32 on both sides, one block,
within 1e-5 (the bar of tests/test_torch_port_attention.py's block test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.nn.transformer import BasicTransformerBlock as JaxBlock
from matcha_tpu_torch.compat import jax_params
from matcha_tpu_torch.nn.transformer import ACTIVATIONS, BasicTransformerBlock, FeedForward


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("activation_fn", ACTIVATIONS)
def test_block_variant_matches_jax(activation_fn):
    dim, heads, head_dim, b, t = 32, 2, 16, 2, 24
    jblk = JaxBlock(dim, heads, head_dim, activation_fn=activation_fn, attn_impl="pallas")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, t, dim)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([[t], [t - 9]])).astype(np.float32)
    shapes = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))["params"]

    def leaf(path, a):  # seeded: norms near 1, biases near 0, kernels fan-in scaled
        n = rng.standard_normal(a.shape).astype(np.float32)
        name = path[-1].key
        if name == "scale":
            return 1 + 0.05 * n
        if name in ("alpha", "beta"):  # log scale: alpha, beta near 1
            return 0.3 * n
        return 0.05 * n if name == "bias" else n / np.sqrt(a.shape[0])

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    want = jblk.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))

    sd = {}
    jax_params._transformer(sd, "blk", jax.tree.map(np.asarray, params))
    blk = BasicTransformerBlock(dim, heads, head_dim, activation_fn=activation_fn).eval()
    blk.load_state_dict({k[len("blk."):]: v for k, v in sd.items()})  # strict: every key
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_feed_forward_reference_names_and_final_dropout():
    """The reference's state-dict names per variant; `final_dropout` adds a
    dropout after the output projection, active in train() only."""
    names = {act: sorted(FeedForward(8, activation_fn=act).state_dict()) for act in ACTIVATIONS}
    plain = ["net.0.proj.bias", "net.0.proj.weight", "net.2.bias", "net.2.weight"]
    assert names["gelu"] == names["gelu-approximate"] == names["geglu"] == plain
    assert names["snake"] == names["snakebeta"] == sorted(plain + ["net.0.alpha", "net.0.beta"])
    assert FeedForward(8, activation_fn="geglu").net[0].proj.out_features == 2 * 4 * 8
    with pytest.raises(ValueError, match="activation_fn"):
        FeedForward(8, activation_fn="relu")

    torch.manual_seed(0)
    ff = FeedForward(8, dropout=0.5, final_dropout=True)
    x = torch.randn(2, 5, 8)
    keep = torch.ones(2, 5, 32)
    with torch.no_grad():
        base = ff.net[2](ff.net[0](x))
        assert torch.equal(ff.eval()(x), base)
        out = ff.train()(x, keep * 0.5)  # the hidden's mask given, the final one drawn
        zeros = out == 0
        assert zeros.any() and not zeros.all()
        torch.testing.assert_close(out[~zeros], 2 * base[~zeros])
