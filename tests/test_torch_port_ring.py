"""Ring attention and sequence-parallel decode of the port against the JAX
package (CPU, gloo ranks; the JAX side on the virtual CPU devices).

- `ring_attention` at 4 ranks (`make_ring_self_attention`, and inside the
  decoder's `DiffusersAttention`) against JAX's `make_ring_self_attention` on
  4 devices and `ring_attention_reference`, and the 1-rank degenerate case:
  atol 2e-5, rtol 1e-5 (`tests/test_ring_attention.py:29-44`).
- `decode_fixed(seq_axis=...)` at 2 ranks (the U-Net's frames split, halo
  frames exchanged, GroupNorm statistics summed, ring attention) against the
  port's and the JAX package's `decode_fixed` unsharded, z injected: 1e-5
  (`tests/test_ring_attention.py:48-91`); at 1 rank, and a budget that does
  not split, refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh

from matcha_tpu.models.matcha import MatchaConfig as JaxConfig
from matcha_tpu.models.matcha import MatchaTTS as JaxMatcha
from matcha_tpu.models.matcha import init_params
from matcha_tpu.nn.decoder import DecoderConfig as JaxDecoderConfig
from matcha_tpu.nn.encoder import EncoderConfig as JaxEncoderConfig
from matcha_tpu.nn.transformer import DiffusersAttention as JaxAttention
from matcha_tpu.parallel.ring_attention import (
    make_ring_self_attention as jax_make_ring,
)
from matcha_tpu.parallel.ring_attention import (
    ring_attention_reference as jax_ring_reference,
)
from matcha_tpu_torch.compat.jax_params import matcha_state_dict_from_jax
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
from matcha_tpu_torch.nn.decoder import DecoderConfig
from matcha_tpu_torch.nn.encoder import EncoderConfig
from matcha_tpu_torch.parallel import Mesh
from matcha_tpu_torch.parallel.ring_attention import (
    make_ring_self_attention,
    ring_attention_reference,
)
from tests.torch_ranks import free_port, rank_env, run_ranks

TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world_one(monkeypatch):
    """This process as the one rank of a gloo group, torn down after the test."""
    env = rank_env(0, 1, free_port())
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.setenv(k, env[k])
    dist.init_process_group("gloo", init_method="env://")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _qkvb(b=2, h=4, t=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    lengths = rng.integers(t // 2, t + 1, size=b)
    bias = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return q, k, v, bias


def _attention_weights(seed=2):
    """A JAX DiffusersAttention(dim 32, 2 heads of 16) and its port state dict."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    bias = (np.arange(64)[None, :] < np.array([64, 40])[:, None]).astype(np.float32)
    attn = JaxAttention(dim=32, heads=2, dim_head=16)
    params = jax.tree.map(np.asarray, attn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                jnp.asarray(bias), deterministic=True)["params"])
    sd = {f"{n}.weight": params[n]["kernel"].T for n in ("to_q", "to_k", "to_v")}
    sd["to_out.0.weight"] = params["to_out"]["kernel"].T
    sd["to_out.0.bias"] = params["to_out"]["bias"]
    return attn, params, x, bias, {k: np.ascontiguousarray(v) for k, v in sd.items()}


_RING = """
def body(inputs, rank):
    from matcha_tpu_torch.nn.transformer import DiffusersAttention
    from matcha_tpu_torch.parallel.ring_attention import make_ring_self_attention

    g = dist.group.WORLD
    t = lambda n: torch.from_numpy(inputs[n])
    out = {"ring": make_ring_self_attention(g)(t("q"), t("k"), t("v"), t("bias"))}
    attn = DiffusersAttention(32, 2, 16)
    attn.load_state_dict({k[3:]: t(k) for k in inputs if k.startswith("sd/")})
    tl = 64 // 4
    x, bias = t("x")[:, rank * tl:(rank + 1) * tl], t("xbias")[:, rank * tl:(rank + 1) * tl]
    with torch.no_grad():
        y = attn(x.contiguous(), bias.contiguous(), seq=g)
    parts = [torch.empty_like(y) for _ in range(4)]
    dist.all_gather(parts, y, group=g)
    out["attn"] = torch.cat(parts, dim=1)
    return {k: v.numpy() for k, v in out.items()}
"""


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    q, k, v, bias = _qkvb()
    _, _, x, xbias, sd = _attention_weights()
    inputs = dict(q=q, k=k, v=v, bias=bias, x=x, xbias=xbias)
    inputs.update({f"sd/{n}": a for n, a in sd.items()})
    return run_ranks(_RING, 4, inputs, tmp_path_factory.mktemp("ring"))


def test_ring_attention_four_ranks_matches_jax_ring_and_reference(ring_run):
    q, k, v, bias = (jnp.asarray(a) for a in _qkvb())
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("seq",))
    jax_ring = np.asarray(jax_make_ring(mesh, "seq")(q, k, v, bias))
    jax_ref = np.asarray(jax_ring_reference(q, k, v, bias))
    port_ref = ring_attention_reference(*(torch.from_numpy(np.array(a))
                                          for a in (q, k, v, bias))).numpy()
    np.testing.assert_allclose(port_ref, jax_ref, **TOL)
    for out in ring_run:  # every rank holds the gathered output
        np.testing.assert_allclose(out["ring"], jax_ring, **TOL)
        np.testing.assert_allclose(out["ring"], jax_ref, **TOL)


def test_ring_inside_decoder_attention_matches_dense(ring_run):
    attn, params, x, bias, _ = _attention_weights()
    dense = np.asarray(jax.jit(lambda p, x, b: attn.apply({"params": p}, x, b,
                                                          deterministic=True))(params, x, bias))
    for out in ring_run:
        np.testing.assert_allclose(out["attn"], dense, **TOL)


def test_ring_attention_one_rank_degenerate(world_one):
    q, k, v, bias = _qkvb(t=32, seed=1)
    out = make_ring_self_attention(world_one)(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    ref = np.asarray(jax_ring_reference(*(jnp.asarray(a) for a in (q, k, v, bias))))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


# -------------------------------------------------- sequence-parallel decode
B, TX, TY, STEPS = 2, 16, 64, 2


def _configs():
    enc = dict(n_feats=16, n_channels=32, filter_channels=64, n_layers=1, filter_channels_dp=32)
    dec = dict(in_channels=32, out_channels=16, channels=(32, 32), attention_head_dim=16,
               num_heads=2, num_mid_blocks=1)
    return (JaxConfig(n_feats=16, encoder=JaxEncoderConfig(**enc),
                      decoder=JaxDecoderConfig(**dec)),
            MatchaConfig(n_feats=16, encoder=EncoderConfig(**enc), decoder=DecoderConfig(**dec)))


@pytest.fixture(scope="module")
def decode_setup():
    jcfg, pcfg = _configs()
    params = init_params(JaxMatcha(jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.integers(3, 140, size=(B, TX)).astype(np.int64)
    xl = np.array([TX, 11], np.int64)
    z = rng.standard_normal((B, TY, 16)).astype(np.float32)
    sd = {k: v.numpy() for k, v in matcha_state_dict_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    model = MatchaTTS(pcfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jcfg, params, model, sd, x, xl, z


def _port_decode(model, x, xl, z, seq_axis=None, y_max=TY):
    mu_x, w_ceil, x_mask, y_len = model.encode_durations(torch.from_numpy(x), torch.from_numpy(xl))
    return model.decode_fixed(mu_x, w_ceil, x_mask, y_len, y_max, STEPS, z=torch.from_numpy(z),
                              seq_axis=seq_axis)["mel"].numpy()


_DECODE = """
def body(inputs, rank):
    from torch.distributed.device_mesh import init_device_mesh
    from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
    from matcha_tpu_torch.nn.decoder import DecoderConfig
    from matcha_tpu_torch.nn.encoder import EncoderConfig
    from matcha_tpu_torch.parallel import Mesh

    enc = dict(n_feats=16, n_channels=32, filter_channels=64, n_layers=1, filter_channels_dp=32)
    dec = dict(in_channels=32, out_channels=16, channels=(32, 32), attention_head_dim=16,
               num_heads=2, num_mid_blocks=1)
    model = MatchaTTS(MatchaConfig(n_feats=16, encoder=EncoderConfig(**enc),
                                   decoder=DecoderConfig(**dec))).eval()
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in inputs.items()
                           if k.startswith("sd/")})
    t = lambda n: torch.from_numpy(inputs[n])
    mu_x, w_ceil, x_mask, y_len = model.encode_durations(t("x"), t("xl"))
    out = {}
    with Mesh(init_device_mesh("cpu", (2,), mesh_dim_names=("seq",))):
        out["mel"] = model.decode_fixed(mu_x, w_ceil, x_mask, y_len, 64, 2, z=t("z"),
                                        seq_axis="seq")["mel"]
        try:  # 62 frames do not split into 2 ranks x the U-Net's factor 2
            model.decode_fixed(mu_x, w_ceil, x_mask, y_len, 62, 2, seq_axis="seq")
            out["refused"] = torch.tensor(False)
        except ValueError:
            out["refused"] = torch.tensor(True)
    return {k: v.numpy() for k, v in out.items()}
"""


def test_seq_parallel_decode_two_ranks_matches_unsharded(decode_setup, tmp_path):
    jcfg, params, model, sd, x, xl, z = decode_setup
    inputs = dict(x=x, xl=xl, z=z, **{f"sd/{k}": v for k, v in sd.items()})
    outs = run_ranks(_DECODE, 2, inputs, tmp_path)
    with torch.no_grad():
        port = _port_decode(model, x, xl, z)
    jax_mel = np.asarray(JaxMatcha(jcfg).apply(
        {"params": params}, jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32), TY, STEPS,
        z=jnp.asarray(z), method=JaxMatcha.synthesise_fixed)["mel"])
    np.testing.assert_allclose(port, jax_mel, atol=1e-5, rtol=1e-5)
    for out in outs:  # every rank returns the whole mel
        assert out["refused"]
        np.testing.assert_allclose(out["mel"], port, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out["mel"], jax_mel, atol=1e-5, rtol=1e-5)


def test_seq_parallel_decode_one_rank(decode_setup, world_one):
    _, _, model, _, x, xl, z = decode_setup
    from torch.distributed.device_mesh import init_device_mesh

    with torch.no_grad():
        port = _port_decode(model, x, xl, z)
        with Mesh(init_device_mesh("cpu", (1,), mesh_dim_names=("seq",))):
            seq = _port_decode(model, x, xl, z, seq_axis="seq")
    np.testing.assert_allclose(seq, port, atol=1e-5, rtol=1e-5)
