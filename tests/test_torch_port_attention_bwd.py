"""K4's plain version (`attention_bwd_plain`) and autograd through `attention` (CPU).

The plain backward takes the forward's output o and row log-sum-exp lse, as
K4 does; here it is fed the plain forward's. The JAX side is the TPU kernel's
backward `_fused_attention_bwd`, run in interpret mode, which recomputes the
softmax. Bars are those of tests/test_attention_pallas.py: after dividing by
max |grad|, 1e-4 in float32 and 6e-2 in bf16; dbias 1e-4. The CUDA kernel is
held against `attention_bwd_plain` on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.ops.attention_pallas import _fused_attention_bwd
from matcha_tpu_torch.ops.attention import (
    attention,
    attention_backward,
    attention_bwd_plain,
    attention_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, h, t, d, ragged=True):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    lengths = np.array([t, max(1, t - 37)][:b]) if ragged else np.full(b, t)
    bias = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return q, k, v, do, bias


def _assert_grads(got, want, tol, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        ref = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g / ref, w / ref, atol=tol, err_msg=f"{what} {name}")


def _plain_bwd(q, k, v, bias, do, scale):
    """attention_bwd_plain fed the plain forward's (o, lse)."""
    o, lse = attention_plain(q, k, v, bias, scale, with_lse=True)
    return attention_bwd_plain(q, k, v, bias, do, o, lse, scale)


@pytest.mark.parametrize("t", [64, 256])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 6e-2)])
def test_bwd_plain_matches_pallas_bwd(dtype, tol, t):
    b, h, d, scale = 2, 3, 64, 0.125
    q, k, v, do, bias = _inputs(t, b, h, t, d)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    want = _fused_attention_bwd(jq, jk, jv, jnp.asarray(bias, jdt)[:, None, :], jdo,
                                scale, True)
    tdt = getattr(torch, dtype)
    got = _plain_bwd(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                     torch.from_numpy(bias).to(tdt), torch.from_numpy(do).to(tdt), scale)
    assert all(g.dtype == tdt for g in got[:3]) and got[3].dtype == torch.float32
    _assert_grads([g.float().numpy() for g in got[:3]], want[:3], tol, dtype)
    dbias_want = np.asarray(want[3], np.float32)[:, 0, :]
    ref = max(np.abs(dbias_want).max(), 1.0)
    np.testing.assert_allclose(got[3].numpy() / ref, dbias_want / ref, atol=1e-4 if
                               dtype == "float32" else tol)


def test_bwd_plain_dbias_of_a_real_valued_bias():
    """The additive-bias cotangent, for a bias that is no 0/1 mask (1e-4)."""
    b, h, t, d = 2, 2, 64, 64
    q, k, v, do, _ = _inputs(4, b, h, t, d)
    bias = np.random.default_rng(9).standard_normal((b, t)).astype(np.float32)
    want = _fused_attention_bwd(*(jnp.asarray(a) for a in (q, k, v)),
                                jnp.asarray(bias)[:, None, :], jnp.asarray(do), 0.125, True)
    got = _plain_bwd(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(bias),
                     torch.from_numpy(do), 0.125)
    _assert_grads([g.numpy() for g in got[:3]], want[:3], 1e-4, "real-valued bias")
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3])[:, 0, :],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 6e-2)])
def test_bwd_plain_of_a_row_strided_mask_view_matches_pallas_bwd(dtype, tol):
    """The decoder's truncated mask, a (B, T) view with row stride 2T, as the
    bias: the plain backward reads it in place and matches the TPU kernel's."""
    b, h, t, d = 2, 2, 64, 64
    q, k, v, do, _ = _inputs(5, b, h, t, d)
    full = (np.arange(2 * t)[None, :] < np.array([2 * t, t - 20])[:, None]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _fused_attention_bwd(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                jnp.asarray(full[:, :t], jdt)[:, None, :],
                                jnp.asarray(do, jdt), 0.125, True)
    bias = torch.from_numpy(full).to(tdt)[:, :t]
    assert bias.stride() == (2 * t, 1)
    got = _plain_bwd(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), bias,
                     torch.from_numpy(do).to(tdt), 0.125)
    _assert_grads([g.float().numpy() for g in got[:3]], want[:3], tol, dtype)
    dbias_want = np.asarray(want[3], np.float32)[:, 0, :]
    ref = max(np.abs(dbias_want).max(), 1.0)
    np.testing.assert_allclose(got[3].numpy() / ref, dbias_want / ref,
                               atol=1e-4 if dtype == "float32" else tol)


@pytest.mark.parametrize("with_bias", [True, False])
def test_autograd_through_attention_equals_bwd_plain(with_bias):
    """`attention` on CPU tensors is differentiable in q, k, v and the bias,
    and its gradients are exactly `attention_bwd_plain`'s."""
    b, h, t, d, scale = 2, 2, 40, 16, 0.25
    q, k, v, do, bias = (torch.from_numpy(a) for a in _inputs(1, b, h, t, d))
    bias = bias.clone() if with_bias else None
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    if with_bias:
        bias.requires_grad_()
    out = attention(*leaves, bias, scale)
    torch.testing.assert_close(out, attention_plain(q, k, v, bias, scale), rtol=0, atol=0)
    out.backward(do)
    want = _plain_bwd(q, k, v, None if bias is None else bias.detach(), do, scale)
    for leaf, w in zip(leaves, want[:3]):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    if with_bias:
        torch.testing.assert_close(bias.grad, want[3], rtol=0, atol=0)


def test_autograd_through_a_row_strided_mask_view():
    """The decoder passes a truncated (B, T) view of its mask as the bias; the
    mask needs no gradient, and the q, k, v gradients are unchanged by it."""
    b, h, t, d = 2, 2, 24, 16
    q, k, v, do, _ = (torch.from_numpy(a) for a in _inputs(2, b, h, t, d))
    full = (torch.arange(48)[None, :] < torch.tensor([48, 30])[:, None]).float()[:, None, :]
    bias = full[:, 0, :t]
    assert bias.stride() == (48, 1)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    attention(*leaves, bias, 0.25).backward(do)
    want = _plain_bwd(q, k, v, bias, do, 0.25)
    for leaf, w in zip(leaves, want[:3]):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_autograd_saves_output_and_lse():
    """`attention` saves q, k, v, the bias, its output o and the row
    log-sum-exp, and its backward reads those (no softmax recomputed)."""
    b, h, t, d, scale = 2, 2, 40, 16, 0.25
    q, k, v, do, bias = (torch.from_numpy(a) for a in _inputs(3, b, h, t, d))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = attention(*leaves, bias, scale)
    saved = out.grad_fn.saved_tensors
    o, lse = attention_plain(q, k, v, bias, scale, with_lse=True)
    assert len(saved) == 6
    for got, want in zip(saved, (q, k, v, bias, o, lse)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    out.backward(do)
    want = attention_bwd_plain(q, k, v, bias, do, o, lse, scale)
    for leaf, w in zip(leaves, want[:3]):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_backward_dispatch_takes_plain_path_on_cpu():
    q = torch.randn(1, 2, 8, 64)
    o, lse = attention_plain(q, q, q, None, 0.125, with_lse=True)
    before = attention_backward.launches
    got = attention_backward(q, q, q, None, q, o, lse, 0.125, need_dbias=False)
    assert got[3] is None
    want = attention_bwd_plain(q, q, q, None, q, o, lse, 0.125)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert attention_backward.launches == before
