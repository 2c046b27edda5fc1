"""MAS in the port (`ops/mas.py`) against the JAX package's three MAS (CPU).

`maximum_path_plain`'s path must be bit-equal to `maximum_path_ref` (lax.scan),
`maximum_path_pallas` (the TPU kernels in interpret mode) and the C++
reference `maximum_path_cpp`, at the shapes of tests/test_mas.py. The CUDA
kernels K3a and K3b are held bit-equal to the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from matcha_tpu.ops import maximum_path_pallas, maximum_path_ref
from matcha_tpu.ops.mas_cpp import maximum_path_cpp
from matcha_tpu_torch.ops import mas
from tests.test_mas import _check_path_valid, _random_problem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(value, mask, t_x=None, t_y=None):
    as_t = (lambda a: None if a is None else torch.from_numpy(np.asarray(a)))
    got = mas.maximum_path_plain(as_t(value), as_t(mask), as_t(t_x), as_t(t_y))
    # the dispatcher takes the plain version for CPU tensors
    torch.testing.assert_close(mas.maximum_path(as_t(value), as_t(mask), as_t(t_x), as_t(t_y)),
                               got, rtol=0, atol=0)
    return got.numpy()


@pytest.mark.parametrize("b,tx,ty", [(4, 17, 40), (8, 50, 200), (3, 1, 5), (2, 13, 13),
                                     (16, 100, 500)])
def test_plain_bit_equal_to_ref_pallas_and_cpp(b, tx, ty):
    rng = np.random.default_rng(b * 1000 + tx)
    value, mask, t_x, t_y = _random_problem(rng, b, tx, ty)
    got = _port(value, mask)
    _check_path_valid(got, t_x, t_y)
    np.testing.assert_array_equal(got, np.asarray(maximum_path_ref(value, mask)))
    np.testing.assert_array_equal(got, maximum_path_cpp(value, mask))
    if tx > 1:  # Tx = 1 is covered by ref and cpp
        np.testing.assert_array_equal(got, np.asarray(maximum_path_pallas(value, mask)))


def test_equal_lengths_give_the_diagonal():
    b, t = 2, 9
    value = np.random.default_rng(1).standard_normal((b, t, t)).astype(np.float32)
    got = _port(value, np.ones((b, t, t), np.float32))
    np.testing.assert_array_equal(got, np.broadcast_to(np.eye(t, dtype=np.float32), (b, t, t)))


def test_explicit_lengths_match_mask_derived():
    rng = np.random.default_rng(3)
    b, tx, ty = 6, 24, 48
    t_x = rng.integers(8, tx + 1, size=b)
    t_y = np.maximum(rng.integers(ty // 2, ty + 1, size=b), t_x)
    mask = ((np.arange(tx)[None] < t_x[:, None])[:, :, None]
            * (np.arange(ty)[None] < t_y[:, None])[:, None, :]).astype(np.float32)
    value = rng.standard_normal((b, tx, ty)).astype(np.float32)
    derived = _port(value, mask)
    np.testing.assert_array_equal(derived, _port(value, mask, t_x.astype(np.int32),
                                                 t_y.astype(np.int32)))
    np.testing.assert_array_equal(derived, np.asarray(maximum_path_ref(value, mask)))
    lx, ly = mas.lengths_from_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(lx.numpy(), t_x)
    np.testing.assert_array_equal(ly.numpy(), t_y)


def test_log_prior_scale_scores_and_output_dtype():
    """Scores of the size a log-prior has (-1e3 .. -1e4), and a bf16 value:
    the DP runs in f32 whatever the dtype, the path comes back in value's."""
    rng = np.random.default_rng(7)
    value, mask, t_x, t_y = _random_problem(rng, 4, 30, 120)
    value = (-2000.0 + 300.0 * value).astype(np.float32)
    got = _port(value, mask)
    np.testing.assert_array_equal(got, maximum_path_cpp(value, mask))
    half = mas.maximum_path(torch.from_numpy(value).bfloat16(), torch.from_numpy(mask))
    assert half.dtype == torch.bfloat16
    want = maximum_path_cpp(torch.from_numpy(value).bfloat16().float().numpy(), mask)
    np.testing.assert_array_equal(half.float().numpy(), want)


def test_words_round_trip_and_plain_steps_compose():
    """K3a's word layout (bit i of word w = position 32w + i) round-trips, and
    the two plain steps give `maximum_path`'s path."""
    rng = np.random.default_rng(5)
    value, mask, t_x, t_y = _random_problem(rng, 3, 70, 90)
    score = torch.from_numpy(value * mask).transpose(1, 2).contiguous()
    tx, ty = torch.from_numpy(t_x).int(), torch.from_numpy(t_y).int()
    bits = mas.mas_forward_plain(score, tx, ty)
    words = mas.pack_words(bits)
    assert words.shape == (3, 90, 3) and words.dtype == torch.int32
    assert torch.equal(mas.unpack_words(words, 70), bits)
    path = mas.mas_backtrack_plain(bits, tx, ty)
    np.testing.assert_array_equal((path * torch.from_numpy(mask)).numpy(), _port(value, mask))


def test_cpu_path_counts_no_launch():
    before = (mas.mas_forward.launches, mas.mas_backtrack.launches)
    rng = np.random.default_rng(2)
    _port(*_random_problem(rng, 2, 5, 9)[:2])
    assert (mas.mas_forward.launches, mas.mas_backtrack.launches) == before
