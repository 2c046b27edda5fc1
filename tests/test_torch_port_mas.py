"""MAS in the port (`ops/mas.py`) against the JAX package's three MAS (CPU).

`maximum_path_plain`'s path must be bit-equal to `maximum_path_ref` (lax.scan),
`maximum_path_pallas` (the TPU kernels in interpret mode) and the C++
reference `maximum_path_cpp`, at the shapes of tests/test_mas.py, and follow
PyTorch's promotion for bf16 inputs and masks with holes. The port's own copy
of the C++ MAS (`ops/mas_cpp.py`) is bit-equal to the JAX package's. The fused CUDA
kernel (K3a and K3b in one launch) is held bit-equal to the plain version on
the card by chip_smoke.py; its shared-memory plan `mas_plan` is checked here.
"""

import numpy as np
import pytest
import torch

from matcha_tpu.ops import maximum_path_pallas, maximum_path_ref
from matcha_tpu.ops.mas_cpp import mas_batch_cpp, maximum_path_cpp
from matcha_tpu_torch.ops import _build, mas
from matcha_tpu_torch.ops import mas_cpp as port_cpp
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


@pytest.mark.parametrize("b,tx,ty", [(4, 17, 40), (8, 50, 200), (3, 1, 5), (2, 13, 13),
                                     (16, 100, 500)])
def test_port_cpp_bit_equal_to_jax_cpp_and_plain(b, tx, ty):
    """The port's copy of the C++ MAS (`csrc/mas_cpu.cpp`, built into the
    port's build directory) against the JAX package's and the plain version."""
    rng = np.random.default_rng(b * 31 + ty)
    value, mask, t_x, t_y = _random_problem(rng, b, tx, ty)
    got = port_cpp.maximum_path_cpp(value, mask)
    assert got.dtype == np.float32
    _check_path_valid(got, t_x, t_y)
    np.testing.assert_array_equal(got, maximum_path_cpp(value, mask))
    np.testing.assert_array_equal(got, _port(value, mask))
    raw = port_cpp.mas_batch_cpp(value * mask, t_x, t_y)
    assert raw.dtype == np.int32
    np.testing.assert_array_equal(raw, mas_batch_cpp(value * mask, t_x, t_y))
    lib = _build._lib_path("mas_cpu")
    assert lib.parent == _build.BUILD_DIR and lib.exists()


def test_port_cpp_refuses_lengths_past_the_scores():
    value = np.zeros((2, 4, 6), np.float32)
    with pytest.raises(ValueError, match="lengths past"):
        port_cpp.mas_batch_cpp(value, np.array([4, 5]), np.array([6, 6]))
    with pytest.raises(ValueError, match="for a batch of 2"):
        port_cpp.mas_batch_cpp(value, np.array([4]), np.array([6]))


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
    before = mas.mas_cuda.launches
    rng = np.random.default_rng(2)
    _port(*_random_problem(rng, 2, 5, 9)[:2])
    assert mas.mas_cuda.launches == before


def _holed_problem(seed, b=4, tx=23, ty=61, fraction=False):
    """Scores, explicit lengths, and a mask that is not an outer product of
    them: random holes inside the lengths (and, with `fraction`, some cells
    at 0.3, so that a bf16 product rounds)."""
    rng = np.random.default_rng(seed)
    value, mask, t_x, t_y = _random_problem(rng, b, tx, ty)
    value = (-400.0 + 60.0 * value).astype(np.float32)
    mask = mask * (rng.random(mask.shape) > 0.15)
    if fraction:
        mask = np.where(rng.random(mask.shape) < 0.2, 0.3 * mask, mask)
    return value, mask.astype(np.float32), t_x.astype(np.int32), t_y.astype(np.int32)


def test_mask_with_holes_and_explicit_lengths():
    """The lengths come from the caller, not the mask; the result is the
    path times the mask, as the C++ reference gives it on the same product."""
    value, mask, t_x, t_y = _holed_problem(11)
    got = _port(value, mask, t_x, t_y)
    path = mas_batch_cpp(value * mask, t_x, t_y).astype(np.float32)
    np.testing.assert_array_equal(got, path * mask)
    assert (got != 0).sum() < (path != 0).sum()  # holes on the path are zero


@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bfloat16])
def test_bf16_value_follows_pytorch_promotion(mask_dtype):
    """bf16 value with an f32 mask scores in f32, with a bf16 mask rounds the
    product to bf16 first; either way the output is bf16, the mask's value
    (rounded to bf16) on the path."""
    value, mask, t_x, t_y = _holed_problem(13, fraction=True)
    v = torch.from_numpy(value).bfloat16()
    m = torch.from_numpy(mask).to(mask_dtype)
    got = mas.maximum_path(v, m, torch.from_numpy(t_x), torch.from_numpy(t_y))
    assert got.dtype == torch.bfloat16
    if mask_dtype == torch.bfloat16:
        score = (v.float() * m.float()).bfloat16().float().numpy()
    else:
        score = v.float().numpy() * mask
    assert not np.array_equal(score, v.float().numpy() * m.float().numpy()) \
        or mask_dtype == torch.float32  # the bf16 product does round here
    path = mas_batch_cpp(score, t_x, t_y).astype(np.float32)
    want = torch.from_numpy(path) * m.float()
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("tx", [1, 45, 64, 256, 1024])
@pytest.mark.parametrize("ty", [1, 45, 448, 1024])
def test_mas_plan_covers_and_fits(tx, ty):
    plan = mas.mas_plan(tx, ty)
    assert plan.cells == mas.mas_cells(tx) and 32 * plan.cells >= tx
    assert plan.cells == 1 or 16 * plan.cells < tx  # the least power of two
    assert plan.frames % 4 == 0 and plan.frames >= 4 and 2 <= plan.stages <= 4
    assert -(-ty // plan.frames) * plan.frames >= ty  # the chunks cover every frame
    # ring (a spare row a stage), two mbarriers a stage, the decisions, the path index
    ring = plan.stages * (plan.frames + 1) * 32 * plan.cells * 4
    assert plan.smem == ring + 16 * plan.stages + ty * plan.cells * 4 + ty * 4
    assert plan.smem <= mas.SMEM_LIMIT
    # a producer thread loads a chunk's (row, 4 frames) items in one batch
    assert 32 * plan.cells * plan.frames // 4 <= 10 * 224


def test_mas_plan_raises_past_shared_memory_and_text_cap():
    assert mas.mas_plan(1024, 1400).frames == 4  # fewer frames a chunk before it gives up
    with pytest.raises(ValueError, match="shared memory"):
        mas.mas_plan(1024, 1500)
    with pytest.raises(ValueError, match="shared memory"):
        mas.mas_plan(64, 30000)
    with pytest.raises(ValueError, match="text positions"):
        mas.mas_plan(1025, 64)
