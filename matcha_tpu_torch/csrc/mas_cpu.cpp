// Monotonic Alignment Search — C++/OpenMP CPU reference of the port.
//
// A copy of the JAX package's `matcha_tpu/ops/mas_cpp/mas.cpp`: a batched
// banded Viterbi DP, parallelized over utterances with OpenMP, which plays the
// role of the reference's Cython kernel (matcha/utils/monotonic_align/core.pyx).
// The port uses it as a host reference in tests and in `cli/bench_mas.py`,
// which times the CUDA kernel `mas.cu` against it; no training route runs it.
//
// Built by `matcha_tpu_torch/ops/_build.py` at first use:
// g++ -O3 -march=native -fopenmp -shared -fPIC, into build/matcha_tpu_torch/.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr float kNeg = -1e9f;

// DP + backtrack for a single utterance.
// score: row-major [tx_max, ty_max] (only the [tx, ty] prefix is used)
// path:  row-major [tx_max, ty_max] output, 0/1
void align_one(const float* score, int32_t* path, int tx, int ty, int ty_max) {
  if (tx <= 0 || ty <= 0) return;
  std::vector<float> dp_prev(tx, kNeg), dp_cur(tx, kNeg);
  std::vector<uint8_t> take_diag(static_cast<size_t>(tx) * ty, 0);

  for (int y = 0; y < ty; ++y) {
    const int x_min = tx + y - ty > 0 ? tx + y - ty : 0;
    const int x_max = y + 1 < tx ? y + 1 : tx;
    for (int x = 0; x < tx; ++x) dp_cur[x] = kNeg;
    for (int x = x_min; x < x_max; ++x) {
      float from_prev;
      if (x == 0) {
        from_prev = (y == 0) ? 0.0f : kNeg;
      } else {
        from_prev = dp_prev[x - 1];
      }
      const float from_same = (x == y || y == 0) ? kNeg : dp_prev[x];
      const bool diag = (from_prev >= from_same) || (x == y);
      take_diag[static_cast<size_t>(x) * ty + y] = diag ? 1 : 0;
      dp_cur[x] = (diag ? from_prev : from_same) + score[static_cast<size_t>(x) * ty_max + y];
    }
    dp_prev.swap(dp_cur);
  }

  int idx = tx - 1;
  for (int y = ty - 1; y >= 0; --y) {
    path[static_cast<size_t>(idx) * ty_max + y] = 1;
    if (y == 0) break;
    if (idx > 0 && (idx == y || take_diag[static_cast<size_t>(idx) * ty + y])) {
      --idx;
    }
  }
}

}  // namespace

extern "C" {

// Batched MAS. Arrays are contiguous row-major.
//   score:  [b, tx_max, ty_max] float32
//   path:   [b, tx_max, ty_max] int32 (must be zero-initialized by the caller)
//   t_x:    [b] int32 text lengths
//   t_y:    [b] int32 mel lengths
void mas_batch(const float* score, int32_t* path, const int32_t* t_x,
               const int32_t* t_y, int b, int tx_max, int ty_max) {
  const size_t stride = static_cast<size_t>(tx_max) * ty_max;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < b; ++i) {
    align_one(score + i * stride, path + i * stride, t_x[i], t_y[i], ty_max);
  }
}

}  // extern "C"
