// Monotonic alignment search for Hopper (sm_90a): K3a (forward DP) and K3b (backtrack).
//
// Replaces the Pallas kernels matcha_tpu/ops/mas_pallas.py::_forward_kernel and
// ::_backward_kernel. The DP is the reference's banded Viterbi recursion over
// mel frames y (matcha_tpu/ops/mas_ref.py):
//   from_prev = x == 0 ? (y == 0 ? 0 : NEG) : dp[x-1]
//   from_same = (x == y || y == 0) ? NEG : dp[x]
//   take      = from_prev >= from_same || x == y
//   dp[x]     = in_band(x, y) ? (take ? from_prev : from_same) + score[y][x] : NEG
// with NEG = -1e9 and every value f32, so the path is bit-equal to the
// reference's. The one addition is written __fadd_rn: nothing may fuse it.
//
// Bound: neither bytes nor operations. K3a reads t_y * Tx scores and writes
// t_y * ceil(Tx/32) words per utterance, but every frame depends on the one
// before, so an utterance is a chain of t_y steps. The TPU kernel runs the
// chain over (B, Tx) vector rows, all utterances in lock step, with the DP row
// in VMEM. Here each utterance is one block and the chain is its loop:
//
// K3a: one thread per text position (Tx <= 1024, so at most 32 warps), the DP
// cell in a register. dp[x-1] comes by warp shuffle inside a warp; each warp's
// last cell crosses to the next warp through shared memory, double-buffered by
// frame parity, so a frame costs one barrier. The scores of the next frame are
// loaded while this one is computed. The take-diagonal decisions leave as one
// __ballot_sync word per warp and frame: (B, Ty, ceil(Tx/32)) words, 32x fewer
// bytes than the TPU's f32 rows. Frames at or past t_y are not visited.
//
// K3b: the walk back is one index per utterance, inherently serial. The block
// stages its utterance's words in shared memory (Ty * ceil(Tx/32) words: 32 KB
// at Ty = 1024, Tx = 256), one thread walks the index back from t_x - 1 and
// records it per frame, then all threads write the (Tx, Ty) 0/1 path rows,
// coalesced along frames.

#include "common.cuh"

namespace {

constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BACKTRACK_THREADS = 256;

__global__ void mas_forward_kernel(const float* __restrict__ score, const int* __restrict__ t_x,
                                   const int* __restrict__ t_y, uint32_t* __restrict__ words,
                                   int Ty, int Tx, int W) {
  __shared__ float edge[2][32];  // each warp's last DP cell, by frame parity
  const int b = blockIdx.x, x = threadIdx.x, lane = x & 31, warp = x >> 5;
  const int tx = t_x[b], ty = t_y[b];
  const int ny = min(ty, Ty);
  const float* s = score + (size_t)b * Ty * Tx;
  uint32_t* out = words + (size_t)b * Ty * W;

  float dp = NEG;
  float s_next = (x < Tx && ny > 0) ? s[x] : 0.f;
  for (int y = 0; y < ny; ++y) {
    const float sc = s_next;
    if (y + 1 < ny && x < Tx) s_next = s[(size_t)(y + 1) * Tx + x];

    float left = __shfl_up_sync(FULL, dp, 1);  // dp[x-1] of the previous frame
    if (lane == 0) left = (y > 0 && warp > 0) ? edge[y & 1][warp - 1] : NEG;
    const float from_prev = x == 0 ? (y == 0 ? 0.f : NEG) : left;
    const float from_same = (x == y || y == 0) ? NEG : dp;
    const bool take = from_prev >= from_same || x == y;
    const float best = take ? from_prev : from_same;
    const bool in_band = x >= max(0, tx + y - ty) && x < min(tx, y + 1);

    const unsigned word = __ballot_sync(FULL, take);
    if (lane == 0) out[(size_t)y * W + warp] = word;
    dp = in_band ? __fadd_rn(best, sc) : NEG;
    if (lane == 31) edge[(y + 1) & 1][warp] = dp;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(BACKTRACK_THREADS)
mas_backtrack_kernel(const uint32_t* __restrict__ words, const int* __restrict__ t_x,
                     const int* __restrict__ t_y, float* __restrict__ path, int Ty, int Tx,
                     int W) {
  extern __shared__ uint32_t smem[];  // Ty * W words, then the Ty path indices
  uint32_t* sw = smem;
  int* sidx = reinterpret_cast<int*>(smem + (size_t)Ty * W);
  const int b = blockIdx.x;
  const int tx = t_x[b], ty = t_y[b];
  const int ny = min(ty, Ty);
  const uint32_t* in = words + (size_t)b * Ty * W;

  for (int i = threadIdx.x; i < ny * W; i += blockDim.x) sw[i] = in[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int idx = tx - 1;
    for (int y = Ty - 1; y >= 0; --y) {
      const bool active = y < ty;
      sidx[y] = active ? idx : -1;
      const bool td = active && idx >= 0 && idx < Tx &&
                      ((sw[(size_t)y * W + (idx >> 5)] >> (idx & 31)) & 1u);
      if (active && y > 0 && idx > 0 && (idx == y || td)) --idx;
    }
  }
  __syncthreads();
  float* p = path + (size_t)b * Tx * Ty;
  for (int x = 0; x < Tx; ++x)
    for (int y = threadIdx.x; y < Ty; y += blockDim.x)
      p[(size_t)x * Ty + y] = sidx[y] == x ? 1.f : 0.f;
}

}  // namespace

// score: (B, Ty, Tx) f32 contiguous; t_x, t_y: (B,) int32; words: (B, Ty,
// ceil(Tx/32)) 32-bit words, bit i of word w = text position 32w + i, frames
// y >= t_y left unwritten. Tx <= 1024. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int mas_forward(const void* score, const void* t_x, const void* t_y, void* words,
                           int B, int Ty, int Tx, void* stream) {
  if (B <= 0 || Ty <= 0 || Tx <= 0 || Tx > 1024) return (int)cudaErrorInvalidValue;
  const int W = (Tx + 31) / 32;
  mas_forward_kernel<<<B, W * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(score), static_cast<const int*>(t_x),
      static_cast<const int*>(t_y), static_cast<uint32_t*>(words), Ty, Tx, W);
  return (int)cudaGetLastError();
}

// words: mas_forward's output; path: (B, Tx, Ty) f32, every element written.
extern "C" int mas_backtrack(const void* words, const void* t_x, const void* t_y, void* path,
                             int B, int Ty, int Tx, void* stream) {
  if (B <= 0 || Ty <= 0 || Tx <= 0 || Tx > 1024) return (int)cudaErrorInvalidValue;
  const int W = (Tx + 31) / 32;
  const size_t smem = ((size_t)Ty * W + Ty) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mas_backtrack_kernel<<<B, BACKTRACK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(t_x),
      static_cast<const int*>(t_y), static_cast<float*>(path), Ty, Tx, W);
  return (int)cudaGetLastError();
}
