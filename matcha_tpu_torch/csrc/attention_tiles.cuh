// Warp-level tile machinery shared by the attention kernels K1 (attention_fwd.cu)
// and K4 (attention_bwd.cu): one tiling and one pipeline for bf16 and f32.
//
// A block has 4 warps; a warp owns 16 rows of the block's 64-row tile. Every
// (64 rows, 64 d) tile of q, k, v, o or do is staged in shared memory as
// [row][d] with 16-byte cp.async copies, its 16-byte chunks XOR-swizzled by
// (row & 7). That one layout serves both operand roles without bank conflicts:
//   - "rows" products, X (16 x 64 d) times tile^T: s = q k^T, dp = do v^T;
//   - "cols" products, X (16 x 64 tile rows) times tile: p v, p^T do, ds^T q, ds k.
// bf16 reads its B fragments with ldmatrix.x4 (rows) and ldmatrix.x4.trans
// (cols) and multiplies with mma.sync m16n8k16. f32 reads 32-bit elements
// (conflict-free under the same swizzle) and multiplies with mma.sync m16n8k8
// in TF32 three times: x = big + small with big = tf32(x), small = tf32(x - big),
// and a b = big_a big_b + big_a small_b + small_a big_b in f32, which keeps
// about f32 accuracy (CUTLASS's OpMultiplyAddFastF32).
//
// Fragment layouts (lane = 4 g + t). m16n8k16 bf16: A rows g, g + 8, columns
// 2t, 2t + 1, 2t + 8, 2t + 9; B column g, rows 2t, 2t + 1, 2t + 8, 2t + 9.
// m16n8k8 tf32: A rows g, g + 8, columns t, t + 4; B column g, rows t, t + 4.
// C (both): rows g, g + 8, columns 2t, 2t + 1. A 16 x 64 result is float[8][4]:
// [n-tile of 8 columns][c0..c3]. In the tf32 "cols" product the C fragment is
// used as the A fragment directly by relabelling the 8 contraction indices of
// each k-step (A column t is tile row 2t, column t + 4 is row 2t + 1); the B
// fragment reads the same rows, so the sum is unchanged.
#pragma once

#include <type_traits>

#include "tensor_core.cuh"

namespace attn {

using namespace tc;

typedef __nv_bfloat16 bf16;
constexpr int DH = 64;                // head dim
constexpr int TILE = 64;              // rows of a tile
constexpr int WARPS = 4;              // 16 rows a warp
constexpr int THREADS = WARPS * 32;
constexpr int TILE_ELEMS = TILE * DH;
// Softmax in base 2: scores and biases are scaled by log2(e) once, so that
// each probability is one exp2 (the ex2 unit) after one FMA.
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Stages of the ring of streamed tiles: 3 in bf16, 2 in f32 (twice the bytes).
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 2 ? 3 : 2;
}

// Element offset of (r, c) in a swizzled [64][64] tile of T.
template <typename T>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int E = 16 / sizeof(T);
  return r * DH + (((c / E) ^ (r & 7)) * E) + (c % E);
}

// Rows [r0, r0 + 64) of a (n, 64) row-major matrix into `dst`, zero past n.
// Consecutive threads copy consecutive chunks of a row: coalesced reads.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int n) {
  constexpr int E = 16 / sizeof(T), CH = DH / E;
  for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * DH + ((c ^ (r & 7)) * E), src + (size_t)(ok ? r0 + r : 0) * DH + c * E,
               ok);
  }
}

// c += a b in f32 accuracy from three TF32 products (small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const float (&b)[2]) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b[0], bb0, bs0);
  split_tf32(b[1], bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
}

// c = X Y^T: X rows [a0, a0 + 16) of tile `a`, Y the 64 rows of tile `b`;
// c is 16 x 64 over b's rows. Contracts over d. F32_UNROLL: how far f32's
// 8 k-steps unroll. The backward kernels keep two such products live and pass
// 2: fully unrolled, ptxas gives the f32 dq kernel 255 registers and spills.
template <typename T, int F32_UNROLL = 8>
__device__ __forceinline__ void mm_rows(float (&c)[8][4], const T* a, int a0, const T* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  zero(c);
  if constexpr (std::is_same<T, bf16>::value) {
    const int m = lane >> 3, r8 = lane & 7;
    uint32_t af[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)  // matrices: rows 0-7 / 8-15 x d chunks 2kc, 2kc + 1
      ldsm_x4(af[kc], a + swz<T>(a0 + (m & 1) * 8 + r8, 16 * kc + 8 * (m >> 1)));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {  // matrices: d chunks 4kp .. 4kp + 3 of rows 8nt..
        uint32_t bf[4];
        ldsm_x4(bf, b + swz<T>(8 * nt + r8, 32 * kp + 8 * m));
        mma_bf16(c[nt], af[2 * kp], bf[0], bf[1]);
        mma_bf16(c[nt], af[2 * kp + 1], bf[2], bf[3]);
      }
    }
  } else {
#pragma unroll (F32_UNROLL)
    for (int kc = 0; kc < 8; ++kc) {
      uint32_t ab[4], as[4];
      split_tf32(a[swz<T>(a0 + g, 8 * kc + t)], ab[0], as[0]);
      split_tf32(a[swz<T>(a0 + g + 8, 8 * kc + t)], ab[1], as[1]);
      split_tf32(a[swz<T>(a0 + g, 8 * kc + t + 4)], ab[2], as[2]);
      split_tf32(a[swz<T>(a0 + g + 8, 8 * kc + t + 4)], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float bv[2] = {b[swz<T>(8 * nt + g, 8 * kc + t)],
                             b[swz<T>(8 * nt + g, 8 * kc + t + 4)]};
        mma_3xtf32(c[nt], ab, as, bv);
      }
    }
  }
}

// acc += X Y: X (16 x 64, C fragments) over the 64 rows of tile `b`, Y = b;
// acc is 16 x 64 over d. bf16 rounds X to bf16 as it enters the product.
template <typename T>
__device__ __forceinline__ void mm_cols(float (&acc)[8][4], const float (&x)[8][4], const T* b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
    const int m = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {  // tile rows 16kc .. 16kc + 15
      const uint32_t af[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                              pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                              pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                              pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // matrices: rows +0 / +8 x d chunks 2np, 2np + 1
        uint32_t bf[4];
        ldsm_x4_trans(bf, b + swz<T>(16 * kc + (m & 1) * 8 + r8, 16 * np + 8 * (m >> 1)));
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {  // tile rows 8kc .. 8kc + 7, relabelled (see top)
      uint32_t ab[4], as[4];
      split_tf32(x[kc][0], ab[0], as[0]);
      split_tf32(x[kc][2], ab[1], as[1]);
      split_tf32(x[kc][1], ab[2], as[2]);
      split_tf32(x[kc][3], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float bv[2] = {b[swz<T>(8 * kc + 2 * t, 8 * nt + g)],
                             b[swz<T>(8 * kc + 2 * t + 1, 8 * nt + g)]};
        mma_3xtf32(acc[nt], ab, as, bv);
      }
    }
  }
}

// Two neighbouring output elements from f32
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// log2(e) times the additive bias of key kj: the (B, T) bias row b in place,
// 0 without a bias, -inf past the sequence (those keys get p = 0). The bias is
// a row-strided view with no alignment promise, so it is read element by element.
template <typename T>
__device__ __forceinline__ float key_bias2(const T* bias, long long stride, int b, int kj,
                                           int n) {
  if (kj >= n) return -INFINITY;
  return bias ? to_f32(bias[b * stride + kj]) * LOG2E : 0.f;
}

inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace attn
