// Decoder self-attention backward, flash-style, for Hopper (sm_90a).
//
// Replaces the Pallas kernel matcha_tpu/ops/attention_pallas.py::_attn_bwd_kernel.
// With p = softmax(q k^T * scale + bias[b, None, :]) per (batch, head):
//   dv = p^T do            dp = do v^T          ds = p * (dp - rowsum(dp * p))
//   dq = scale * ds k      dk = scale * ds^T q  dbias = sum over queries of ds
// The TPU kernel recomputes the whole (T, T) softmax of a (batch, head) cell in
// VMEM (4 MB of f32 at T = 1024); an SM has 227 KB of shared memory, so this
// port never forms it. Three launches, each a grid of 64-row tiles x batch*head,
// each recomputing scores tile by tile:
//   1. stats: per query row the softmax max m, sum l and D = rowsum(dp * p)
//      (online over key tiles, with p in f32 as on the TPU) -> (3, B*H, T) f32;
//   2. dkdv: one block per 64-key tile walks the query tiles: dv, dk and the
//      per-head dbias of its keys;
//   3. dq: one block per 64-query tile walks the key tiles.
// Every output element has one writer, so there are no atomics and the
// gradients are deterministic. dbias leaves per head, (B*H, T) f32; the
// wrapper sums the heads, as the TPU wrapper does.
//
// Bound: 5 products of 2*T^2*D flops per cell (10*B*H*T^2*D) against
// 7*B*H*T*D elements moved, so operations; this design recomputes s and dp
// in each launch (9 products), trading 1.8x the flops for no (T, T) tensor.
//
// bf16 (mixed-precision training): every product on the tensor cores
// (mma.sync m16n8k16, f32 accumulators), 4 warps a block, 16 rows a warp.
// The rows a block owns stay in registers as A fragments; the other operand
// streams through shared memory as [row][d] tiles (B of q k^T, do v^T) and
// transposed [d][row] tiles (B of the products that contract over rows).
// p and ds are computed in f32 and rounded to bf16 only as A fragments of the
// next product, where the TPU kernel rounds them too; dbias sums ds in f32.
//
// f32 (parity runs): FMAs on the CUDA cores. 256 threads, each owning 4 x 4
// elements of a 64 x 64 tile (rows tr + 16i, columns tc + 16j), operands in
// shared memory with a row stride of 65 floats, so row and column walks both
// hit distinct banks; row reductions are xor-shuffles over the 16 lanes of a
// row. Tiles of 64 x 64 f32 need dynamic shared memory (67-101 KB a block).
//
// Rows past T: keys are zero with a -inf bias (p = 0), queries are zero with
// m = +inf (p = 0); nothing past T is written.

#include "common.cuh"

namespace {

constexpr int DH = 64;    // head dim
constexpr int TILE = 64;  // rows a block owns, rows a streamed tile holds

// ---------------------------------------------------------------- f32: CUDA cores
constexpr int FT = 256;  // threads
constexpr int FS = 65;   // row stride of an f32 tile in shared memory
constexpr int FTILE = TILE * FS;

__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int T) {
  for (int i = threadIdx.x; i < TILE * DH; i += FT) {
    const int r = i / DH, d = i % DH;
    dst[r * FS + d] = r0 + r < T ? src[(size_t)(r0 + r) * DH + d] : 0.f;
  }
}

// c[i][j] += sum_k A(tr + 16i, k) * B(k, tc + 16j), k < 64, with
// A(r, k) = A[r * ars + k * aks] and B(k, c) = B[k * bks + c * bcs].
__device__ __forceinline__ void mm(float (&c)[4][4], const float* A, int ars, int aks,
                                   const float* B, int bks, int bcs, int tr, int tc) {
#pragma unroll 4
  for (int k = 0; k < DH; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(tr + 16 * i) * ars + k * aks];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * bks + (tc + 16 * j) * bcs];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&c)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load_key_bias(float* bs, const float* bias, long long stride,
                                              int b, int k0, int T) {
  if (threadIdx.x < TILE) {
    const int kj = k0 + threadIdx.x;
    bs[threadIdx.x] = kj < T ? (bias ? bias[b * stride + kj] : 0.f) : -INFINITY;
  }
}

__global__ void __launch_bounds__(FT)
stats_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ bias, long long bias_stride, const float* __restrict__ dout,
          float* __restrict__ stats, int H, int T, float scale) {
  extern __shared__ float fsm[];
  float *qs = fsm, *ds_ = qs + FTILE, *ks = ds_ + FTILE, *vs = ks + FTILE, *bs = vs + FTILE;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * TILE;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const size_t base = (size_t)bh * T * DH;
  load_tile(qs, q + base, q0, T);
  load_tile(ds_, dout + base, q0, T);
  float m[4], l[4], a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f, a[i] = 0.f;

  for (int k0 = 0; k0 < T; k0 += TILE) {
    __syncthreads();
    load_tile(ks, k + base, k0, T);
    load_tile(vs, v + base, k0, T);
    load_key_bias(bs, bias, bias_stride, b, k0, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm(s, qs, FS, 1, ks, 1, FS, tr, tc);   // q k^T
    mm(dp, ds_, FS, 1, vs, 1, FS, tr, tc);  // do v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * scale + bs[tc + 16 * j];
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mx));
      const float al = expf(m[i] - mn);
      float ps = 0.f, pa = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - mn);
        ps += e;
        pa += e * dp[i][j];
      }
      l[i] = l[i] * al + row_sum16(ps);
      a[i] = a[i] * al + row_sum16(pa);
      m[i] = mn;
    }
  }
  const size_t plane = (size_t)gridDim.y * T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (tc == 0 && qi < T) {
      const size_t o = (size_t)bh * T + qi;
      stats[o] = m[i];
      stats[plane + o] = l[i];
      stats[2 * plane + o] = a[i] / l[i];
    }
  }
}

__global__ void __launch_bounds__(FT)
dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ bias, long long bias_stride, const float* __restrict__ dout,
       const float* __restrict__ stats, float* __restrict__ dq, int H, int T, float scale) {
  extern __shared__ float fsm[];
  float *qs = fsm, *dos = qs + FTILE, *ks = dos + FTILE, *vs = ks + FTILE, *dss = vs + FTILE,
        *bs = dss + FTILE;
  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * TILE;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const size_t base = (size_t)bh * T * DH, plane = (size_t)gridDim.y * T;
  load_tile(qs, q + base, q0, T);
  load_tile(dos, dout + base, q0, T);
  float m[4], l[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    const size_t o = (size_t)bh * T + qi;
    m[i] = qi < T ? stats[o] : 0.f;
    l[i] = qi < T ? stats[plane + o] : 1.f;
    D[i] = qi < T ? stats[2 * plane + o] : 0.f;
  }
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < T; k0 += TILE) {
    __syncthreads();
    load_tile(ks, k + base, k0, T);
    load_tile(vs, v + base, k0, T);
    load_key_bias(bs, bias, bias_stride, b, k0, T);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm(s, qs, FS, 1, ks, 1, FS, tr, tc);
    mm(dp, dos, FS, 1, vs, 1, FS, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = expf(s[i][j] * scale + bs[c] - m[i]) / l[i];
        dss[(tr + 16 * i) * FS + c] = p * (dp[i][j] - D[i]);
      }
    __syncthreads();
    mm(acc, dss, FS, 1, ks, FS, 1, tr, tc);  // ds k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi < T)
#pragma unroll
      for (int j = 0; j < 4; ++j) dq[base + (size_t)qi * DH + tc + 16 * j] = acc[i][j] * scale;
  }
}

__global__ void __launch_bounds__(FT)
dkdv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ bias, long long bias_stride, const float* __restrict__ dout,
         const float* __restrict__ stats, float* __restrict__ dk, float* __restrict__ dv,
         float* __restrict__ dbias, int H, int T, float scale) {
  extern __shared__ float fsm[];
  float *ks = fsm, *vs = ks + FTILE, *qs = vs + FTILE, *dos = qs + FTILE, *pt = dos + FTILE,
        *dst = pt + FTILE, *sm = dst + FTILE, *sl = sm + TILE, *sd = sl + TILE;
  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * TILE;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const size_t base = (size_t)bh * T * DH, plane = (size_t)gridDim.y * T;
  load_tile(ks, k + base, k0, T);
  load_tile(vs, v + base, k0, T);
  float bk[4], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr + 16 * i;
    bk[i] = (kj < T && bias) ? bias[b * bias_stride + kj] : 0.f;
    db[i] = 0.f;
  }
  float dva[4][4], dka[4][4];
  zero(dva);
  zero(dka);
  for (int q0 = 0; q0 < T; q0 += TILE) {
    __syncthreads();
    load_tile(qs, q + base, q0, T);
    load_tile(dos, dout + base, q0, T);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      const size_t o = (size_t)bh * T + qi;
      sm[threadIdx.x] = qi < T ? stats[o] : INFINITY;
      sl[threadIdx.x] = qi < T ? stats[plane + o] : 1.f;
      sd[threadIdx.x] = qi < T ? stats[2 * plane + o] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm(s, ks, FS, 1, qs, 1, FS, tr, tc);    // k q^T: rows keys, columns queries
    mm(dp, vs, FS, 1, dos, 1, FS, tr, tc);  // v do^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = expf(s[i][j] * scale + bk[i] - sm[c]) / sl[c];
        const float d = p * (dp[i][j] - sd[c]);
        db[i] += d;
        pt[(tr + 16 * i) * FS + c] = p;
        dst[(tr + 16 * i) * FS + c] = d;
      }
    __syncthreads();
    mm(dva, pt, FS, 1, dos, FS, 1, tr, tc);  // p^T do
    mm(dka, dst, FS, 1, qs, FS, 1, tr, tc);  // ds^T q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + tr + 16 * i;
    const float dbi = row_sum16(db[i]);
    if (kj < T) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk[base + (size_t)kj * DH + tc + 16 * j] = dka[i][j] * scale;
        dv[base + (size_t)kj * DH + tc + 16 * j] = dva[i][j];
      }
      if (dbias && tc == 0) dbias[(size_t)bh * T + kj] = dbi;
    }
  }
}

constexpr size_t SMEM_STATS_F32 = (4 * FTILE + TILE) * sizeof(float);
constexpr size_t SMEM_DQ_F32 = (5 * FTILE + TILE) * sizeof(float);
constexpr size_t SMEM_DKDV_F32 = (6 * FTILE + 3 * TILE) * sizeof(float);

// ---------------------------------------------------------------- bf16: tensor cores
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int WARPS = TILE / 16;
constexpr int RP = DH + 8;    // row stride of a [row][d] tile (bf16)
constexpr int CP = TILE + 8;  // row stride of a [d][row] tile (bf16)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t): A rows g and g + 8,
// columns 2t, 2t + 1 and 2t + 8, 2t + 9; B column g, rows 2t, 2t + 1, 2t + 8,
// 2t + 9; C rows g and g + 8, columns 2t, 2t + 1.

// A fragments of 16 rows (r0 = first row + g, r1 = r0 + 8) of a (T, 64) matrix.
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const bf16* src, int r0,
                                       int T, int t) {
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    const int c = 16 * kc + 2 * t;
    a[kc][0] = r0 < T ? ld32(src + (size_t)r0 * DH + c) : 0u;
    a[kc][1] = r0 + 8 < T ? ld32(src + (size_t)(r0 + 8) * DH + c) : 0u;
    a[kc][2] = r0 < T ? ld32(src + (size_t)r0 * DH + c + 8) : 0u;
    a[kc][3] = r0 + 8 < T ? ld32(src + (size_t)(r0 + 8) * DH + c + 8) : 0u;
  }
}

// Rows [r0, r0 + 64) of a (T, 64) matrix into shared memory as [row][d]
// (`rows`) and/or [d][row] (`cols`), zero past T. Lanes take consecutive
// rows: conflict-free stores to both layouts.
__device__ __forceinline__ void stage(const bf16* src, int r0, int T, bf16* rows, bf16* cols) {
  for (int i = threadIdx.x; i < TILE * DH / 8; i += blockDim.x) {
    const int j = i % TILE, d0 = (i / TILE) * 8, r = r0 + j;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)r * DH + d0);
    if (rows) *reinterpret_cast<uint4*>(rows + j * RP + d0) = val;
    if (cols) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) cols[(d0 + x) * CP + j] = e[x];
    }
  }
}

// c[nt] = A (16 x 64, fragments) times the 64-row tile `rows` [row][d]^T:
// 16 x 64 scores, 8 column tiles of 8.
__device__ __forceinline__ void mm_rows(float (&c)[TILE / 8][4], const uint32_t (&a)[DH / 16][4],
                                        const bf16* rows, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    const bf16* r = rows + (8 * nt + g) * RP + 2 * t;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) mma_bf16(c[nt], a[kc], ld32(r + 16 * kc), ld32(r + 16 * kc + 8));
  }
}

// acc (16 x 64) += X (16 x 64 in C layout, rounded to bf16 as A fragments)
// times the tile `cols` [d][row]: contracts over the tile's 64 rows.
__device__ __forceinline__ void mm_cols(float (&acc)[DH / 8][4], const float (&x)[TILE / 8][4],
                                        const bf16* cols, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < TILE / 16; ++kc) {
    const uint32_t a[4] = {pack(x[2 * kc][0], x[2 * kc][1]), pack(x[2 * kc][2], x[2 * kc][3]),
                           pack(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                           pack(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const bf16* c = cols + (8 * nt + g) * CP + 16 * kc + 2 * t;
      mma_bf16(acc[nt], a, ld32(c), ld32(c + 8));
    }
  }
}

__device__ __forceinline__ void stage_key_bias(float* bs, const bf16* bias, long long stride,
                                               int b, int k0, int T) {
  if (threadIdx.x < TILE) {
    const int kj = k0 + threadIdx.x;
    bs[threadIdx.x] = kj < T ? (bias ? to_f32(bias[b * stride + kj]) : 0.f) : -INFINITY;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(WARPS * 32)
stats_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ bias, long long bias_stride, const bf16* __restrict__ dout,
         float* __restrict__ stats, int H, int T, float scale) {
  __shared__ __align__(16) bf16 ks[TILE * RP];
  __shared__ __align__(16) bf16 vs[TILE * RP];
  __shared__ float bs[TILE];
  const int bh = blockIdx.y, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * T * DH;
  const int r0 = blockIdx.x * TILE + warp * 16 + g;
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a(qa, q + base, r0, T, t);
  load_a(da, dout + base, r0, T, t);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < T; k0 += TILE) {
    __syncthreads();
    stage(k + base, k0, T, ks, nullptr);
    stage(v + base, k0, T, vs, nullptr);
    stage_key_bias(bs, bias, bias_stride, b, k0, T);
    __syncthreads();
    float s[TILE / 8][4], dp[TILE / 8][4];
    mm_rows(s, qa, ks, g, t);
    mm_rows(dp, da, vs, g, t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] * scale + bs[8 * nt + 2 * t + (e & 1)];
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      const float al = expf(m[h] - mn);
      float ps = 0.f, pa = 0.f;
#pragma unroll
      for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float ex = expf(s[nt][e] - mn);
          ps += ex;
          pa += ex * dp[nt][e];
        }
      l[h] = l[h] * al + quad_sum(ps);
      a[h] = a[h] * al + quad_sum(pa);
      m[h] = mn;
    }
  }
  const size_t plane = (size_t)gridDim.y * T;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + 8 * h;
    if (t == 0 && qi < T) {
      const size_t o = (size_t)bh * T + qi;
      stats[o] = m[h];
      stats[plane + o] = l[h];
      stats[2 * plane + o] = a[h] / l[h];
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
      const bf16* __restrict__ bias, long long bias_stride, const bf16* __restrict__ dout,
      const float* __restrict__ stats, bf16* __restrict__ dq, int H, int T, float scale) {
  __shared__ __align__(16) bf16 ks[TILE * RP];  // [key][d]
  __shared__ __align__(16) bf16 vs[TILE * RP];  // [key][d]
  __shared__ __align__(16) bf16 kt[DH * CP];    // [d][key]
  __shared__ float bs[TILE];
  const int bh = blockIdx.y, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * T * DH, plane = (size_t)gridDim.y * T;
  const int r0 = blockIdx.x * TILE + warp * 16 + g;
  uint32_t qa[DH / 16][4], da[DH / 16][4];
  load_a(qa, q + base, r0, T, t);
  load_a(da, dout + base, r0, T, t);
  float m[2], l[2], D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = r0 + 8 * h;
    const size_t o = (size_t)bh * T + qi;
    m[h] = qi < T ? stats[o] : 0.f;
    l[h] = qi < T ? stats[plane + o] : 1.f;
    D[h] = qi < T ? stats[2 * plane + o] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = 0; k0 < T; k0 += TILE) {
    __syncthreads();
    stage(k + base, k0, T, ks, kt);
    stage(v + base, k0, T, vs, nullptr);
    stage_key_bias(bs, bias, bias_stride, b, k0, T);
    __syncthreads();
    float s[TILE / 8][4], dp[TILE / 8][4];
    mm_rows(s, qa, ks, g, t);
    mm_rows(dp, da, vs, g, t);
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = expf(s[nt][e] * scale + bs[8 * nt + 2 * t + (e & 1)] - m[h]) / l[h];
        s[nt][e] = p * (dp[nt][e] - D[h]);  // ds
      }
    mm_cols(acc, s, kt, g, t);  // ds k
  }
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = 8 * nt + 2 * t;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)r0 * DH + c) =
          pack(acc[nt][0] * scale, acc[nt][1] * scale);
    if (r0 + 8 < T)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)(r0 + 8) * DH + c) =
          pack(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
        const bf16* __restrict__ bias, long long bias_stride, const bf16* __restrict__ dout,
        const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
        float* __restrict__ dbias, int H, int T, float scale) {
  __shared__ __align__(16) bf16 qs[TILE * RP];   // [query][d]
  __shared__ __align__(16) bf16 dos[TILE * RP];  // [query][d]
  __shared__ __align__(16) bf16 qt[DH * CP];     // [d][query]
  __shared__ __align__(16) bf16 dot[DH * CP];    // [d][query]
  __shared__ float sm[TILE], sl[TILE], sd[TILE];
  const int bh = blockIdx.y, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * T * DH, plane = (size_t)gridDim.y * T;
  const int r0 = blockIdx.x * TILE + warp * 16 + g;  // this lane's keys: r0, r0 + 8
  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a(ka, k + base, r0, T, t);
  load_a(va, v + base, r0, T, t);
  float bk[2], db[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = r0 + 8 * h;
    bk[h] = (kj < T && bias) ? to_f32(bias[b * bias_stride + kj]) : 0.f;
  }
  float dva[DH / 8][4], dka[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[nt][e] = dka[nt][e] = 0.f;

  for (int q0 = 0; q0 < T; q0 += TILE) {
    __syncthreads();
    stage(q + base, q0, T, qs, qt);
    stage(dout + base, q0, T, dos, dot);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      const size_t o = (size_t)bh * T + qi;
      sm[threadIdx.x] = qi < T ? stats[o] : INFINITY;
      sl[threadIdx.x] = qi < T ? stats[plane + o] : 1.f;
      sd[threadIdx.x] = qi < T ? stats[2 * plane + o] : 0.f;
    }
    __syncthreads();
    float s[TILE / 8][4], dp[TILE / 8][4];
    mm_rows(s, ka, qs, g, t);    // k q^T: rows keys, columns queries
    mm_rows(dp, va, dos, g, t);  // v do^T
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t + (e & 1), h = e >> 1;
        const float p = expf(s[nt][e] * scale + bk[h] - sm[c]) / sl[c];
        const float d = p * (dp[nt][e] - sd[c]);
        db[h] += d;
        s[nt][e] = p;
        dp[nt][e] = d;
      }
    mm_cols(dva, s, dot, g, t);  // p^T do
    mm_cols(dka, dp, qt, g, t);  // ds^T q
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) db[h] = quad_sum(db[h]);
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = 8 * nt + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kj = r0 + 8 * h;
      if (kj < T) {
        *reinterpret_cast<uint32_t*>(dk + base + (size_t)kj * DH + c) =
            pack(dka[nt][2 * h] * scale, dka[nt][2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + base + (size_t)kj * DH + c) =
            pack(dva[nt][2 * h], dva[nt][2 * h + 1]);
      }
    }
  }
  if (dbias && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < T) dbias[(size_t)bh * T + r0 + 8 * h] = db[h];
  }
}

}  // namespace tc

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// Common arguments: q, k, v, dout (B, H, T, 64) contiguous and 16-byte aligned,
// f32 or bf16 (`dtype`); bias null or the (B, T) additive key bias in q's
// dtype, row b at bias + b * bias_stride elements; stats (3, B*H, T) f32 =
// (m, l, D). Each launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).

extern "C" int attention_bwd_stats(const void* q, const void* k, const void* v, const void* bias,
                                   long long bias_stride, const void* dout, void* stats, int B,
                                   int H, int T, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != DH) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    const int err = set_smem((const void*)stats_f32, SMEM_STATS_F32);
    if (err) return err;
    stats_f32<<<grid, FT, SMEM_STATS_F32, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), bias_stride, static_cast<const float*>(dout),
        static_cast<float*>(stats), H, T, scale);
  } else if (dtype == DTYPE_BF16) {
    tc::stats_tc<<<grid, tc::WARPS * 32, 0, s>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(bias), bias_stride,
        static_cast<const tc::bf16*>(dout), static_cast<float*>(stats), H, T, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dk, dv: like k; dbias: null, or (B*H, T) f32 per-head sums over queries.
extern "C" int attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* bias,
                                  long long bias_stride, const void* dout, const void* stats,
                                  void* dk, void* dv, void* dbias, int B, int H, int T, int D,
                                  float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != DH) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    const int err = set_smem((const void*)dkdv_f32, SMEM_DKDV_F32);
    if (err) return err;
    dkdv_f32<<<grid, FT, SMEM_DKDV_F32, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), bias_stride, static_cast<const float*>(dout),
        static_cast<const float*>(stats), static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(dbias), H, T, scale);
  } else if (dtype == DTYPE_BF16) {
    tc::dkdv_tc<<<grid, tc::WARPS * 32, 0, s>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(bias), bias_stride,
        static_cast<const tc::bf16*>(dout), static_cast<const float*>(stats),
        static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), static_cast<float*>(dbias), H,
        T, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dq: like q.
extern "C" int attention_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                                long long bias_stride, const void* dout, const void* stats,
                                void* dq, int B, int H, int T, int D, float scale, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != DH) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    const int err = set_smem((const void*)dq_f32, SMEM_DQ_F32);
    if (err) return err;
    dq_f32<<<grid, FT, SMEM_DQ_F32, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), bias_stride, static_cast<const float*>(dout),
        static_cast<const float*>(stats), static_cast<float*>(dq), H, T, scale);
  } else if (dtype == DTYPE_BF16) {
    tc::dq_tc<<<grid, tc::WARPS * 32, 0, s>>>(
        static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
        static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(bias), bias_stride,
        static_cast<const tc::bf16*>(dout), static_cast<const float*>(stats),
        static_cast<tc::bf16*>(dq), H, T, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
