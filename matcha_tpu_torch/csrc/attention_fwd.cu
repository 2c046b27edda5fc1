// Decoder self-attention forward (K1), flash-style, for Hopper (sm_90a).
//
// Replaces the Pallas kernel matcha_tpu/ops/attention_pallas.py::_attn_kernel:
//   o = softmax(q k^T * scale + bias[b, None, :]) v        per (batch, head)
// with bias the raw (B, T) 0/1 key mask added to the logits (the diffusers
// quirk the reference keeps). When autograd needs it, the kernel also writes
// the row log-sum-exp lse = m + log(l), f32 (B, H, T), which the backward (K4)
// reads instead of recomputing the softmax statistics.
//
// Bound: 4*B*H*T^2*D flops against 4*B*H*T*D elements moved, so operations at
// the decoder's T; at the serving path's batch 1 the grid is the limit.
//
// Design: one block of 4 warps per (64-query tile, batch*head, key split).
// The query tile and a ring of K/V tiles (3 stages in bf16, 2 in f32) live in
// shared memory, staged by cp.async: tile i + 1 is in flight while tile i is
// multiplied (attention_tiles.cuh: swizzled [row][d] tiles, ldmatrix and
// mma.sync m16n8k16 in bf16, three TF32 mma.sync in f32). Scores, online max
// and sum stay in f32 registers; p is rounded to bf16 only as it enters p v.
//
// Key split: when the grid (query tiles x B*H) leaves SMs idle and each block
// would walk many key tiles, the wrapper splits each row's keys over S ranges,
// S from the shape, the dtype and the SM count (ops/attention.py::key_splits). The S
// blocks of a query tile form a thread-block cluster: each keeps its
// unnormalised o, m and l in shared memory, and after a cluster barrier each
// combines a slice of the rows from all S partials, in split order, through
// distributed shared memory. One launch, no scratch in device memory, no
// atomics, and the result does not depend on the blocks' order.
//
// Rows past T: keys are zero with a -inf bias (p = 0); queries are zero and
// nothing past T is written.

#include <cooperative_groups.h>

#include "attention_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace attn;

constexpr int MAX_SPLITS = 8;  // blocks of a cluster, the portable limit
constexpr int PS = DH + 8;     // row stride of a partial o in shared memory (floats)

template <typename T>
constexpr size_t fwd_smem() {
  return (size_t)(1 + 2 * stages<T>()) * TILE_ELEMS * sizeof(T) +
         stages<T>() * TILE * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ bias, long long bias_stride, T* __restrict__ o,
                float* __restrict__ lse, int H, int n, float scale) {
  constexpr int NS = stages<T>();
  static_assert(2 * NS * TILE_ELEMS * sizeof(T) >= (TILE * PS + 2 * TILE) * sizeof(float),
                "a split's partial must fit in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = qs + TILE_ELEMS;  // stage s: K at ring + 2s tiles, V after it
  float* bs = reinterpret_cast<float*>(ring + 2 * NS * TILE_ELEMS);  // NS x 64 key biases

  const int qt = blockIdx.x, bh = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int b = bh / H, q0 = qt * TILE;
  const int tiles = (n + TILE - 1) / TILE;
  const int j0 = split * tiles / splits, j1 = (split + 1) * tiles / splits;
  const size_t base = (size_t)bh * n * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * LOG2E;

  load_tile(qs, q + base, q0, n);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    const int j = j0 + s;
    if (j < j1) {
      load_tile(ring + 2 * s * TILE_ELEMS, k + base, j * TILE, n);
      load_tile(ring + (2 * s + 1) * TILE_ELEMS, v + base, j * TILE, n);
      if (threadIdx.x < TILE)
        bs[s * TILE + threadIdx.x] = key_bias2(bias, bias_stride, b, j * TILE + threadIdx.x, n);
    }
    cp_commit();
  }

  float acc[8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // row max (base 2) and sum

  for (int j = j0; j < j1; ++j) {
    const int li = j - j0, jn = j + NS - 1, sn = (li + NS - 1) % NS, sl = li % NS;
    cp_wait<NS - 2>();
    __syncthreads();  // tile j landed for every thread; slot sn is consumed
    float nb = 0.f;
    if (jn < j1) {
      load_tile(ring + 2 * sn * TILE_ELEMS, k + base, jn * TILE, n);
      load_tile(ring + (2 * sn + 1) * TILE_ELEMS, v + base, jn * TILE, n);
      if (threadIdx.x < TILE) nb = key_bias2(bias, bias_stride, b, jn * TILE + threadIdx.x, n);
    }
    cp_commit();

    const T* ks = ring + 2 * sl * TILE_ELEMS;
    const float* bsl = bs + sl * TILE;
    float s[8][4];
    mm_rows<T>(s, qs, warp * 16, ks);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fmaf(s[nt][e], scale2, bsl[8 * nt + 2 * t + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float al[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));  // finite: a tile's first key is < T
      al[h] = exp2f(m[h] - mn);                        // 0 on the first tile
      m[h] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        ps[e >> 1] += s[nt][e];
        acc[nt][e] *= al[e >> 1];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * al[h] + quad_sum(ps[h]);
    mm_cols<T>(acc, s, ks + TILE_ELEMS);

    if (jn < j1 && threadIdx.x < TILE) bs[sn * TILE + threadIdx.x] = nb;
  }

  const int r0 = warp * 16 + g;  // this lane's rows in the tile: r0, r0 + 8
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + r0 + 8 * h;
      if (qi >= n) continue;
      const float inv = 1.f / l[h];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        store2(o + base + (size_t)qi * DH + 8 * nt + 2 * t, acc[nt][2 * h] * inv,
               acc[nt][2 * h + 1] * inv);
      if (lse && t == 0) lse[(size_t)bh * n + qi] = (m[h] + log2f(l[h])) * LN2;
    }
    return;
  }

  // ---- key split: the S blocks of this query tile are one cluster. Each
  // leaves its unnormalised o, m and l in its own shared memory; after a
  // cluster barrier each combines 64/S of the rows, reading all S partials
  // in split order through distributed shared memory.
  cg::cluster_group cluster = cg::this_cluster();
  cp_wait<0>();
  __syncthreads();  // the ring is read no more: it holds the partial now
  float* po = reinterpret_cast<float*>(ring);  // [64][PS] o, then m[64], l[64]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      store2(po + r * PS + 8 * nt + 2 * t, acc[nt][2 * h], acc[nt][2 * h + 1]);
    if (t == 0) {
      po[TILE * PS + r] = m[h];
      po[TILE * PS + TILE + r] = l[h];
    }
  }
  cluster.sync();

  const int rb = split * TILE / splits, re = (split + 1) * TILE / splits;
  for (int i = threadIdx.x; i < (re - rb) * (DH / 4); i += THREADS) {
    const int r = rb + i / (DH / 4), c = 4 * (i % (DH / 4));
    float w[MAX_SPLITS], mmax = -INFINITY, sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      w[s] = cluster.map_shared_rank(po, s)[TILE * PS + r];
      mmax = fmaxf(mmax, w[s]);
    }
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float* ps = cluster.map_shared_rank(po, s);
      w[s] = exp2f(w[s] - mmax);
      sum += w[s] * ps[TILE * PS + TILE + r];
      const float4 x = *reinterpret_cast<const float4*>(ps + r * PS + c);
      out.x += w[s] * x.x;
      out.y += w[s] * x.y;
      out.z += w[s] * x.z;
      out.w += w[s] * x.w;
    }
    const int qi = q0 + r;
    if (qi < n) {
      const float inv = 1.f / sum;
      T* orow = o + base + (size_t)qi * DH + c;
      store2(orow, out.x * inv, out.y * inv);
      store2(orow + 2, out.z * inv, out.w * inv);
      if (lse && c == 0) lse[(size_t)bh * n + qi] = (mmax + log2f(sum)) * LN2;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, long long bias_stride,
           void* o, float* lse, int B, int H, int n, float scale, int splits,
           cudaStream_t stream) {
  const int err = set_smem((const void*)attn_fwd_kernel<T>, fwd_smem<T>());
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + TILE - 1) / TILE, B * H, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = fwd_smem<T>();
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, attn_fwd_kernel<T>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(bias), bias_stride, static_cast<T*>(o), lse,
      H, n, scale);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, T, 64) contiguous and 16-byte aligned, f32 or bf16
// (`dtype`); bias: null, or the (B, T) additive key bias in q's dtype, row b at
// bias + b * bias_stride elements, keys contiguous; lse: null (nothing
// written) or (B, H, T) f32. splits: key ranges per query tile, 1 to
// min(ceil(T / 64), 8), each a block of one cluster. Launches on `stream`
// and returns the launch's error (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             long long bias_stride, void* o, void* lse, int B, int H, int T,
                             int D, float scale, int splits, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != DH || splits < 1 || splits > MAX_SPLITS ||
      splits > (T + TILE - 1) / TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == DTYPE_F32)
    return launch<float>(q, k, v, bias, bias_stride, o, l, B, H, T, scale, splits, s);
  if (dtype == DTYPE_BF16)
    return launch<bf16>(q, k, v, bias, bias_stride, o, l, B, H, T, scale, splits, s);
  return (int)cudaErrorInvalidValue;
}
