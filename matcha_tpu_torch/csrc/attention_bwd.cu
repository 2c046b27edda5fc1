// Decoder self-attention backward (K4), flash-style, for Hopper (sm_90a).
//
// Replaces the Pallas kernel matcha_tpu/ops/attention_pallas.py::_attn_bwd_kernel.
// With p = softmax(q k^T * scale + bias[b, None, :]) per (batch, head):
//   dv = p^T do            dp = do v^T          ds = p * (dp - D)
//   dq = scale * ds k      dk = scale * ds^T q  dbias = sum over queries of ds
// where D = rowsum(dp * p) = rowsum(do * o). The TPU kernel recomputes the
// whole (T, T) softmax of a (batch, head) in VMEM; an SM cannot hold it. Here
// the forward (K1) saves o and the row log-sum-exp lse, so p = exp(s - lse)
// comes back tile by tile, in f32 as on the TPU, and two launches do the rest:
//   1. dq: one block per 64-query tile walks the key tiles (s, dp, ds k: 3
//      products a tile). It first takes D = rowsum(do * o) in f32 for its
//      rows (64 x 64 multiply-adds) and writes it, (B*H, T) f32, for launch 2;
//   2. dkdv: one block per 64-key tile walks the query tiles (s, p^T do,
//      dp, ds^T q: 4 products a tile) and sums dbias per head.
// 7 products where the function needs 5 (the bound counts 5); every output
// element has one writer, so there are no atomics and the gradients are
// deterministic. dbias leaves per head, (B*H, T) f32; the wrapper sums heads.
//
// Bound: 10*B*H*T^2*D flops against the 7*B*H*T*D elements the gradient
// moves (q, k, v, do in; dq, dk, dv out), so operations at the decoder's T.
// The o and lse read here and the D written are this design's traffic, not
// the gradient's, and stay out of the bound. Design as K1 (attention_tiles.cuh): 4 warps a block, the
// block's own two tiles and a cp.async ring of streamed tiles in shared
// memory (3 stages in bf16, 2 in f32), one swizzled [row][d] layout read by
// ldmatrix / ldmatrix.trans and mma.sync m16n8k16 in bf16, three TF32 mma.sync
// in f32. p and ds are f32 and rounded to bf16 only as they enter a product,
// where the TPU kernel rounds them too; dbias sums ds in f32.
//
// Rows past T: keys are zero with a -inf bias (p = 0), queries past T get
// p = 0; nothing past T is written.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

// own q and do tiles, a ring of (k, v) tiles, a ring of key biases
template <typename T>
constexpr size_t dq_smem() {
  return (size_t)(2 + 2 * stages<T>()) * TILE_ELEMS * sizeof(T) +
         stages<T>() * TILE * sizeof(float);
}

// own k and v tiles, a ring of (q, do) tiles, a ring of (lse, D) rows
template <typename T>
constexpr size_t dkdv_smem() {
  return (size_t)(2 + 2 * stages<T>()) * TILE_ELEMS * sizeof(T) +
         stages<T>() * 2 * TILE * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ bias, long long bias_stride, const T* __restrict__ dout,
                   const T* __restrict__ o, const float* __restrict__ lse,
                   float* __restrict__ delta, T* __restrict__ dq, int H, int n, float scale) {
  constexpr int NS = stages<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + TILE_ELEMS;
  T* ring = dos + TILE_ELEMS;  // stage s: K at ring + 2s tiles, V after it
  float* bs = reinterpret_cast<float*>(ring + 2 * NS * TILE_ELEMS);
  __shared__ float s_lse[TILE], s_delta[TILE];

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * TILE;
  const int tiles = (n + TILE - 1) / TILE;
  const size_t base = (size_t)bh * n * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * LOG2E;

  load_tile(qs, q + base, q0, n);
  load_tile(dos, dout + base, q0, n);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < tiles) {
      load_tile(ring + 2 * s * TILE_ELEMS, k + base, s * TILE, n);
      load_tile(ring + (2 * s + 1) * TILE_ELEMS, v + base, s * TILE, n);
      if (threadIdx.x < TILE)
        bs[s * TILE + threadIdx.x] = key_bias2(bias, bias_stride, b, s * TILE + threadIdx.x, n);
    }
    cp_commit();
  }

  {  // D = rowsum(do * o) in f32 for the tile's rows, two threads a row
    constexpr int E = 16 / sizeof(T);
    const int r = threadIdx.x >> 1, qi = q0 + r, c0 = (threadIdx.x & 1) * (DH / 2);
    float d = 0.f;
    if (qi < n) {
      const uint4* dr = reinterpret_cast<const uint4*>(dout + base + (size_t)qi * DH + c0);
      const uint4* orow = reinterpret_cast<const uint4*>(o + base + (size_t)qi * DH + c0);
#pragma unroll
      for (int c = 0; c < DH / 2 / E; ++c) {
        const uint4 x = dr[c], y = orow[c];
        const T* xe = reinterpret_cast<const T*>(&x);
        const T* ye = reinterpret_cast<const T*>(&y);
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(to_f32(xe[e]), to_f32(ye[e]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((threadIdx.x & 1) == 0) {
      s_delta[r] = d;
      if (qi < n) delta[(size_t)bh * n + qi] = d;
    } else {
      s_lse[r] = qi < n ? lse[(size_t)bh * n + qi] : 0.f;
    }
  }
  __syncthreads();
  float rl[2], rd[2];  // log2(e) lse and D of this lane's rows
  bool rv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    rl[h] = s_lse[r] * LOG2E;
    rd[h] = s_delta[r];
    rv[h] = q0 + r < n;
  }

  float acc[8][4];
  zero(acc);
  for (int j = 0; j < tiles; ++j) {
    const int jn = j + NS - 1, sn = jn % NS, sl = j % NS;
    cp_wait<NS - 2>();
    __syncthreads();
    float nb = 0.f;
    if (jn < tiles) {
      load_tile(ring + 2 * sn * TILE_ELEMS, k + base, jn * TILE, n);
      load_tile(ring + (2 * sn + 1) * TILE_ELEMS, v + base, jn * TILE, n);
      if (threadIdx.x < TILE) nb = key_bias2(bias, bias_stride, b, jn * TILE + threadIdx.x, n);
    }
    cp_commit();

    const T* ks = ring + 2 * sl * TILE_ELEMS;
    const float* bsl = bs + sl * TILE;
    float s[8][4], dp[8][4];
    mm_rows<T, 2>(s, qs, warp * 16, ks);
    mm_rows<T, 2>(dp, dos, warp * 16, ks + TILE_ELEMS);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            rv[h] ? exp2f(fmaf(s[nt][e], scale2, bsl[8 * nt + 2 * t + (e & 1)]) - rl[h]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - rd[h]);  // ds
      }
    mm_cols<T>(acc, s, ks);  // ds k

    if (jn < tiles && threadIdx.x < TILE) bs[sn * TILE + threadIdx.x] = nb;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rv[h]) continue;
    const int qi = q0 + warp * 16 + g + 8 * h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      store2(dq + base + (size_t)qi * DH + 8 * nt + 2 * t, acc[nt][2 * h] * scale,
             acc[nt][2 * h + 1] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ bias, long long bias_stride,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dbias, int H, int n, float scale) {
  constexpr int NS = stages<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + TILE_ELEMS;
  T* ring = vs + TILE_ELEMS;  // stage s: Q at ring + 2s tiles, dO after it
  float* st = reinterpret_cast<float*>(ring + 2 * NS * TILE_ELEMS);  // stage s: lse[64], D[64]

  const int bh = blockIdx.y, b = bh / H, k0 = blockIdx.x * TILE;
  const int tiles = (n + TILE - 1) / TILE;
  const size_t base = (size_t)bh * n * DH, rows = (size_t)bh * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * LOG2E;

  // (lse, D) of query tile j into stage slot s: one 4-byte copy a thread
  auto load_stats = [&](int s, int j) {
    const int i = threadIdx.x & (TILE - 1), qi = j * TILE + i;
    const float* src = threadIdx.x < TILE ? lse : delta;
    cp_async4(st + s * 2 * TILE + threadIdx.x, src + rows + (qi < n ? qi : 0), qi < n);
  };

  load_tile(ks, k + base, k0, n);
  load_tile(vs, v + base, k0, n);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < tiles) {
      load_tile(ring + 2 * s * TILE_ELEMS, q + base, s * TILE, n);
      load_tile(ring + (2 * s + 1) * TILE_ELEMS, dout + base, s * TILE, n);
      load_stats(s, s);
    }
    cp_commit();
  }

  float bk[2], db[2] = {0.f, 0.f};  // this lane's keys: rows r0, r0 + 8 of the block's tile
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) bk[h] = key_bias2(bias, bias_stride, b, k0 + r0 + 8 * h, n);

  float dva[8][4], dka[8][4];
  zero(dva);
  zero(dka);
  for (int j = 0; j < tiles; ++j) {
    const int jn = j + NS - 1, sn = jn % NS, sl = j % NS;
    cp_wait<NS - 2>();
    __syncthreads();
    if (jn < tiles) {
      load_tile(ring + 2 * sn * TILE_ELEMS, q + base, jn * TILE, n);
      load_tile(ring + (2 * sn + 1) * TILE_ELEMS, dout + base, jn * TILE, n);
      load_stats(sn, jn);
    }
    cp_commit();

    const T* qs = ring + 2 * sl * TILE_ELEMS;
    const T* dos = qs + TILE_ELEMS;
    const float* sls = st + sl * 2 * TILE;
    const float* sds = sls + TILE;
    float p[8][4], ds[8][4];  // rows: this warp's keys; columns: the tile's queries
    mm_rows<T, 2>(p, ks, warp * 16, qs);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t + (e & 1);
        p[nt][e] = j * TILE + c < n
                       ? exp2f(fmaf(p[nt][e], scale2, bk[e >> 1]) - sls[c] * LOG2E)
                       : 0.f;
      }
    mm_cols<T>(dva, p, dos);  // p^T do
    mm_rows<T, 2>(ds, vs, warp * 16, dos);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[nt][e] = p[nt][e] * (ds[nt][e] - sds[8 * nt + 2 * t + (e & 1)]);
        db[e >> 1] += ds[nt][e];
      }
    mm_cols<T>(dka, ds, qs);  // ds^T q
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float dbh = quad_sum(db[h]);
    const int kj = k0 + r0 + 8 * h;
    if (kj >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const size_t off = base + (size_t)kj * DH + 8 * nt + 2 * t;
      store2(dk + off, dka[nt][2 * h] * scale, dka[nt][2 * h + 1] * scale);
      store2(dv + off, dva[nt][2 * h], dva[nt][2 * h + 1]);
    }
    if (dbias && t == 0) dbias[rows + kj] = dbh;
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              long long bias_stride, const void* dout, const void* o, const float* lse,
              float* delta, void* dq, int B, int H, int n, float scale, cudaStream_t stream) {
  const int err = set_smem((const void*)attn_bwd_dq_kernel<T>, dq_smem<T>());
  if (err) return err;
  const dim3 grid((n + TILE - 1) / TILE, B * H);
  attn_bwd_dq_kernel<T><<<grid, THREADS, dq_smem<T>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), bias_stride, static_cast<const T*>(dout),
      static_cast<const T*>(o), lse, delta, static_cast<T*>(dq), H, n, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v, const void* bias,
                long long bias_stride, const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, float* dbias, int B, int H, int n, float scale,
                cudaStream_t stream) {
  const int err = set_smem((const void*)attn_bwd_dkdv_kernel<T>, dkdv_smem<T>());
  if (err) return err;
  const dim3 grid((n + TILE - 1) / TILE, B * H);
  attn_bwd_dkdv_kernel<T><<<grid, THREADS, dkdv_smem<T>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), bias_stride, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), dbias, H, n, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Common arguments: q, k, v, dout, o (B, H, T, 64) contiguous and 16-byte
// aligned, f32 or bf16 (`dtype`); bias null or the (B, T) additive key bias in
// q's dtype, row b at bias + b * bias_stride elements; lse (B, H, T) f32 from
// the forward; delta (B, H, T) f32 = rowsum(dout * o), written by
// attention_bwd_dq and read by attention_bwd_dkdv, which runs after it on the
// same stream. Each launches one kernel on `stream` and returns
// cudaGetLastError() (0 = launched).

// dq: like q.
extern "C" int attention_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                                long long bias_stride, const void* dout, const void* o,
                                const void* lse, void* delta, void* dq, int B, int H, int T,
                                int D, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != DH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == DTYPE_F32)
    return launch_dq<float>(q, k, v, bias, bias_stride, dout, o, l, d, dq, B, H, T, scale, s);
  if (dtype == DTYPE_BF16)
    return launch_dq<bf16>(q, k, v, bias, bias_stride, dout, o, l, d, dq, B, H, T, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dk, dv: like k; dbias: null, or (B*H, T) f32 per-head sums over queries.
extern "C" int attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* bias,
                                  long long bias_stride, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, void* dbias, int B,
                                  int H, int T, int D, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != DH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  float* db = static_cast<float*>(dbias);
  if (dtype == DTYPE_F32)
    return launch_dkdv<float>(q, k, v, bias, bias_stride, dout, l, d, dk, dv, db, B, H, T,
                              scale, s);
  if (dtype == DTYPE_BF16)
    return launch_dkdv<bf16>(q, k, v, bias, bias_stride, dout, l, d, dk, dv, db, B, H, T, scale,
                             s);
  return (int)cudaErrorInvalidValue;
}
