// Decoder self-attention forward, flash-style, for Hopper (sm_90a).
//
// Replaces the Pallas kernel matcha_tpu/ops/attention_pallas.py::_attn_kernel:
//   o = softmax(q k^T * scale + bias[b, None, :]) v        per (batch, head)
// with bias the raw (B, T) 0/1 key mask added to the logits (the diffusers
// quirk the reference keeps). The TPU kernel holds the whole (T, T) score tile
// in VMEM; at T = 1024 that is 4 MB of f32, far beyond the 227 KB of shared
// memory of an SM, so this kernel never forms it: one block per
// (64-query tile, batch*head) streams 64-key tiles of K and V through shared
// memory and keeps an online max and sum per query row in f32 registers.
//
// Bound: at the decoder's shapes (H = 4, D = 64, T <= 1024) the work is
// 4*B*H*T^2*D flops against 4*B*H*T*D elements of traffic, so it is bound by
// operations. Two paths, by dtype:
//
// bf16 with D = 64 (serving): both products on the tensor cores (mma.sync
// m16n8k16, f32 accumulators). 4 warps a block, 16 query rows a warp, held as
// A fragments in registers; each 64-key tile is staged as K [key][d] and V^T
// [d][key] in shared memory (rows padded by 8 bf16, so the 8 rows a fragment
// reads start 4 banks apart). The score fragments are rescaled, biased and
// exponentiated in registers and become, rounded to bf16, the A fragments of
// P V, as the TPU kernel rounds p to v's dtype.
//
// f32 (parity runs): f32 FMAs on the CUDA cores. 256 threads, 4 per
// query row. A thread holds its row of q in registers, scores 16 of the 64
// keys of a tile (keys sub + 4i), and owns 16 of the D output features as
// float4 groups 4*(sub + 4c). The 4 threads of a row are neighbouring lanes:
// row max and sum are two xor-shuffles, and each probability reaches the other
// three threads by a shuffle. Shared-memory strides are chosen so the 128-bit
// loads of a quarter-warp hit distinct banks.

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ bias, long long bias_stride, T* __restrict__ o, int H,
                int Tlen, float scale) {
  constexpr int KS = D + 4;      // K row stride in floats: keeps float4 alignment, spreads banks
  constexpr int KPT = BK / 4;    // keys scored per thread
  constexpr int G4 = D / 16;     // float4 output groups per thread
  __shared__ __align__(16) float ks[BK * KS];
  __shared__ __align__(16) float vs[BK * D];
  __shared__ float bs[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int row = tid >> 2, sub = tid & 3;
  const int lane = tid & 31;
  const int qi = blockIdx.x * BQ + row;
  const size_t base = (size_t)bh * Tlen * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = qi < Tlen ? to_f32(q[base + (size_t)qi * D + d]) : 0.f;

  float acc[G4][4];
#pragma unroll
  for (int c = 0; c < G4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Tlen; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Tlen) {
        kv = to_f32(k[base + (size_t)kj * D + d]);
        vv = to_f32(v[base + (size_t)kj * D + d]);
      }
      ks[j * KS + d] = kv;
      vs[j * D + d] = vv;
    }
    if (tid < BK) {
      const int kj = k0 + tid;
      bs[tid] = kj < Tlen ? (bias ? to_f32(bias[b * bias_stride + kj]) : 0.f) : -INFINITY;
    }
    __syncthreads();

    float s[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = sub + 4 * i;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * KS);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      s[i] = dot * scale + bs[j];
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      s[i] = expf(s[i] - m_new);  // keys past T carry -inf: p = 0
      psum += s[i];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < G4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;

#pragma unroll
    for (int i = 0; i < KPT; ++i) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[i], (lane & ~3) | src);
        const float4* vr = reinterpret_cast<const float4*>(vs + (src + 4 * i) * D);
#pragma unroll
        for (int c = 0; c < G4; ++c) {
          const float4 vv = vr[sub + 4 * c];
          acc[c][0] = fmaf(p, vv.x, acc[c][0]);
          acc[c][1] = fmaf(p, vv.y, acc[c][1]);
          acc[c][2] = fmaf(p, vv.z, acc[c][2]);
          acc[c][3] = fmaf(p, vv.w, acc[c][3]);
        }
      }
    }
  }

  if (qi < Tlen) {
    const float inv = 1.f / l;
    T* orow = o + base + (size_t)qi * D;
#pragma unroll
    for (int c = 0; c < G4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[4 * (sub + 4 * c) + e] = from_f32<T>(acc[c][e] * inv);
  }
}

// ---------------------------------------------------------------- bf16: tensor cores
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int DH = 64;          // head dim
constexpr int TQ = 64;          // queries a block, 16 a warp
constexpr int TK = 64;          // keys a tile
constexpr int WARPS = TQ / 16;
constexpr int KP = DH + 8;      // row stride of K in shared memory (bf16)
constexpr int VP = TK + 8;      // row stride of V^T in shared memory (bf16)

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

// Fragment layouts are those of mma.m16n8k16: lane = 4 * g + t holds rows g
// and g + 8 of A and C (columns 2t, 2t + 1, and 2t + 8, 2t + 9 of A), and
// column g, rows 2t, 2t + 1, 2t + 8, 2t + 9 of B.
__global__ void __launch_bounds__(WARPS * 32)
attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ bias,
                   long long bias_stride, bf16* __restrict__ o, int H, int Tlen, float scale) {
  __shared__ __align__(16) bf16 ks[TK * KP];  // [key][d]
  __shared__ __align__(16) bf16 vt[DH * VP];  // [d][key]
  __shared__ float bs[TK];

  const int bh = blockIdx.y, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * Tlen * DH;
  const int r0 = blockIdx.x * TQ + warp * 16 + g, r1 = r0 + 8;  // this lane's query rows

  uint32_t qa[DH / 16][4];  // the warp's 16 rows of q as A fragments
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    const int c = 16 * kc + 2 * t;
    qa[kc][0] = r0 < Tlen ? ld32(q + base + (size_t)r0 * DH + c) : 0u;
    qa[kc][1] = r1 < Tlen ? ld32(q + base + (size_t)r1 * DH + c) : 0u;
    qa[kc][2] = r0 < Tlen ? ld32(q + base + (size_t)r0 * DH + c + 8) : 0u;
    qa[kc][3] = r1 < Tlen ? ld32(q + base + (size_t)r1 * DH + c + 8) : 0u;
  }

  float acc[DH / 8][4];  // o rows g, g + 8; features 8 * nt + 2t, + 1
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Tlen; k0 += TK) {
    __syncthreads();  // the previous tile is consumed
    // lanes take consecutive keys: conflict-free stores to both layouts
    for (int idx = threadIdx.x; idx < TK * DH / 8; idx += blockDim.x) {
      const int j = idx % TK, d0 = (idx / TK) * 8, kj = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kj < Tlen) {
        kv = *reinterpret_cast<const uint4*>(k + base + (size_t)kj * DH + d0);
        vv = *reinterpret_cast<const uint4*>(v + base + (size_t)kj * DH + d0);
      }
      *reinterpret_cast<uint4*>(ks + j * KP + d0) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(d0 + e) * VP + j] = ve[e];
    }
    if (threadIdx.x < TK) {
      const int kj = k0 + threadIdx.x;
      bs[threadIdx.x] =
          kj < Tlen ? (bias ? to_f32(bias[b * bias_stride + kj]) : 0.f) : -INFINITY;
    }
    __syncthreads();

    float s[TK / 8][4];  // scores: rows g, g + 8; keys 8 * nt + 2t, + 1
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* kr = ks + (8 * nt + g) * KP + 2 * t;
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc)
        mma_bf16(s[nt], qa[kc], ld32(kr + 16 * kc), ld32(kr + 16 * kc + 8));
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      const float b0 = bs[8 * nt + 2 * t], b1 = bs[8 * nt + 2 * t + 1];
      s[nt][0] = s[nt][0] * scale + b0;  // keys past T carry -inf
      s[nt][1] = s[nt][1] * scale + b1;
      s[nt][2] = s[nt][2] * scale + b0;
      s[nt][3] = s[nt][3] * scale + b1;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);  // 0 on the first tile
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }

    // o += p v: score tiles 2kc and 2kc + 1 are the A fragment of keys 16kc..16kc+15
#pragma unroll
    for (int kc = 0; kc < TK / 16; ++kc) {
      const uint32_t pa[4] = {pack(s[2 * kc][0], s[2 * kc][1]), pack(s[2 * kc][2], s[2 * kc][3]),
                              pack(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        const bf16* vr = vt + (8 * nt + g) * VP + 16 * kc + 2 * t;
        mma_bf16(acc[nt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = 8 * nt + 2 * t;
    if (r0 < Tlen)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r0 * DH + c) =
          pack(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (r1 < Tlen)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r1 * DH + c) =
          pack(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

int launch(const void* q, const void* k, const void* v, const void* bias, long long bias_stride,
           void* o, int B, int H, int Tlen, float scale, cudaStream_t stream) {
  dim3 grid((Tlen + TQ - 1) / TQ, B * H);
  attn_fwd_tc_kernel<<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias), bias_stride, static_cast<bf16*>(o), H, Tlen, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

int launch_f32(const void* q, const void* k, const void* v, const void* bias,
               long long bias_stride, void* o, int B, int H, int Tlen, float scale,
               cudaStream_t stream) {
  dim3 grid((Tlen + BQ - 1) / BQ, B * H);
  attn_fwd_kernel<float, 64><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), bias_stride, static_cast<float*>(o), H, Tlen, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, T, 64) contiguous and 16-byte aligned, f32 or bf16
// (`dtype`); bias: null, or the (B, T) additive key bias in q's dtype, row b at
// bias + b * bias_stride elements, keys contiguous. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             long long bias_stride, void* o, int B, int H, int Tlen, int D,
                             float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tlen <= 0 || D != tc::DH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch_f32(q, k, v, bias, bias_stride, o, B, H, Tlen, scale, s);
  if (dtype == DTYPE_BF16)
    return tc::launch(q, k, v, bias, bias_stride, o, B, H, Tlen, scale, s);
  return (int)cudaErrorInvalidValue;
}
