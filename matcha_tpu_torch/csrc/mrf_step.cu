// One HiFi-GAN MRF dilation step, fused, for Hopper (sm_90a).
//
// Replaces the Pallas kernel matcha_tpu/ops/mrf_pallas.py::_mrf_kernel:
//   out = x + conv_k1(lrelu(conv_kd(lrelu(x)) + b1)) + b2,  lrelu slope 0.1,
// both convs 'same' with zero padding at the sequence edges. Layout is the
// port generator's channels-first (B, C, T), time contiguous. The weights of
// both convs come packed tap-major, (2, C_out, k, C_in) (`pack_weights` in
// ops/mrf.py, done once when the model's weights are loaded), so that a tap's
// input channels are contiguous.
//
// Unlike the TPU kernel (three shifted BlockSpec views, no kernel when T has
// no power-of-two tiling), a block here takes any T: it owns TT output frames
// and masks every absolute position outside [0, T) to zero. In shared memory:
//   ys = lrelu(x) over [t0 - H, t0 + TT + H)         (H = d*(k-1)/2 + (k-1)/2)
//   zs = lrelu(conv_kd(ys) + b1) over [t0 - h2, t0 + TT + h2), zero outside [0, T)
// then the dilation-1 conv, its bias and the residual are written for the tile.
// Only x is read from and out written to device memory: the intermediate
// activations of the step never leave the SM.
//
// Bound: 4*C^2*k flops per frame against 2*C elements of traffic, so the step
// is bound by operations at every stage of the generator. Two paths, by dtype:
//
// bf16 (serving): both convs are implicit GEMMs on the tensor cores
// (mma.sync m16n8k16, f32 accumulators): M = output channels, N = frames,
// K = taps x input channels, taken tap by tap. The activations sit in shared
// memory time-major ([frame][channel], rows padded by 8 so that the 8 rows of
// a fragment start 4 banks apart), so a B fragment is two 32-bit loads; with
// the weights tap-major an A fragment is four 32-bit loads from L2. lrelu(x)
// and z are held in bf16, as the tensor cores take them. A warp owns a 32-channel by
// 64-frame tile of each GEMM; a block has 8 warps and 64 * max(1, 256 / C)
// frames of z, so every stage of the generator gives each warp one tile.
//
// f32 (parity runs): f32 FMAs on the CUDA cores. A warp owns 8 output
// channels; its lanes walk time, each lane NPOS positions 32 apart, so a
// weight load is one broadcast per warp and the shared-memory reads of a warp
// are 32 consecutive floats.

#include "common.cuh"

namespace {

constexpr int CO_T = 8;          // output channels per warp
constexpr int MAX_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a Hopper block may use

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.1f * v; }

template <typename T, int K, int NPOS>
__global__ void __launch_bounds__(MAX_THREADS)
mrf_step_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out,
                int C, int Tlen, int dil) {
  // w1, w2: (C_out, K, C_in)
  constexpr int h2 = (K - 1) / 2;
  constexpr int LZ = 32 * NPOS;  // frames of z a block computes
  constexpr int TT = LZ - 2 * h2;  // output frames of a block
  const int h1 = dil * h2;
  const int Ly = LZ + 2 * h1;    // frames of lrelu(x) staged

  extern __shared__ __align__(16) float smem[];
  float* ys = smem;              // [C][Ly]
  float* zs = smem + C * Ly;     // [C][LZ] (+ 2*h2 floats of tail padding)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const T* xb = x + (size_t)b * C * Tlen;
  T* ob = out + (size_t)b * C * Tlen;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // stage lrelu(x), zero outside [0, T) (the first conv's 'same' padding)
  for (int idx = threadIdx.x; idx < C * Ly; idx += blockDim.x) {
    const int c = idx / Ly, u = idx - c * Ly;
    const int t = t0 - h1 - h2 + u;
    ys[idx] = (t >= 0 && t < Tlen) ? lrelu(to_f32(xb[(size_t)c * Tlen + t])) : 0.f;
  }
  if (threadIdx.x < 2 * h2) zs[C * LZ + threadIdx.x] = 0.f;
  __syncthreads();

  // z[u] at time t0 - h2 + u reads ys at u + j*dil for tap j
  for (int cg = warp; cg < C / CO_T; cg += nwarps) {
    const int co0 = cg * CO_T;
    float acc[CO_T][NPOS];
#pragma unroll
    for (int c = 0; c < CO_T; ++c)
#pragma unroll
      for (int p = 0; p < NPOS; ++p) acc[c][p] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float* yrow = ys + ci * Ly + lane;
      const T* wrow = w1 + (size_t)co0 * K * C + ci;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float yv[NPOS];
#pragma unroll
        for (int p = 0; p < NPOS; ++p) yv[p] = yrow[32 * p + j * dil];
#pragma unroll
        for (int c = 0; c < CO_T; ++c) {
          const float w = to_f32(wrow[((size_t)c * K + j) * C]);
#pragma unroll
          for (int p = 0; p < NPOS; ++p) acc[c][p] = fmaf(w, yv[p], acc[c][p]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CO_T; ++c) {
      const float bias = to_f32(b1[co0 + c]);
#pragma unroll
      for (int p = 0; p < NPOS; ++p) {
        const int u = lane + 32 * p;
        const int t = t0 - h2 + u;
        // zero outside [0, T): the second conv's 'same' padding (not lrelu(b1))
        zs[(co0 + c) * LZ + u] = (t >= 0 && t < Tlen) ? lrelu(acc[c][p] + bias) : 0.f;
      }
    }
  }
  __syncthreads();

  // out[t0 + v] = x + b2 + sum_j w2[.., j] z[v + j], v in [0, TT)
  for (int cg = warp; cg < C / CO_T; cg += nwarps) {
    const int co0 = cg * CO_T;
    float acc[CO_T][NPOS];
#pragma unroll
    for (int c = 0; c < CO_T; ++c)
#pragma unroll
      for (int p = 0; p < NPOS; ++p) acc[c][p] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
      const float* zrow = zs + ci * LZ + lane;
      const T* wrow = w2 + (size_t)co0 * K * C + ci;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float zv[NPOS];
#pragma unroll
        for (int p = 0; p < NPOS; ++p) zv[p] = zrow[32 * p + j];
#pragma unroll
        for (int c = 0; c < CO_T; ++c) {
          const float w = to_f32(wrow[((size_t)c * K + j) * C]);
#pragma unroll
          for (int p = 0; p < NPOS; ++p) acc[c][p] = fmaf(w, zv[p], acc[c][p]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CO_T; ++c) {
      const float bias = to_f32(b2[co0 + c]);
#pragma unroll
      for (int p = 0; p < NPOS; ++p) {
        const int vpos = lane + 32 * p;
        const int t = t0 + vpos;
        if (vpos < TT && t < Tlen) {
          const size_t off = (size_t)(co0 + c) * Tlen + t;
          ob[off] = from_f32<T>(to_f32(xb[off]) + acc[c][p] + bias);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- bf16: tensor cores
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int WM = 32;     // output channels of a warp tile (two m16 tiles)
constexpr int WN = 64;     // frames of a warp tile (eight n8 tiles)
constexpr int WARPS = 8;
constexpr int PAD = 8;     // bf16 past C in each shared-memory row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m16 tile][n8 tile] += sum over taps j and input channels ci of
//   w[co][j][ci] * src[(n + j * dil) * S + ci]
// for co in [co0, co0 + 32) and n in [n0, n0 + 64). Fragment layouts are
// those of mma.m16n8k16: lane = 4 * g + t holds A rows g and g + 8, columns
// 2t, 2t + 1, 2t + 8, 2t + 9; B columns (frames) g, rows 2t, 2t + 1, 2t + 8, 2t + 9.
template <int K>
__device__ __forceinline__ void warp_conv(float (&acc)[2][8][4], const bf16* __restrict__ w,
                                          const bf16* src, int C, int S, int co0, int n0,
                                          int dil) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_u32 = K * C / 2;  // one output channel of w, in 32-bit words
  const uint32_t* wr0 = reinterpret_cast<const uint32_t*>(w) + (size_t)(co0 + g) * row_u32 + t;
  const uint32_t* wr1 = wr0 + (size_t)16 * row_u32;
  const size_t w8 = (size_t)8 * row_u32;
#pragma unroll 1
  for (int j = 0; j < K; ++j) {
    const uint32_t* sr =
        reinterpret_cast<const uint32_t*>(src + (size_t)(n0 + g + j * dil) * S) + t;
    const int wj = j * C / 2;
#pragma unroll 2
    for (int c2 = 0; c2 < C / 2; c2 += 8) {  // 16 input channels
      uint32_t a[2][4];
      const uint32_t* p0 = wr0 + wj + c2;
      const uint32_t* p1 = wr1 + wj + c2;
      a[0][0] = __ldg(p0);
      a[0][1] = __ldg(p0 + w8);
      a[0][2] = __ldg(p0 + 4);
      a[0][3] = __ldg(p0 + w8 + 4);
      a[1][0] = __ldg(p1);
      a[1][1] = __ldg(p1 + w8);
      a[1][2] = __ldg(p1 + 4);
      a[1][3] = __ldg(p1 + w8 + 4);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const uint32_t* q = sr + (size_t)ni * 4 * S + c2;  // 8 frames further
        const uint32_t b0 = q[0], b1 = q[4];
        mma_bf16(acc[0][ni], a[0], b0, b1);
        mma_bf16(acc[1][ni], a[1], b0, b1);
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32, 2)
mrf_step_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1p,
                   const bf16* __restrict__ b1, const bf16* __restrict__ w2p,
                   const bf16* __restrict__ b2, bf16* __restrict__ out, int C, int Tlen, int dil,
                   int LZ) {
  constexpr int h2 = (K - 1) / 2;
  const int h1 = dil * h2, S = C + PAD;
  const int Ly = LZ + 2 * h1, TT = LZ - 2 * h2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [Ly][S]: lrelu(x) over the tile + halo
  bf16* zs = ys + (size_t)Ly * S;                // [LZ + 2*h2][S]: z, zero tail rows

  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const bf16* xb = x + (size_t)b * C * Tlen;
  bf16* ob = out + (size_t)b * C * Tlen;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;

  // ys row u is frame t0 - h1 - h2 + u; zero outside [0, T) (the first conv's padding)
  for (int idx = threadIdx.x; idx < C * Ly; idx += blockDim.x) {
    const int c = idx / Ly, u = idx - c * Ly, tt = t0 - h1 - h2 + u;
    const float v = (tt >= 0 && tt < Tlen) ? lrelu(to_f32(xb[(size_t)c * Tlen + tt])) : 0.f;
    ys[(size_t)u * S + c] = __float2bfloat16(v);
  }
  for (int idx = threadIdx.x; idx < 2 * h2 * S; idx += blockDim.x)
    zs[(size_t)LZ * S + idx] = __float2bfloat16(0.f);
  __syncthreads();

  const int groups = C / WM, items = groups * (LZ / WN);
  // z row u is frame t0 - h2 + u and reads ys rows u + j * dil
  for (int it = warp; it < items; it += WARPS) {
    const int co0 = (it % groups) * WM, n0 = (it / groups) * WN;
    float acc[2][8][4] = {};
    warp_conv<K>(acc, w1p, ys, C, S, co0, n0, dil);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = co0 + 16 * mi + g + 8 * (e >> 1), n = n0 + 8 * ni + 2 * t + (e & 1);
          const int tt = t0 - h2 + n;
          // zero outside [0, T): the second conv's 'same' padding (not lrelu(b1))
          const float v =
              (tt >= 0 && tt < Tlen) ? lrelu(acc[mi][ni][e] + to_f32(b1[co])) : 0.f;
          zs[(size_t)n * S + co] = __float2bfloat16(v);
        }
  }
  __syncthreads();

  // out frame t0 + v reads zs rows v + j
  for (int it = warp; it < items; it += WARPS) {
    const int co0 = (it % groups) * WM, n0 = (it / groups) * WN;
    float acc[2][8][4] = {};
    warp_conv<K>(acc, w2p, zs, C, S, co0, n0, 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = co0 + 16 * mi + g + 8 * (e >> 1), n = n0 + 8 * ni + 2 * t + (e & 1);
          const int tt = t0 + n;
          if (n < TT && tt < Tlen) {
            const size_t off = (size_t)co * Tlen + tt;
            ob[off] = __float2bfloat16(to_f32(xb[off]) + acc[mi][ni][e] + to_f32(b2[co]));
          }
        }
  }
}

template <int K>
int launch(const void* x, const void* wp, const void* b1, const void* b2, void* out, int B,
           int C, int Tlen, int dil, cudaStream_t stream) {
  if (C % WM != 0) return (int)cudaErrorInvalidValue;
  const int LZ = WN * (C >= 256 ? 1 : 256 / C);
  const int h2 = (K - 1) / 2;
  const size_t smem = sizeof(bf16) * (size_t)(C + PAD) * (2 * LZ + 2 * dil * h2 + 2 * h2);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = mrf_step_tc_kernel<K>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bf16* p = static_cast<const bf16*>(wp);
  const size_t n = (size_t)C * C * K;
  const int tt = LZ - 2 * h2;
  dim3 grid((Tlen + tt - 1) / tt, B);
  kern<<<grid, WARPS * 32, smem, stream>>>(static_cast<const bf16*>(x), p,
                                           static_cast<const bf16*>(b1), p + n,
                                           static_cast<const bf16*>(b2), static_cast<bf16*>(out),
                                           C, Tlen, dil, LZ);
  return (int)cudaGetLastError();
}

}  // namespace tc

inline size_t smem_bytes(int C, int K, int dil, int npos) {
  const int lz = 32 * npos;
  const int h2 = (K - 1) / 2;
  return sizeof(float) * ((size_t)C * (lz + 2 * dil * h2) + (size_t)C * lz + 2 * h2);
}

template <typename T, int K, int NPOS>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int B, int C, int Tlen, int dil, cudaStream_t stream) {
  // w1, w2: (C_out, K, C_in) each
  auto kern = mrf_step_kernel<T, K, NPOS>;
  const size_t smem = smem_bytes(C, K, dil, NPOS);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tt = 32 * NPOS - (K - 1);
  const int threads = (C / CO_T) * 32 < MAX_THREADS ? (C / CO_T) * 32 : MAX_THREADS;
  dim3 grid((Tlen + tt - 1) / tt, B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), C, Tlen, dil);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int pick_tile(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              void* out, int B, int C, int Tlen, int dil, cudaStream_t stream) {
  // the widest time tile whose two buffers fit the shared memory of a block
  if (smem_bytes(C, K, dil, 8) <= SMEM_LIMIT)
    return launch<T, K, 8>(x, w1, b1, w2, b2, out, B, C, Tlen, dil, stream);
  if (smem_bytes(C, K, dil, 4) <= SMEM_LIMIT)
    return launch<T, K, 4>(x, w1, b1, w2, b2, out, B, C, Tlen, dil, stream);
  if (smem_bytes(C, K, dil, 2) <= SMEM_LIMIT)
    return launch<T, K, 2>(x, w1, b1, w2, b2, out, B, C, Tlen, dil, stream);
  return (int)cudaErrorInvalidValue;
}

template <int K>
int dispatch(const void* x, const void* wp, const void* b1, const void* b2, void* out, int B,
             int C, int Tlen, int dil, int dtype, cudaStream_t stream) {
  if (dtype == DTYPE_BF16) return tc::launch<K>(x, wp, b1, b2, out, B, C, Tlen, dil, stream);
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(wp);
  return pick_tile<float, K>(x, w, b1, w + (size_t)C * C * K, b2, out, B, C, Tlen, dil, stream);
}

}  // namespace

// x, out: (B, C, T) contiguous; wp: both convs' weights tap-major, (2, C, K, C)
// contiguous; b1, b2: (C,); all of one dtype, f32 or bf16 (`dtype`). C must
// be a multiple of 32 and K one of 3, 7, 11. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int mrf_step(const void* x, const void* wp, const void* b1, const void* b2, void* out,
                        int B, int C, int Tlen, int K, int dil, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || C % tc::WM != 0 || Tlen <= 0 || dil <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 3: return dispatch<3>(x, wp, b1, b2, out, B, C, Tlen, dil, dtype, s);
    case 7: return dispatch<7>(x, wp, b1, b2, out, B, C, Tlen, dil, dtype, s);
    case 11: return dispatch<11>(x, wp, b1, b2, out, B, C, Tlen, dil, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
