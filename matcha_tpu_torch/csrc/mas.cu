// Monotonic alignment search for Hopper (sm_90a): K3a (the forward DP) and K3b
// (the walk back) fused into one launch per alignment.
//
// Replaces the Pallas kernels matcha_tpu/ops/mas_pallas.py::_forward_kernel and
// ::_backward_kernel, and the three PyTorch kernels around them (the masked
// product, its transposed copy, the output's product with the mask). The DP is
// the reference's banded Viterbi recursion over mel frames y
// (matcha_tpu/ops/mas_ref.py):
//   from_prev = x == 0 ? (y == 0 ? 0 : NEG) : dp[x-1]
//   from_same = (x == y || y == 0) ? NEG : dp[x]
//   take      = from_prev >= from_same || x == y
//   dp[x]     = in_band(x, y) ? (take ? from_prev : from_same) + score[y][x] : NEG
// with NEG = -1e9 and every value f32, so the path is bit-equal to the
// reference's. The one addition is written __fadd_rn: nothing may fuse it.
// score = value * mask as PyTorch forms it: in f32, rounded to bf16 only when
// both operands are bf16 (exact in f32: a product of two bf16 values has at
// most 16 significant bits), then taken to f32.
//
// What bounds it. Neither bytes nor operations: every frame of an utterance
// depends on the one before, so a call takes at least max_b(t_y) dependent
// steps of the recursion, a max and an add each (the latency L that
// mas_chain_probe measures on one thread). This design's step also carries a
// shuffle, so it is slower than L. The TPU kernels run that chain over (B, Tx)
// vector rows, all utterances in lock step, with a second grid for the walk
// back. Here one block takes one utterance, and the design keeps everything
// but the chain off the chain:
//
// - The DP runs on one warp, no block barrier per frame. Lane l owns the K
//   text positions l K .. l K + K - 1 (K = cells, a power of two with 32 K >=
//   Tx) in registers; a frame costs one __shfl_up_sync (lane l - 1's last
//   cell) and K cell updates, and cell j's __ballot_sync is word j of the
//   frame, whose bit l is position l K + j. Lanes past Tx stay in every
//   shuffle and ballot, their cells NEG and out of band. The shuffle of the
//   last cell is issued as soon as that cell is updated and the next frame's
//   scores are loaded a frame ahead, so neither waits on the chain; the
//   frame loop is unrolled by 8 (faster than 4, 2 or 1 on the card; PERF.md).
// - The scores are in shared memory ahead of the chain. The other 7 warps are
//   producers: they read `value` and `mask` in their own (B, Tx, Ty) layout,
//   4 frames of a text row at a time (16 or 8 bytes) where Ty and the
//   pointers allow and element by element otherwise, form the products in
//   registers and store them, chunk of F frames by chunk (F <= 64, a chunk
//   one load batch a thread), into a ring of stages guarded by full and empty
//   mbarriers. A stage is [F + 1][32 K] f32, a frame's row in the DP lanes'
//   order (and a spare row for the DP's look-ahead), so a lane reads its K
//   scores with 8- or 16-byte loads; for K >= 8 the 16-byte pieces of a lane
//   are XOR-swizzled with the lane so that 8 lanes of a phase hit distinct
//   banks, and the producers, one text row a lane, store a permutation of 32
//   consecutive words. The DP warp waits on device memory only for the first
//   chunk.
// - The decisions never leave shared memory: Ty x K words (3.5 KB at Tx = 64,
//   Ty = 448; 128 KB at Tx = Ty = 1024).
// - The producers also write the (Tx, Ty) output's zeros, a slice after each
//   chunk is handed over, 16 bytes a store where Tx Ty elt allows. After a
//   block barrier warp 0 walks the path back from the decisions into a shared
//   index per frame, 32 frames a round: each lane cuts its frame's decisions
//   to a 32-bit mask of the steps from the 32 indices the round can reach,
//   and the round's 32 steps are then a shift, a mask and an add each (see
//   walk_back). After a second barrier the block writes the t_y path cells,
//   mask[b, x, y] in value's dtype (what (path * mask).to(dtype) gives).
//   Every element of the output is written.
//
// Departure from a copy-engine design: the producers use plain loads, not
// cp.async or bulk copies. The stage layout is a transpose of the global one
// (text positions interleaved across lanes, frames as rows), which a copy
// engine cannot write, and forming the product in the producer leaves the
// DP warp's issue slots to the chain. The price: a load instruction of 32
// lanes touches 32 rows.
//
// Optional bits_out (the checks only): the take-diagonal decisions in K3a's
// former layout, (B, Ty, ceil(Tx/32)) int32, bit i of word w = text position
// 32 w + i, frames at or past t_y unwritten.
//
// The plan (cells, frames, stages) comes from ops/mas.py::mas_plan, which the
// CPU tests check; the entry refuses a plan that does not fit.

#include <type_traits>

#include "tensor_core.cuh"

namespace {

using namespace tc;
typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PRODUCERS = 7;                  // warps 1..7; warp 0 runs the DP
constexpr int THREADS = (PRODUCERS + 1) * 32;
constexpr int PTHREADS = PRODUCERS * 32;
constexpr int BATCH = 10;  // (row, 4 frames) items a producer loads at once; ops/mas.py's
                           // mas_plan keeps a chunk within BATCH x PTHREADS items
constexpr int SMEM_LIMIT = 232448;            // bytes of shared memory a Hopper block may use

// Shared memory of a plan, as ops/mas.py::_smem_bytes computes it: the ring,
// two mbarriers a stage, the decisions, the path's index per frame.
struct Plan {
  int frames, stages;
  size_t stage_floats, ring_bytes, bar_bytes, dec_bytes, idx_bytes;
  __host__ __device__ Plan(int K, int F, int S, int Ty) : frames(F), stages(S) {
    stage_floats = (size_t)(F + 1) * 32 * K;  // F frames' rows and a spare one
    ring_bytes = (size_t)S * stage_floats * 4;
    bar_bytes = (size_t)16 * S;
    dec_bytes = (size_t)Ty * K * 4;
    idx_bytes = (size_t)Ty * 4;
  }
  __host__ __device__ size_t smem() const { return ring_bytes + bar_bytes + dec_bytes + idx_bytes; }
};

// Where text position x sits in a frame's row of a stage: lane x / K, cell
// x % K; the lane's 16-byte pieces swizzled for K >= 8 (see the header).
template <int K>
__device__ __forceinline__ int slot(int x) {
  if constexpr (K < 8) {
    return x;
  } else {
    constexpr int Q = K / 4;  // 16-byte pieces a lane
    const int l = x / K, j = x % K;
    const int sw = (l * Q / 8) % Q;
    return l * K + ((((j >> 2) ^ sw)) << 2) + (j & 3);
  }
}

template <int K>
__device__ __forceinline__ int piece(int lane, int q) {  // swizzled piece q of a lane
  if constexpr (K < 8) {
    return q;
  } else {
    constexpr int Q = K / 4;
    return q ^ ((lane * Q / 8) % Q);
  }
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// 4 consecutive elements from p (16 or 8 bytes, aligned) as f32
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&o)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = __uint_as_float(v.x << 16), o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16), o[3] = __uint_as_float(v.y & 0xffff0000u);
}
// the first n (< 4 allowed) elements, one at a time
template <typename T>
__device__ __forceinline__ void load4_scalar(const T* p, int n, float (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = i < n ? f32(p[i]) : 0.f;
}

// value * mask as PyTorch's `value * mask` forms it, taken to f32
template <typename TV, typename TM>
__device__ __forceinline__ float score(float v, float m) {
  const float p = __fmul_rn(v, m);
  if constexpr (std::is_same<TV, bf16>::value && std::is_same<TM, bf16>::value)
    return __bfloat162float(__float2bfloat16_rn(p));
  else
    return p;
}

struct Args {
  const void* value;
  const void* mask;
  const int* t_x;
  const int* t_y;
  void* out;
  uint32_t* bits;
  int Tx, Ty, vdt, mdt, vec, vec_out;
};

// Zero slice `s` of `n` of the utterance's output (16-byte stores where the
// whole output allows them).
__device__ __forceinline__ void zero_slice(const Args& a, int b, int s, int n, int t) {
  const int eo = a.vdt == DTYPE_BF16 ? 2 : 4;
  const size_t bytes = (size_t)a.Tx * a.Ty * eo;
  unsigned char* o = static_cast<unsigned char*>(a.out) + (size_t)b * bytes;
  if (a.vec_out) {
    const size_t units = bytes / 16, lo = units * s / n, hi = units * (s + 1) / n;
    for (size_t i = lo + t; i < hi; i += PTHREADS)
      reinterpret_cast<uint4*>(o)[i] = make_uint4(0, 0, 0, 0);
  } else {
    const size_t elts = bytes / eo, lo = elts * s / n, hi = elts * (s + 1) / n;
    for (size_t i = lo + t; i < hi; i += PTHREADS) {
      if (eo == 4)
        reinterpret_cast<uint32_t*>(o)[i] = 0u;
      else
        reinterpret_cast<uint16_t*>(o)[i] = 0;
    }
  }
}

// The producer warps: chunk c (frames [c F, c F + F)) of every text row below
// min(t_x, Tx) into stage c % S, as products in the DP's layout, once the DP
// warp has released the chunk that stage held; then a slice of the zeros.
template <int K, typename TV, typename TM>
__device__ void produce(const Args& a, const Plan& p, float* ring, uint32_t full, uint32_t empty,
                        int b, int txr, int ny, int nchunks) {
  const int t = threadIdx.x - 32;
  const TV* value = static_cast<const TV*>(a.value) + (size_t)b * a.Tx * a.Ty;
  const TM* mask = static_cast<const TM*>(a.mask) + (size_t)b * a.Tx * a.Ty;
  const int F = p.frames, G = F / 4;  // 4-frame groups a chunk
  const int row = 32 * K, shift = 31 - __clz(row);
  const int items = row * G;  // item i: text row i % row, group i / row (powers of two)
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % p.stages, y0 = c * F, nf = min(F, ny - y0);
    float* st = ring + (size_t)s * p.stage_floats;
    for (int i0 = 0; i0 < items; i0 += BATCH * PTHREADS) {
      float v[BATCH][4], m[BATCH][4];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = i0 + k * PTHREADS + t;
        const int x = i & (row - 1), f = 4 * (i >> shift);
        if (i < items && f < nf && x < txr) {
          const size_t off = (size_t)x * a.Ty + y0 + f;
          if (a.vec) {
            load4(value + off, v[k]);
            load4(mask + off, m[k]);
          } else {
            load4_scalar(value + off, nf - f, v[k]);
            load4_scalar(mask + off, nf - f, m[k]);
          }
        }
      }
      if (i0 == 0 && c >= p.stages) mbar_wait(empty + 8 * s, ((c / p.stages) - 1) & 1);
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = i0 + k * PTHREADS + t;
        const int x = i & (row - 1), f = 4 * (i >> shift);
        if (i < items && f < nf && x < txr) {
          float* d = st + (size_t)f * row + slot<K>(x);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (f + q < nf) d[(size_t)q * row] = score<TV, TM>(v[k][q], m[k][q]);
        }
      }
    }
    mbar_arrive(full + 8 * s);
    zero_slice(a, b, c, nchunks, t);  // off the DP's way: after the chunk is handed over
  }
  if (nchunks == 0) zero_slice(a, b, 0, 1, t);
}

// A lane's K scores of one frame's row of a stage (r = the row + lane K)
template <int K>
__device__ __forceinline__ void load_scores(float (&sc)[K], const float* r, int lane) {
  if constexpr (K == 1) {
    sc[0] = r[0];
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(r);
    sc[0] = v.x, sc[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(r + 4 * piece<K>(lane, q));
      sc[4 * q] = v.x, sc[4 * q + 1] = v.y, sc[4 * q + 2] = v.z, sc[4 * q + 3] = v.w;
    }
  }
}

// The DP warp: frames [0, ny) in order, K cells a lane, decisions to `dec`.
// Off the chain: the next frame's scores are loaded a frame ahead (a stage
// has one spare row, so a chunk's last look-ahead reads nothing that
// matters), the shuffle of the last cell is issued as soon as that cell is
// updated, so its latency overlaps the lane's other cells, and every lane
// stores the frame's words (the same words to the same addresses: no branch).
template <int K>
__device__ void dp_chain(const Plan& p, const float* ring, uint32_t full, uint32_t empty,
                         uint32_t* dec, int tx, int ty, int txr, int ny) {
  constexpr int row = 32 * K;
  const int lane = threadIdx.x, x0 = lane * K;
  const int hmax = txr - x0, lmin = -x0;
  float dp[K], sc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) dp[j] = NEG;
  float left = lane == 0 ? 0.f : NEG;  // from_prev of the lane's first cell, frame 0
  uint32_t* o = dec;
  // band [max(0, tx + y - ty), min(txr, y + 1)) and diagonal y, relative to x0
  int lo = tx - ty - x0, hi = 1 - x0, d = -x0;
  for (int k = 0, y0 = 0; y0 < ny; ++k, y0 += p.frames) {
    const int s = k % p.stages, nf = min(p.frames, ny - y0);
    mbar_wait(full + 8 * s, (k / p.stages) & 1);
    const float* r = ring + (size_t)s * p.stage_floats + x0;
    load_scores<K>(sc, r, lane);
#pragma unroll 8
    for (int f = 0; f < nf; ++f) {
      r += row;
      float nx[K];
      load_scores<K>(nx, r, lane);
      const int l = max(lo, lmin), h = min(hi, hmax);
      uint32_t w[K];
      float left_next;
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {  // descending: dp[j - 1] is still the last frame's
        const float fp = j == 0 ? left : dp[j - 1];
        const bool diag = j == d;
        const float fs = diag ? NEG : dp[j];
        const bool take = fp >= fs || diag;
        dp[j] = j >= l && j < h ? __fadd_rn(take ? fp : fs, sc[j]) : NEG;
        if (j == K - 1) left_next = __shfl_up_sync(FULL, dp[K - 1], 1);  // position x0 - 1
        w[j] = __ballot_sync(FULL, take);
      }
      left = lane == 0 ? NEG : left_next;
      if constexpr (K >= 4) {
#pragma unroll
        for (int q = 0; q < K / 4; ++q)
          reinterpret_cast<uint4*>(o)[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
      } else if constexpr (K == 2) {
        *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
      } else {
        o[0] = w[0];
      }
      o += K;
      ++lo, ++hi, ++d;
#pragma unroll
      for (int j = 0; j < K; ++j) sc[j] = nx[j];
    }
    mbar_arrive(empty + 8 * s);
  }
}

// Bit r of the result is bit base - r of the 64-bit row t (0 outside [0, 64))
__device__ __forceinline__ uint32_t window(uint64_t t, int base) {
  if (base < 0) return 0u;
  const uint64_t s = base <= 63 ? t << (63 - base) : (base < 127 ? t >> (base - 63) : 0ull);
  return __brev(static_cast<uint32_t>(s >> 32));
}

// w's bit i at bit 2 i
__device__ __forceinline__ uint64_t spread(uint32_t w) {
  uint64_t x = w;
  x = (x | (x << 16)) & 0x0000ffff0000ffffull;
  x = (x | (x << 8)) & 0x00ff00ff00ff00ffull;
  x = (x | (x << 4)) & 0x0f0f0f0f0f0f0f0full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  return (x | (x << 1)) & 0x5555555555555555ull;
}

// Bit r: take-diagonal at text position base - r of the frame whose K words
// are w, 0 where base - r is outside [0, Tx). For K <= 2 the frame is one
// 64-bit row in position order (the K words interleaved), cut by shifts.
template <int K>
__device__ __forceinline__ uint32_t take_window(const uint32_t* w, int base, int Tx) {
  uint32_t take = 0;
  if constexpr (K == 1) {
    take = window(w[0], base);
  } else if constexpr (K == 2) {
    take = window(spread(w[0]) | (spread(w[1]) << 1), base);
  } else {
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const int x = base - r;
      if (x >= 0 && x < Tx) take |= ((w[x & (K - 1)] >> (x / K)) & 1u) << r;
    }
  }
  const int lo = base - Tx + 1;  // x < Tx where r >= lo
  return take & (lo <= 0 ? ~0u : lo >= 32 ? 0u : ~0u << lo);
}

// The walk back on warp 0, 32 frames a round. At the round's top frame the
// index is `base`, so lane i's frame, top - i, has an index in [base - i,
// base]. Each lane first reduces its frame to a 32-bit mask, bit r = whether
// the reference's walk steps down there from index base - r; the masks go
// through `scratch` (32 words of the ring, free after the DP) to every lane,
// which runs the round's 32 steps, a shift, a mask and an add each, and keeps
// the index of its own frame.
template <int K>
__device__ void walk_back(const uint32_t* dec, int* sidx, uint32_t* scratch, int tx, int ny,
                          int Tx) {
  const int lane = threadIdx.x;
  int base = tx - 1;
  for (int top = ny - 1; top >= 0; top -= 32) {
    const int y = top - lane;
    uint32_t m = 0;
    if (y > 0) {  // steps where x > 0 and (x == y or take-diagonal at x)
      const uint32_t keep = base >= 32 ? ~0u : base > 0 ? (1u << base) - 1 : 0u;
      const int rd = base - y;
      const uint32_t diag = rd >= 0 && rd < 32 ? 1u << rd : 0u;
      m = (take_window<K>(dec + (size_t)y * K, base, Tx) | diag) & keep;
    }
    scratch[lane] = m;
    __syncwarp();
    uint32_t mm[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(scratch)[q];
      mm[4 * q] = v.x, mm[4 * q + 1] = v.y, mm[4 * q + 2] = v.z, mm[4 * q + 3] = v.w;
    }
    __syncwarp();
    int rel = 0, mine = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      mine = lane == i ? rel : mine;
      rel += (mm[i] >> rel) & 1u;
    }
    if (y >= 0) sidx[y] = base - mine;
    base -= rel;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 1) mas_path_kernel(Args a, int frames, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p(K, frames, stages, a.Ty);
  float* ring = reinterpret_cast<float*>(smem);
  const uint32_t full = smem_u32(smem + p.ring_bytes), empty = full + 8 * p.stages;
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem + p.ring_bytes + p.bar_bytes);
  int* sidx = reinterpret_cast<int*>(smem + p.ring_bytes + p.bar_bytes + p.dec_bytes);

  const int b = blockIdx.x;
  const int tx = a.t_x[b], ty = a.t_y[b];
  const int ny = max(0, min(ty, a.Ty));     // frames visited
  const int txr = max(0, min(tx, a.Tx));    // text rows that can be in band
  const int nchunks = (ny + p.frames - 1) / p.frames;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + 8 * i, PTHREADS);
      mbar_init(empty + 8 * i, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    dp_chain<K>(p, ring, full, empty, dec, tx, ty, txr, ny);
  } else {
    switch (a.vdt * 2 + a.mdt) {
      case 0: produce<K, float, float>(a, p, ring, full, empty, b, txr, ny, nchunks); break;
      case 1: produce<K, float, bf16>(a, p, ring, full, empty, b, txr, ny, nchunks); break;
      case 2: produce<K, bf16, float>(a, p, ring, full, empty, b, txr, ny, nchunks); break;
      default: produce<K, bf16, bf16>(a, p, ring, full, empty, b, txr, ny, nchunks); break;
    }
  }
  __syncthreads();  // decisions complete, zeros written

  if (threadIdx.x < 32) {
    walk_back<K>(dec, sidx, reinterpret_cast<uint32_t*>(smem), tx, ny, a.Tx);
  }
  if (a.bits) {  // the decisions in K3a's former layout, for the checks
    const int W = (a.Tx + 31) / 32;
    uint32_t* o = a.bits + (size_t)b * a.Ty * W;
    for (int i = threadIdx.x; i < ny * W; i += THREADS) {
      const int y = i / W, w = i % W;
      uint32_t word = 0;
      for (int k = 0; k < 32; ++k) {
        const int x = 32 * w + k;
        word |= ((dec[(size_t)y * K + (x & (K - 1))] >> (x / K)) & 1u) << k;
      }
      o[i] = word;
    }
  }
  __syncthreads();

  const size_t base = (size_t)b * a.Tx * a.Ty;
  for (int y = threadIdx.x; y < ny; y += THREADS) {
    const int x = sidx[y];
    if (x < 0 || x >= a.Tx) continue;
    const size_t i = base + (size_t)x * a.Ty + y;
    const float m = a.mdt == DTYPE_BF16 ? f32(static_cast<const bf16*>(a.mask)[i])
                                        : static_cast<const float*>(a.mask)[i];
    if (a.vdt == DTYPE_BF16)
      static_cast<bf16*>(a.out)[i] = __float2bfloat16_rn(m);
    else
      static_cast<float*>(a.out)[i] = m;
  }
}

// One thread, `steps` dependent steps of the recursion on a cell and its left
// neighbour: dp[x] = max(dp[x - 1], dp[x]) + score, the least a frame needs
// whatever the design. Its time over steps is L, the chain's latency.
__global__ void mas_chain_probe_kernel(float* out, float sc, int steps) {
  float left = sc, dp = 2.f * sc;
#pragma unroll 8
  for (int i = 0; i < steps; ++i) {
    dp = __fadd_rn(fmaxf(left, dp), sc);
    left = __fadd_rn(left, sc);
  }
  out[0] = dp;
}

template <int K>
int launch(const Args& a, int B, int frames, int stages, cudaStream_t stream) {
  const size_t smem = Plan(K, frames, stages, a.Ty).smem();
  static int attr = 0;  // the dynamic shared memory this instantiation may use
  if ((int)smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_path_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = (int)smem;
  }
  mas_path_kernel<K><<<B, THREADS, smem, stream>>>(a, frames, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// value, mask: (B, Tx, Ty) contiguous, dtype codes vdt, mdt (common.cuh); t_x,
// t_y: (B,) int32; out: (B, Tx, Ty) in value's dtype, every element written;
// bits: null, or (B, Ty, ceil(Tx/32)) int32 (see the header). The plan (cells,
// frames, stages) is ops/mas.py::mas_plan's. Tx <= 1024. Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
extern "C" int mas_path(const void* value, const void* mask, const void* t_x, const void* t_y,
                        void* out, void* bits, int B, int Tx, int Ty, int vdt, int mdt, int cells,
                        int frames, int stages, void* stream) {
  if (B <= 0 || Ty <= 0 || Tx <= 0 || Tx > 1024 || 32 * cells < Tx || frames <= 0 ||
      frames % 4 || stages < 2 || stages > 4 || (vdt != DTYPE_F32 && vdt != DTYPE_BF16) ||
      (mdt != DTYPE_F32 && mdt != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  if (Plan(cells, frames, stages, Ty).smem() > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int ev = vdt == DTYPE_BF16 ? 2 : 4, em = mdt == DTYPE_BF16 ? 2 : 4;
  Args a{value, mask, static_cast<const int*>(t_x), static_cast<const int*>(t_y), out,
         static_cast<uint32_t*>(bits), Tx, Ty, vdt, mdt, 0, 0};
  a.vec = Ty % 4 == 0 && reinterpret_cast<uintptr_t>(value) % (4 * ev) == 0 &&
          reinterpret_cast<uintptr_t>(mask) % (4 * em) == 0;
  a.vec_out = ((size_t)Tx * Ty * ev) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cells) {
    case 1: return launch<1>(a, B, frames, stages, s);
    case 2: return launch<2>(a, B, frames, stages, s);
    case 4: return launch<4>(a, B, frames, stages, s);
    case 8: return launch<8>(a, B, frames, stages, s);
    case 16: return launch<16>(a, B, frames, stages, s);
    case 32: return launch<32>(a, B, frames, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: 1 float. Launches the chain probe (one thread, `steps` steps) on `stream`.
extern "C" int mas_chain_probe(void* out, int steps, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  mas_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), 0.5f, steps);
  return (int)cudaGetLastError();
}
