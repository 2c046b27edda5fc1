// One HiFi-GAN MRF dilation step, fused, for Hopper (sm_90a): kernel K2.
//
// Replaces the Pallas kernel matcha_tpu/ops/mrf_pallas.py::_mrf_kernel:
//   out = x + conv_k1(lrelu(conv_kd(lrelu(x)) + b1)) + b2,  lrelu slope 0.1,
// both convs 'same' with zero padding at the sequence edges, z zero (not
// lrelu(b1)) outside [0, T). Layout is the port generator's channels-first
// (B, C, T), time contiguous; both convs' weights come packed once per load
// by ops/mrf.py::pack_weights, in the order the kernel streams them.
//
// What bounds it. A step does 4 C^2 k flops a frame and moves 4 C bytes a
// frame in bf16: C k flops a byte against the ~295 at which the H100's bf16
// tensor cores and its memory balance. C >= 128, and k = 11 at every C, are
// bound by operations; C = 64 at k = 3 and C = 32 at k <= 7 by bytes. Every
// block also reads both convs' weights from L2 (2 x 1.44 MB at C = 256,
// k = 11).
//
// The design. One block per (time tile, batch row), any T: 8 compute warps
// and one producer warp. Each conv is an implicit GEMM with frames as M and
// output channels as N, contracted tap by tap over the input channels:
//   z^T[n, co]   = sum_{j, ci} y[n + j d, ci] W1[co, j, ci]   (n < LZ)
//   out^T[v, co] = sum_{j, ci} z[v + j, ci]   W2[co, j, ci]   (v < TT)
// Shared memory holds, in the tensor cores' core-matrix layout (16 bytes of
// channels a row, [channel group][frame][16 B], so that 8 consecutive frames
// are one contiguous 128-byte core matrix wherever they start: a tap's shift
// of j d frames, any integer, moves the start address and nothing else):
//   xs [C/8][LZ + 2 h1]  lrelu(x) over the tile and its halo, zero outside [0, T)
//   zs [C/8][LZ + 2 h2]  z, zero past the tile
//   xr [C][TT]           x over the tile, raw, in the global layout: the
//                        residual, then the output, stored 16 bytes at a time
//   ring [NS][CB/16][C]  weight chunks: CB bytes of every output channel's
//                        (tap, C_in) row (the last chunk of a conv may hold
//                        less), in the same core-matrix layout.
// pack_weights stores each conv as [16-byte unit][C][16 B], so a chunk is
// contiguous and the producer warp fetches it with bulk copies (the copy
// engine, no threads spent) into a ring of NS stages with a full and an empty
// mbarrier each; the compute warps never wait on each other for weights, and
// conv2's chunks load while z's epilogue runs. The plan sizes CB: a whole conv
// at C = 32, 256 bytes at C = 64 and 128, 128 at C = 256, whose ring has to
// share shared memory with the widest activations; each chunk costs the
// compute warps one wait on the ring and one drain of the tensor cores.
// Group strides of xs and zs are odd multiples of 16 bytes, so that the
// transposing stores of x and of z hit distinct banks. x is read once, 16
// bytes at a time along time where T is a multiple of 8 frames.
//
// bf16: wgmma. Two warpgroups, each M = 64 MI frames by N = NW channels
// (NW = min(C, 128), or 64 for the 64-frame tile at C = 128; C / NW
// warpgroups across the channels), from
// no-swizzle matrix descriptors on xs/zs (A) and the ring (B); f32
// accumulators; lrelu(x) and z are rounded to bf16 where they enter a product.
//
// f32: mma.sync m16n8k8 in TF32, three products a product (x = big + small,
// small terms first), which keeps float32 accuracy; the split into TF32
// halves happens in registers after ldmatrix, which wgmma (B only from shared
// memory) would not allow without staging both halves of the weights. A warp
// owns WM x WN (WN = min(C, 64)). The tensor cores do not round their f32
// sums to nearest; over up to 2 x 11 x 256 terms that drifted to 1e-4, so f32
// sums each 128 bytes of weights apart and adds them to the total on the CUDA
// cores.
//
// The tile plan (LZ, TT, CB, NS) comes from ops/mrf.py::mrf_plan, which the CPU
// tests check; the kernel derives the rest the same way and refuses a plan
// that does not fit.

#include "tensor_core.cuh"

#ifndef MRF_COPY_BYTES
#define MRF_COPY_BYTES 32768  // largest bulk copy of the weight stream (-D to tune)
#endif

namespace {

using namespace tc;
typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;             // compute warps; ops/mrf.py's _WARPS
constexpr int THREADS = WARPS * 32;  // compute threads; one producer warp more
constexpr int SMEM_LIMIT = 232448;   // bytes of shared memory a Hopper block may use

__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, 0.1f * v); }

__device__ __forceinline__ void store2(unsigned char* p, float a, float b, bf16*) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(unsigned char* p, float a, float b, float*) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void sync_compute() {  // the compute warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Derived sizes of one plan, as ops/mrf.py::_smem_bytes computes them.
struct Plan {
  int lz, tt, cb, ns;  // z frames, output frames, chunk bytes a row, ring stages
  int h1, h2, ly, lzt;  // halos, frames of xs and of zs
  int gx, gz, os;       // bytes between channel groups of xs, of zs; of an xr row
  size_t ring_bytes, xs_bytes, zs_bytes, xr_bytes;
  __host__ __device__ Plan(int C, int K, int dil, int E, int lz_, int tt_, int cb_, int ns_) {
    lz = lz_, tt = tt_, cb = cb_, ns = ns_;
    h2 = (K - 1) / 2, h1 = dil * h2;
    ly = lz + 2 * h1, lzt = lz + 2 * h2;
    gx = (ly | 1) * 16, gz = (lzt | 1) * 16, os = (tt * E + 127) / 128 * 128 + 16;
    const int groups = C * E / 16;
    ring_bytes = (size_t)ns * C * cb;
    xs_bytes = (size_t)groups * gx;
    zs_bytes = (size_t)groups * gz;
    xr_bytes = (size_t)C * os;
  }
  __host__ __device__ size_t bars() const { return ring_bytes + xs_bytes + zs_bytes + xr_bytes; }
  __host__ __device__ size_t smem() const { return bars() + 16 * (size_t)ns; }
};

// Frame f of VEC channels' 16-byte vectors along time, as one 16-byte row of
// channels with lrelu applied: a transpose in registers
__device__ __forceinline__ uint4 lrelu_row(const uint4 (&v)[8], int f, bf16*) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // channels 2q, 2q + 1: frame f of each
    const uint32_t a = (&v[2 * q].x)[f / 2], b = (&v[2 * q + 1].x)[f / 2];
    const uint32_t pair = __byte_perm(a, b, f % 2 ? 0x7632 : 0x5410);
    w[q] = pack_bf16(lrelu(__uint_as_float(pair << 16)), lrelu(__uint_as_float(pair & 0xffff0000u)));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 lrelu_row(const uint4 (&v)[4], int f, float*) {
  float r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) r[c] = lrelu(__uint_as_float((&v[c].x)[f]));
  return make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]), __float_as_uint(r[2]),
                    __float_as_uint(r[3]));
}

// Shared state of a block: the plan, its buffers and its mbarriers.
struct Tile {
  Plan p;
  unsigned char *ring, *xs, *zs, *xr;
  uint32_t full, empty;  // shared addresses of the ns full and ns empty mbarriers
  int t0, row, nc, total, slot_bytes;
  __device__ Tile(const Plan& p_, unsigned char* smem, int C, int K, int E)
      : p(p_), ring(smem), xs(smem + p_.ring_bytes), zs(xs + p_.xs_bytes), xr(zs + p_.zs_bytes) {
    full = smem_u32(smem + p.bars());
    empty = full + 8 * p.ns;
    t0 = blockIdx.x * p.tt;
    row = K * C * E;                  // bytes of an output channel's weights, a conv
    nc = (row + p.cb - 1) / p.cb;     // chunks a conv; chunk q of conv q / nc is bytes
    total = 2 * nc;                   // [r cb, r cb + cb) of every output row, r = q % nc
    slot_bytes = C * p.cb;
  }
  // bytes of chunk q's rows: cb, or what is left of the row
  __device__ int rbytes(int q) const {
    const int r = q >= nc ? q - nc : q;
    return min(p.cb, row - r * p.cb);
  }
};

__device__ __forceinline__ void init_barriers(const Tile& s) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.p.ns; ++i) {
      mbar_init(s.full + 8 * i, 1);
      mbar_init(s.empty + 8 * i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: chunk q into ring slot q % ns once every compute warp
// has released the chunk that slot held, in bulk copies of up to 32 KB, a lane
// each (each copy costs the copy engine a request: 1 KB copies took C = 256
// twice as long as 4 KB ones). A conv's packed weights are [unit][C][16 B], so
// chunk r is the C x rbytes contiguous bytes from r cb C on.
__device__ __forceinline__ void produce(const Tile& s, const void* wp, int C, int lane) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(wp);
  constexpr int PIECE = MRF_COPY_BYTES;
  for (int q = 0; q < s.total; ++q) {
    const int slot = q % s.p.ns, conv = q >= s.nc, r = q - conv * s.nc;
    const int bytes = C * s.rbytes(q);
    const unsigned char* from = src + (size_t)conv * C * s.row + (size_t)r * s.slot_bytes;
    if (q >= s.p.ns) mbar_wait(s.empty + 8 * slot, ((q / s.p.ns) - 1) & 1);
    if (lane == 0) mbar_arrive_tx(s.full + 8 * slot, bytes);
    __syncwarp();
    for (int off = lane * PIECE; off < bytes; off += 32 * PIECE)
      bulk_copy(smem_u32(s.ring + (size_t)slot * s.slot_bytes) + off, from + off,
                min(PIECE, bytes - off), s.full + 8 * slot);
  }
}

// Byte offset of (frame row u, channel c) in a core-matrix buffer of group stride g
template <typename T>
__device__ __forceinline__ int cm(int u, int c, int g) {
  constexpr int PER = 16 / sizeof(T);  // channels a 16-byte group
  return (c / PER) * g + u * 16 + (c % PER) * (int)sizeof(T);
}

// xs = lrelu(x) over frames [t0 - H, t0 - H + ly), zero outside [0, T); xr =
// x over [t0, t0 + tt); zs rows [lz, lzt) zero. Compute threads only.
template <typename T>
__device__ __forceinline__ void stage_x(const Tile& s, const T* xb, int C, int Tlen) {
  constexpr int E = sizeof(T), VEC = 16 / E;
  const Plan& p = s.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t0 = s.t0;
  for (int i = tid; i < (C * E / 16) * (p.lzt - p.lz); i += THREADS) {
    const int grp = i / (p.lzt - p.lz), u = p.lz + i - grp * (p.lzt - p.lz);
    *reinterpret_cast<uint4*>(s.zs + grp * p.gz + u * 16) = make_uint4(0, 0, 0, 0);
  }
  const int f_lo = t0 - p.h1 - p.h2;
  if (Tlen % VEC == 0) {
    // an item is one 16-byte channel group (VEC channels) by VEC frames from
    // an aligned start: VEC 16-byte loads along time, one a channel, then a
    // transpose in registers into VEC 16-byte rows of xs (lrelu applied) and
    // the raw vectors into xr. Consecutive lanes take consecutive groups, so
    // that their xs rows lie an odd number of 16-byte units apart.
    const int base = f_lo - ((f_lo % VEC) + VEC) % VEC;
    const int nv = (f_lo + p.ly - base + VEC - 1) / VEC;  // frame vectors a channel
    const int groups = C / VEC, g_shift = __ffs(groups) - 1;
    for (int i = tid; i < (nv << g_shift); i += THREADS) {
      const int grp = i & (groups - 1), f0 = base + (i >> g_shift) * VEC;
      const bool in = f0 >= 0 && f0 < Tlen;  // whole vectors: T is a multiple of VEC
      uint4 v[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        v[c] = in ? __ldg(reinterpret_cast<const uint4*>(xb + (size_t)(grp * VEC + c) * Tlen + f0))
                  : make_uint4(0, 0, 0, 0);
      if (f0 >= t0 && f0 < t0 + p.tt) {  // t0 and tt are multiples of 8 frames
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          *reinterpret_cast<uint4*>(s.xr + (size_t)(grp * VEC + c) * p.os + (f0 - t0) * E) = v[c];
      }
#pragma unroll
      for (int f = 0; f < VEC; ++f) {
        const int u = f0 + f - f_lo;
        if (u >= 0 && u < p.ly)
          *reinterpret_cast<uint4*>(s.xs + grp * p.gx + u * 16) = lrelu_row(v, f, (T*)nullptr);
      }
    }
  } else {
    for (int c = warp; c < C; c += WARPS) {
      const T* xc = xb + (size_t)c * Tlen;
      for (int u = lane; u < p.ly; u += 32) {
        const int f = f_lo + u;
        *reinterpret_cast<T*>(s.xs + cm<T>(u, c, p.gx)) =
            from_f32<T>(f >= 0 && f < Tlen ? lrelu(to_f32(xc[f])) : 0.f);
      }
      for (int v = lane; v < p.tt && t0 + v < Tlen; v += 32)
        *reinterpret_cast<T*>(s.xr + (size_t)c * p.os + v * E) = xc[t0 + v];
    }
  }
}

// The accumulators of both paths in mma fragment order: tile mi (MSTEP
// frames apart), n8 tile ni, element e at frame row0 + MSTEP mi + g + 8 (e / 2),
// channel n0 + 8 ni + 2 (lane % 4) + e % 2.
template <int A, int B>
__device__ __forceinline__ float& frag(float (&a)[A][B][4], int mi, int ni, int e) {
  return a[mi][ni][e];
}
template <int A, int B>
__device__ __forceinline__ float& frag(float (&a)[A][B], int mi, int ni, int e) {
  return a[mi][4 * ni + e];
}

// z row n is frame t0 - h2 + n: lrelu(conv + b1), zero outside [0, T) (the
// second conv's 'same' padding, not lrelu(b1)). Zeroes the accumulators.
template <typename T, int MT, int NT, int MSTEP, typename Acc>
__device__ __forceinline__ void store_z(const Tile& s, Acc& acc, const T* b1, int row0, int n0,
                                        int Tlen) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int co = n0 + 8 * ni + 2 * t4;
    const float bias0 = to_f32(b1[co]), bias1 = to_f32(b1[co + 1]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = row0 + MSTEP * mi + g + 8 * h, f = s.t0 - s.p.h2 + n;
        const bool ok = f >= 0 && f < Tlen;
        float& v0 = frag(acc, mi, ni, 2 * h);
        float& v1 = frag(acc, mi, ni, 2 * h + 1);
        store2(s.zs + cm<T>(n, co, s.p.gz), ok ? lrelu(v0 + bias0) : 0.f,
               ok ? lrelu(v1 + bias1) : 0.f, (T*)nullptr);
        v0 = v1 = 0.f;
      }
  }
}

// xr[co][v] = x + conv2 + b2 in place for v < tt (each element is one lane's),
// then the output tile to global memory
template <typename T, int MT, int NT, int MSTEP, typename Acc>
__device__ __forceinline__ void store_out(const Tile& s, Acc& acc, const T* b2, T* ob, int row0,
                                          int n0, int C, int Tlen) {
  constexpr int E = sizeof(T), VEC = 16 / E;
  const Plan& p = s.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int co = n0 + 8 * ni + 2 * t4;
    const float bias0 = to_f32(b2[co]), bias1 = to_f32(b2[co + 1]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = row0 + MSTEP * mi + g + 8 * h;
        if (v < p.tt) {
          T* r0 = reinterpret_cast<T*>(s.xr + (size_t)co * p.os + v * E);
          T* r1 = reinterpret_cast<T*>(s.xr + (size_t)(co + 1) * p.os + v * E);
          *r0 = from_f32<T>(to_f32(*r0) + frag(acc, mi, ni, 2 * h) + bias0);
          *r1 = from_f32<T>(to_f32(*r1) + frag(acc, mi, ni, 2 * h + 1) + bias1);
        }
      }
  }
  sync_compute();
  const int t0 = s.t0;
  if (Tlen % VEC == 0) {
    const int vpr = p.tt / VEC;  // 16-byte vectors a row (tt and t0 are multiples of 8)
    for (int i = tid; i < C * vpr; i += THREADS) {
      const int co = i / vpr, qv = i - co * vpr, f = t0 + qv * VEC;
      if (f < Tlen)
        *reinterpret_cast<uint4*>(ob + (size_t)co * Tlen + f) =
            *reinterpret_cast<const uint4*>(s.xr + (size_t)co * p.os + qv * 16);
    }
  } else {
    for (int co = warp; co < C; co += WARPS)
      for (int v = lane; v < p.tt && t0 + v < Tlen; v += 32)
        ob[(size_t)co * Tlen + t0 + v] = *reinterpret_cast<const T*>(s.xr + (size_t)co * p.os + v * E);
  }
}

// ---------------------------------------------------------------- bf16: wgmma

// Matrix descriptor of a K-major operand in the no-swizzle core-matrix layout:
// lbo bytes between core matrices along K, sbo along M (or N)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // all but the newest N groups are done
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across wgmma issue
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int NW, int MI>
__global__ void __launch_bounds__(THREADS + 32, 1)
mrf_step_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                      const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                      bf16* __restrict__ out, int C, int Tlen, int K, int dil, int lz, int tt,
                      int cb, int ns) {
  constexpr int E = 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile s(Plan(C, K, dil, E, lz, tt, cb, ns), smem, C, K, E);
  const Plan& p = s.p;
  init_barriers(s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == WARPS) {
    produce(s, wp, C, lane);
    return;
  }
  const bf16* xb = x + (size_t)blockIdx.y * C * Tlen;
  stage_x<bf16>(s, xb, C, Tlen);
  fence_async_smem();
  sync_compute();

  // warpgroup wg: frames [m_start, m_start + 64 MI), channels [n0, n0 + NW)
  const int wg = warp / 4, wg_n = C / NW;
  const int m_start = (wg / wg_n) * 64 * MI, n0 = (wg % wg_n) * NW;
  const int row0 = m_start + 16 * (warp % 4);  // this warp's first accumulator row
  const uint32_t xs_a = smem_u32(s.xs), zs_a = smem_u32(s.zs), ring_a = smem_u32(s.ring);
  const int upt = C * E / 16;  // 16-byte units a tap

  float acc[MI][NW / 2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[mi][i] = 0.f;

  for (int q = 0; q < s.total; ++q) {
    const int slot = q % ns;
    mbar_wait(s.full + 8 * slot, (q / ns) & 1);
    const int conv = q >= s.nc, u0 = (q - conv * s.nc) * (p.cb / 16);
    int j = u0 / upt, grp = u0 - j * upt;  // tap and channel group of the chunk's first unit
    // descriptors advance by 16-byte units in their low bits
    const uint32_t lbo_a = conv ? p.gz : p.gx, shift = conv ? 1 : dil;
    const uint64_t da0 = gmma_desc(conv ? zs_a : xs_a, lbo_a, 128);
    const uint64_t db0 = gmma_desc(ring_a + slot * s.slot_bytes + n0 * 16, C * 16, 128);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) reg_fence(acc[mi]);
    wgmma_fence();
    // k16 step k: units 2k, 2k + 1 of the chunk (B) and channel groups grp,
    // grp + 1 from frame m_start + 64 mi + the tap's shift (A)
    auto step = [&](int k) {
      const uint64_t da = da0 + ((grp * lbo_a + (m_start + j * shift) * 16) >> 4);
      const uint64_t db = db0 + ((2 * k * C * 16) >> 4);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) wgmma_bf16(acc[mi], da + 64 * mi, db);
      grp += 2;
      if (grp == upt) grp = 0, ++j;
    };
    const int steps = s.rbytes(q) / 32;
    int k = 0;
    for (; k + 4 <= steps; k += 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) step(k + kk);
    }
    for (; k < steps; ++k) step(k);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) reg_fence(acc[mi]);
    __syncwarp();
    if (lane == 0) mbar_arrive(s.empty + 8 * slot);  // this warp is done with the slot
    if (q == s.nc - 1) {
      store_z<bf16, MI, NW / 8, 64>(s, acc, b1, row0, n0, Tlen);
      fence_async_smem();
      sync_compute();  // all of z is written before conv2 reads it
    }
  }
  store_out<bf16, MI, NW / 8, 64>(s, acc, b2, out + (size_t)blockIdx.y * C * Tlen, row0, n0, C,
                                  Tlen);
}

// ---------------------------------------------------------------- f32: mma.sync, 3 x TF32

// acc += one k-step (8 channels) from fragments in registers
template <int MT, int NT>
__device__ __forceinline__ void mma_step_f32(float (&acc)[MT][NT][4], const uint32_t (&af)[MT][4],
                                             const uint32_t (&bf)[NT / 2][4]) {
  uint32_t ab[MT][4], as[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(af[mi][e]), ab[mi][e], as[mi][e]);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t bb[4], bs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(bf[np][e]), bb[e], bs[e]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // n-tiles 2np, 2np + 1
        float(&c)[4] = acc[mi][2 * np + h];
        mma_tf32(c, as[mi], bb[2 * h], bb[2 * h + 1]);
        mma_tf32(c, ab[mi], bs[2 * h], bs[2 * h + 1]);
        mma_tf32(c, ab[mi], bb[2 * h], bb[2 * h + 1]);
      }
  }
}

// acc += one weight chunk's share of a product: STEPS k-steps of 32 bytes
// (two 16-byte channel groups each). a: this lane's ldmatrix row in the
// activations (tap shift and first group applied), ga bytes between groups;
// b: this lane's row in the ring slot, gb bytes between its units. The
// fragments of step s + 1 are loaded before the products of step s.
template <int MT, int NT, int STEPS>
__device__ __forceinline__ void conv_chunk_f32(float (&acc)[MT][NT][4], uint32_t a, int ga,
                                               uint32_t b, int gb) {
  uint32_t af[2][MT][4], bf[2][NT / 2][4];
#pragma unroll
  for (int s = 0; s <= STEPS; ++s) {
    if (s < STEPS) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) ldsm_x4(af[s & 1][mi], a + 2 * s * ga + mi * 256);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) ldsm_x4(bf[s & 1][np], b + 2 * s * gb + np * 256);
    }
    if (s > 0) mma_step_f32<MT, NT>(acc, af[(s - 1) & 1], bf[(s - 1) & 1]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&a)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[mi][ni][e] = 0.f;
}

template <int WM, int WN>
__global__ void __launch_bounds__(THREADS + 32, 1)
mrf_step_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ b1, const float* __restrict__ b2,
                    float* __restrict__ out, int C, int Tlen, int K, int dil, int lz, int tt,
                    int cb, int ns) {
  constexpr int E = 4, MT = WM / 16, NT = WN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile s(Plan(C, K, dil, E, lz, tt, cb, ns), smem, C, K, E);
  const Plan& p = s.p;
  init_barriers(s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == WARPS) {
    produce(s, wp, C, lane);
    return;
  }
  const float* xb = x + (size_t)blockIdx.y * C * Tlen;
  stage_x<float>(s, xb, C, Tlen);
  sync_compute();

  const int warps_n = C / WN;
  const int m0 = (warp / warps_n) * WM, n0 = (warp % warps_n) * WN;
  // this lane's ldmatrix rows: A (frames) m0 + (lane & 15) of group + (lane >> 4);
  // B (output channels) n0 + (lane & 7) + 8 (lane >> 4) of unit + ((lane >> 3) & 1)
  const uint32_t a_xs = smem_u32(s.xs) + (lane >> 4) * p.gx + (m0 + (lane & 15)) * 16;
  const uint32_t a_zs = smem_u32(s.zs) + (lane >> 4) * p.gz + (m0 + (lane & 15)) * 16;
  const uint32_t b_lane =
      smem_u32(s.ring) + ((lane >> 3) & 1) * C * 16 + (n0 + (lane & 7) + 8 * (lane >> 4)) * 16;
  const int upt = C * E / 16;  // 16-byte units a tap

  // each 128 bytes of a chunk sum apart in acc and are added to tot (see top)
  float acc[MT][NT][4], tot[MT][NT][4];
  zero(acc);
  zero(tot);
  for (int q = 0; q < s.total; ++q) {
    const int slot = q % ns;
    mbar_wait(s.full + 8 * slot, (q / ns) & 1);
    const int conv = q >= s.nc, u0 = (q - conv * s.nc) * (p.cb / 16);
    int j = u0 / upt, grp = u0 - j * upt;  // tap and channel group of the chunk's first unit
    for (int sub = 0; sub < s.rbytes(q) / 128; ++sub) {  // 8 units: 4 k-steps, one tap
      const uint32_t b = b_lane + slot * s.slot_bytes + sub * 8 * C * 16;
      if (!conv)
        conv_chunk_f32<MT, NT, 4>(acc, a_xs + grp * p.gx + j * dil * 16, p.gx, b, C * 16);
      else if (m0 < p.tt)  // a warp whose frames all lie past the tile's output skips conv2
        conv_chunk_f32<MT, NT, 4>(acc, a_zs + grp * p.gz + j * 16, p.gz, b, C * 16);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[mi][ni][e] += acc[mi][ni][e], acc[mi][ni][e] = 0.f;
      grp += 8;
      if (grp == upt) grp = 0, ++j;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(s.empty + 8 * slot);  // this warp is done with the slot
    if (q == s.nc - 1) {
      store_z<float, MT, NT, 16>(s, tot, b1, m0, n0, Tlen);
      sync_compute();  // all of z is written before conv2 reads it
    }
  }
  store_out<float, MT, NT, 16>(s, tot, b2, out + (size_t)blockIdx.y * C * Tlen, m0, n0, C, Tlen);
}

template <typename T, typename Kernel>
int launch(Kernel kern, const void* x, const void* wp, const void* b1, const void* b2, void* out,
           int B, int C, int Tlen, int K, int dil, int lz, int tt, int cb, int ns,
           cudaStream_t stream) {
  const Plan p(C, K, dil, (int)sizeof(T), lz, tt, cb, ns);
  const int step = sizeof(T) == 2 ? 32 : 128;  // bytes a chunk's rows come in
  if (tt < 8 || tt % 8 != 0 || tt + 2 * p.h2 > lz || ns < 2 || ns > 8 || cb % step != 0 ||
      cb > K * C * (int)sizeof(T) || p.smem() > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tlen + tt - 1) / tt, B);
  kern<<<grid, THREADS + 32, p.smem(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), static_cast<const T*>(b1),
      static_cast<const T*>(b2), static_cast<T*>(out), C, Tlen, K, dil, lz, tt, cb, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, C, T) contiguous; wp: both convs' weights as ops/mrf.py's
// pack_weights lays them out, chunk by chunk; b1, b2: (C,); all of one dtype,
// f32 or bf16 (`dtype`). C is one of 32, 64, 128, 256 and K one of 3, 7, 11.
// The plan (lz, tt, cb, ns) is ops/mrf.py::mrf_plan's: frames of z and of
// output a block, bytes of each output row a weight chunk holds (a multiple of
// 32 in bf16, of 128 in f32) and ring stages; lz must be one the kernels tile
// (ops/mrf.py::_z_frames):
//   bf16: 64 or 128 at C = 256; 64, 128 or 256 at C = 128; 128, 256 or 512 at
//         C = 64; 256 or 512 at C = 32;
//   f32:  WM x 8 / (C / WN), WN = min(C, 64), WM in {16, 32}.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mrf_step(const void* x, const void* wp, const void* b1, const void* b2, void* out,
                        int B, int C, int Tlen, int K, int dil, int dtype, int lz, int tt, int cb,
                        int ns, void* stream) {
  if (B <= 0 || Tlen <= 0 || dil <= 0 || !(C == 32 || C == 64 || C == 128 || C == 256) ||
      !(K == 3 || K == 7 || K == 11))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MRF_ARGS x, wp, b1, b2, out, B, C, Tlen, K, dil, lz, tt, cb, ns, s
  if (dtype == DTYPE_BF16) {
    // two warpgroups of 64 MI frames by NW channels: C / NW of them across
    // the channels; 64 x 1 at C = 128 is the 64-frame tile
    if (C == 128 && lz == 64) return launch<bf16>(mrf_step_wgmma_kernel<64, 1>, MRF_ARGS);
    const int wg_m = C >= 256 ? 1 : 2, mi = lz / (64 * wg_m);
    if (lz % (64 * wg_m) != 0) return (int)cudaErrorInvalidValue;
    if (C >= 128 && mi == 1) return launch<bf16>(mrf_step_wgmma_kernel<128, 1>, MRF_ARGS);
    if (C >= 128 && mi == 2) return launch<bf16>(mrf_step_wgmma_kernel<128, 2>, MRF_ARGS);
    if (C == 64 && mi == 1) return launch<bf16>(mrf_step_wgmma_kernel<64, 1>, MRF_ARGS);
    if (C == 64 && mi == 2) return launch<bf16>(mrf_step_wgmma_kernel<64, 2>, MRF_ARGS);
    if (C == 64 && mi == 4) return launch<bf16>(mrf_step_wgmma_kernel<64, 4>, MRF_ARGS);
    if (C == 32 && mi == 2) return launch<bf16>(mrf_step_wgmma_kernel<32, 2>, MRF_ARGS);
    if (C == 32 && mi == 4) return launch<bf16>(mrf_step_wgmma_kernel<32, 4>, MRF_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == DTYPE_F32) {
    const int wn = C >= 64 ? 64 : 32, wm = lz / (WARPS / (C / wn));
    if (lz % (WARPS / (C / wn)) != 0) return (int)cudaErrorInvalidValue;
    if (wn == 64 && wm == 32) return launch<float>(mrf_step_f32_kernel<32, 64>, MRF_ARGS);
    if (wn == 64 && wm == 16) return launch<float>(mrf_step_f32_kernel<16, 64>, MRF_ARGS);
    if (wn == 32 && wm == 32) return launch<float>(mrf_step_f32_kernel<32, 32>, MRF_ARGS);
    if (wn == 32 && wm == 16) return launch<float>(mrf_step_f32_kernel<16, 32>, MRF_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#undef MRF_ARGS
  return (int)cudaErrorInvalidValue;
}
