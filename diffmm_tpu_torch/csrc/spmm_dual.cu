// K1: dual-direction dense bipartite propagation in one pass over the 0/1
// adjacency M (U, I), stored int8 or bf16 with a row stride `ld` (elements)
// whose bytes are a multiple of 16:
//
//     y_u = M  @ bf16(z_i)      (U, D) f32
//     y_i = Mᵀ @ bf16(z_u)      (I, D) f32
//
// z_u (U, D) and z_i (I, D) arrive in f32 and are rounded to bf16 (to
// nearest even) on chip; products are exact in f32 (M is 0/1, any int8
// value is exact in bf16) and sums are f32. D is 16, 32 or 64.
//
// Replaces diffmm_tpu/ops/pallas/spmm_dual.py::_dual_kernel (called from
// _dual_call). On the TPU the grid walks U row-blocks in order and y_i
// accumulates in VMEM across the grid; Hopper blocks run in parallel and in
// no order, so each direction is summed across blocks in a fixed order.
//
// Bound at tiktok shape (U 9,308, I 6,710, D 64, int8 M): 62.5 MB of M +
// 4.1 MB of f32 z + 4.1 MB of f32 y = 70.7 MB, 21.1 us at 3.35 TB/s; 16.0
// GFLOP of bf16 products, 16.2 us at 989 TFLOP/s: memory-bound, but the
// tensor cores must run at three quarters of their peak to keep up.
//
// Design: one launch. The grid is Cpad x R blocks of 256 threads (two
// warpgroups), one block an SM (about 220 KB of shared memory at D 64), and
// the whole grid resident at once (a cooperative launch). Block (c, r) owns
// the I range [384 c, 384 c + 384) and the U range [su r, su r + su), su a
// multiple of 128. The C column blocks that share a U range form clusters of
// CS blocks along I; the plan takes the CS (at most 8) that keeps the most
// blocks with columns on the card, and Cpad rounds C up to it. A block walks
// its U range in strips of 128 rows and each strip in sub-tiles of 128 x 64:
// - A ring of three or six TMA loads (cp.async.bulk.tensor over the (U, ld)
//   storage, zero fill past U and I; 48 KB) completes on mbarriers. Thread 0
//   issues the loads and refills a slot as soon as it is converted.
// - All threads convert a landed sub-tile once into a bf16 tile in the
//   128-byte swizzle that wgmma reads (int8 through the f32 magic-number
//   trick, no per-element cvt), into one of two tiles, so the conversion of
//   sub-tile t + 1 runs while the tensor cores work on t.
// - Both products read that one tile through wgmma descriptors (m64nNk16,
//   f32 accumulators in registers), in two commit groups a sub-tile: y_u =
//   M @ z_i with the tile K-major (warpgroup w takes strip rows 64w..64w+63),
//   then y_i = Mᵀ @ z_u with the same bytes read MN-major (transposed A),
//   each warpgroup one half of D. z_i of the block's I range is rounded and
//   stored transposed once; z_u of each strip is loaded into registers a
//   strip ahead and stored transposed (rounded) at the strip's start.
// - y_i of the block's 384 columns stays in registers over the whole U range;
//   y_u of a strip stays in registers over the strip.
// Cross-block sums, in a fixed order, no atomics on values:
// - y_u, in the cluster: at each strip's end every block pushes row slice k
//   of its strip sums into block k's shared memory (distributed shared
//   memory, 16-byte stores), in the slot of its own rank; block k sums the
//   CS slots in rank order at the end of the next strip. Two exchange
//   buffers and one cluster barrier phase a strip, arrived at after the next
//   strip's first products are issued, keep the blocks of a cluster from
//   waiting on each other. With one cluster along I that sum is y_u; with G
//   = Cpad / CS > 1 cluster groups it goes to Pu[g] (G, U, D).
// - y_i: with R > 1 each block writes its columns to Pi[r] (R, I, D).
// - Then the grid meets at a barrier (two words the kernel leaves reset) and
//   sums Pu[0..G-1] and Pi[0..R-1] in that order, every block a slice,
//   while the partials sit in L2.
// Partial bytes per call: (G > 1 ? G : 0) U D 4 + (R > 1 ? R : 0) I D 4,
// written once and read once while they sit in L2 (33.5 MB at tiktok shape:
// G 9, R 7 on 132 SMs). The result does not vary from run to run; it differs
// from the plain PyTorch version only by the f32 summation order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;    // two warpgroups; thread 0 also issues the loads
constexpr int kBU = 128;         // U rows of a strip
constexpr int kBI = 64;          // I columns of a sub-tile (one 128-byte swizzle row of bf16)
constexpr int kNJ = 6;           // sub-tiles of a block's I range
constexpr int kSI = kNJ * kBI;   // 384 I columns of a block
constexpr int kRing = 48 * 1024; // bytes of the M ring
constexpr int kMaxCluster = 8;
constexpr int kXRows = 136;      // rows of an exchange buffer: cs * ceil(128 / cs) <= 133

template <int D, typename MT>
struct Cfg {
  static constexpr int kSlot = kBU * kBI * (int)sizeof(MT);
  static constexpr int kStages = kRing / kSlot;
  static constexpr int kTile = kBU * kBI * 2;  // a bf16 sub-tile
  static constexpr int kZBlk = D * 128;        // 64 rows of a transposed z: D rows of 128 bytes
  static constexpr int kXld = D + 4;           // f32 row stride of a strip exchange buffer
  static constexpr int kXBuf = kXRows * kXld * 4;
  static constexpr int kZp = kBU / 2 * D / 4 / kThreads;  // (2 rows x 4 columns) of z_u a thread takes
  static constexpr int OFF_ZI = 2 * kTile;
  static constexpr int OFF_ZU = OFF_ZI + kNJ * kZBlk;
  static constexpr int OFF_RING = OFF_ZU + 2 * kZBlk;
  static constexpr int OFF_X = OFF_RING + kRing;          // two exchange buffers
  static constexpr int SMEM = OFF_X + 2 * kXBuf + 1024;  // + slack to align to 1,024
  static constexpr int NACC = D / 2;  // f32 accumulators of a thread for a 64 x D product
  static_assert(D == 16 || D == 32 || D == 64, "D must be 16, 32 or 64");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (x, y) of a 2-D tensor map into shared dst, completing on bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// address of the same shared variable in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_dsmem(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// wgmma descriptor, 128-byte swizzle: rows of 128 bytes, 8-row groups 1,024
// bytes apart. K-major operands take lbo 16 (unused); the MN-major A takes
// 1,024 in both fields: its M extent is one 64-element block, so only the
// stride of 8-deep K groups is read, whichever field holds it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to d across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N f32) += A (64 x 16 bf16) @ B (16 x N bf16), both from shared
// memory; TA = 1 reads A MN-major (transposed)
template <int N, int TA>
struct Mma;

#define DMMA_BODY(SHAPE, REGS, NA, NB, NP, TA)                                        \
  asm volatile("{\n"                                                                   \
               ".reg .pred p;\n"                                                       \
               "setp.ne.b32 p, %" NP ", 0;\n"                                          \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 " REGS ", %" NA  \
               ", %" NB ", p, 1, 1, " TA ", 0;\n"                                      \
               "}\n"

#define R4 "{%0, %1, %2, %3}"
#define R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define O4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define O8(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define O16(d) O8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define O32(d)                                                                                  \
  O16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define DEFINE_MMA(N, TA, SHAPE, REGS, NA, NB, NP, OUTS)                                       \
  template <>                                                                              \
  struct Mma<N, TA> {                                                                      \
    static __device__ __forceinline__ void run(float (&d)[N / 2], uint64_t a, uint64_t b) { \
      DMMA_BODY(SHAPE, REGS, NA, NB, NP, #TA) : OUTS(d) : "l"(a), "l"(b), "r"(1));         \
    }                                                                                      \
  };

DEFINE_MMA(8, 1, "m64n8k16", R4, "4", "5", "6", O4)
DEFINE_MMA(16, 0, "m64n16k16", R8, "8", "9", "10", O8)
DEFINE_MMA(16, 1, "m64n16k16", R8, "8", "9", "10", O8)
DEFINE_MMA(32, 0, "m64n32k16", R16, "16", "17", "18", O16)
DEFINE_MMA(32, 1, "m64n32k16", R16, "16", "17", "18", O16)
DEFINE_MMA(64, 0, "m64n64k16", R32, "32", "33", "34", O32)

// two bf16 in one word, rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 int8 -> 16 bf16, exact: byte b becomes the f32 2^23 + (b + 128)
// (bits 0x4B0000xx), minus 2^23 + 128
__device__ __forceinline__ void cvt_chunk(uint4 v, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(w[k], 0x4B000000u, 0x7540u | b)) - 8388736.0f;
    o[2 * k] = pack_bf16(f[0], f[1]);
    o[2 * k + 1] = pack_bf16(f[2], f[3]);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// byte offset of element (row, col) in a tile of 128-byte rows with the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)); col in bf16
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// z rows (row, row + 1), row even, into a transposed, swizzled z (64-row
// blocks of D rows (d) x 64 columns (row % 64)): the two values of each d
// are one 4-byte word. Lanes that take consecutive row pairs write the 128
// bytes of one row of the block, so the stores meet no bank conflict.
template <int D>
__device__ __forceinline__ void put_zt2(unsigned char* zt, int row, int d, float4 a, float4 b) {
  unsigned char* p = zt + (row >> 6) * (D * 128);
  const int col = row & 63;
  *reinterpret_cast<uint32_t*>(p + swz(d, col)) = pack_bf16(a.x, b.x);
  *reinterpret_cast<uint32_t*>(p + swz(d + 1, col)) = pack_bf16(a.y, b.y);
  *reinterpret_cast<uint32_t*>(p + swz(d + 2, col)) = pack_bf16(a.z, b.z);
  *reinterpret_cast<uint32_t*>(p + swz(d + 3, col)) = pack_bf16(a.w, b.w);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid waits here until all have arrived: bar[0] counts
// arrivals, bar[1] the barriers passed. The launch is cooperative, so the
// blocks are resident together. The last block to arrive resets the count,
// so the next call finds it at zero.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned nb = gridDim.x * gridDim.y;
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == nb - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (ld_acquire(bar + 1) == gen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// out[e] = sum over k < P of part[k * stride + e], in the order of k, for the
// float4 elements e = first, first + step, ... below n
__device__ __forceinline__ void fold(const float4* __restrict__ part, long long stride,
                                     float4* __restrict__ out, long long n, int P,
                                     long long first, long long step) {
  constexpr int kE = 4;  // elements a thread sums at once
  for (long long e0 = first; e0 < n; e0 += kE * step) {
    float4 acc[kE];
#pragma unroll
    for (int x = 0; x < kE; ++x) acc[x] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 0; k < P; ++k) {
      float4 v[kE];
#pragma unroll
      for (int x = 0; x < kE; ++x) {
        const long long e = e0 + x * step;
        v[x] = e < n ? __ldcg(part + k * stride + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int x = 0; x < kE; ++x)
        acc[x].x += v[x].x, acc[x].y += v[x].y, acc[x].z += v[x].z, acc[x].w += v[x].w;
    }
#pragma unroll
    for (int x = 0; x < kE; ++x)
      if (e0 + x * step < n) out[e0 + x * step] = acc[x];
  }
}

template <int D, typename MT>
__global__ void __launch_bounds__(kThreads, 1)
    dual_kernel(const __grid_constant__ CUtensorMap mmap, const float* __restrict__ zu,
                const float* __restrict__ zi, float* __restrict__ yu, float* __restrict__ yi,
                float* __restrict__ pu, float* __restrict__ pi, unsigned* __restrict__ bar, int U,
                int I, int su, int G, int R) {
  using C = Cfg<D, MT>;
  constexpr int S = C::kStages;
  __shared__ __align__(8) uint64_t full[S];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;  // the swizzle needs 1,024
  unsigned char* sm = smem_raw + (base - raw_u32);
  auto xbuf = [&](int s) { return reinterpret_cast<float*>(sm + C::OFF_X + (s & 1) * C::kXBuf); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wq = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g8 = lane / 4, q = lane % 4;
  const int c = blockIdx.x, r = blockIdx.y;
  const int cs = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const int grp = c / cs;
  const int rs = (kBU + cs - 1) / cs;  // strip rows whose sum a block of the cluster owns
  const int own = min(rs, kBU - rank * rs);
  const int i0 = c * kSI;
  const int iend = min(i0 + kSI, I);
  const int nj = iend > i0 ? (iend - i0 + kBI - 1) / kBI : 0;
  const int u0 = r * su;
  const int uend = min(u0 + su, U);
  const int ns = uend > u0 ? (uend - u0 + kBU - 1) / kBU : 0;
  const int total = ns * nj;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // sub-tile t (strip t / nj, column block t % nj) into its ring slot
  auto issue = [&](int t) {
    const int slot = t % S;
    const uint32_t bar_t = smem_u32(&full[slot]);
    mbar_expect_tx(bar_t, C::kSlot);
    tma_2d(base + C::OFF_RING + slot * C::kSlot, &mmap, i0 + (t % nj) * kBI, u0 + (t / nj) * kBU,
           bar_t);
  };
  if (tid == 0)
    for (int t = 0; t < min(total, S); ++t) issue(t);

  // z_u of a strip in registers, one strip ahead (zeros past U)
  float4 zr[2 * C::kZp];
  // unit k of a thread: rows 2 pr, 2 pr + 1 of the strip, columns 4 d4 .. + 3
  auto zu_unit = [&](int k, int& pr, int& d4) {
    const int w = tid + k * kThreads;
    pr = w % (kBU / 2), d4 = w / (kBU / 2);
  };
  auto load_zu = [&](int s) {
#pragma unroll
    for (int k = 0; k < C::kZp; ++k) {
      int pr, d4;
      zu_unit(k, pr, d4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = u0 + s * kBU + 2 * pr + h;
        zr[2 * k + h] = u < U ? __ldg(reinterpret_cast<const float4*>(zu + (size_t)u * D + 4 * d4))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  if (ns > 0) load_zu(0);

  // z_i of the block's I range, rounded and stored transposed (zeros past I)
  for (int w = tid; w < kSI / 2 * D / 4; w += kThreads) {
    const int pr = w % (kSI / 2), d = (w / (kSI / 2)) * 4;
    float4 v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 2 * pr + h;
      v[h] = i < iend ? *reinterpret_cast<const float4*>(zi + (size_t)i * D + d)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    put_zt2<D>(sm + C::OFF_ZI, 2 * pr, d, v[0], v[1]);
  }

  // the cluster's sum of strip s's rows that this block owns, from its
  // exchange buffer, the blocks' slots in rank order
  auto sum_strip = [&](int s) {
    const float* xb = xbuf(s);
    for (int e = tid; e < own * D / 4; e += kThreads) {
      const int row = e / (D / 4), col = (e % (D / 4)) * 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < cs; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(xb + (k * rs + row) * C::kXld + col);
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
      const int u = u0 + s * kBU + rank * rs + row;
      if (u < U) {
        float* dst = G > 1 ? pu + ((size_t)grp * U + u) * D : yu + (size_t)u * D;
        *reinterpret_cast<float4*>(dst + col) = sum;
      }
    }
  };

  // first phase of the cluster barrier: every block of the cluster has
  // started before any writes to another's shared memory
  cluster_arrive();

  float acc_u[C::NACC];
  // y_i of sub-tile j, columns [D/2 wg, D/2 wg + D/2) of warpgroup wg
  float acc_i[kNJ][C::NACC / 2];
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int k = 0; k < C::NACC / 2; ++k) acc_i[j][k] = 0.f;

  for (int s = 0; s < ns; ++s) {
    // z_u of the strip, rounded and stored transposed, once both warpgroups'
    // products of the last strip are done; then the next strip's z_u loads
    wgmma_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < C::kZp; ++k) {
      int pr, d4;
      zu_unit(k, pr, d4);
      put_zt2<D>(sm + C::OFF_ZU, 2 * pr, 4 * d4, zr[2 * k], zr[2 * k + 1]);
    }
    if (s + 1 < ns) load_zu(s + 1);
#pragma unroll
    for (int k = 0; k < C::NACC; ++k) acc_u[k] = 0.f;

#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      if (j < nj) {
        const int t = s * nj + j;
        const int slot = t % S;
        const int buf = t & 1;
        // both warpgroups are done with sub-tile t - 2, the last user of buf
        // (and, at j 0, every thread has stored its z_u)
        fence_proxy_async();
        __syncthreads();
        mbar_wait(smem_u32(&full[slot]), (t / S) & 1);
        {
          const unsigned char* src = sm + C::OFF_RING + slot * C::kSlot;
          unsigned char* dst = sm + buf * C::kTile;
          constexpr int kChunks = C::kSlot / 16;  // 16-byte chunks of the slot
#pragma unroll
          for (int k = 0; k < kChunks / kThreads; ++k) {
            const int e = tid + k * kThreads;
            const uint4 v = reinterpret_cast<const uint4*>(src)[e];
            if (sizeof(MT) == 1) {
              const int row = e / 4, col = (e % 4) * 16;
              uint4 lo, hi;
              cvt_chunk(v, lo, hi);
              *reinterpret_cast<uint4*>(dst + swz(row, col)) = lo;
              *reinterpret_cast<uint4*>(dst + swz(row, col + 8)) = hi;
            } else {
              const int row = e / 8, col = (e % 8) * 8;
              *reinterpret_cast<uint4*>(dst + swz(row, col)) = v;
            }
          }
        }
        fence_proxy_async();
        __syncthreads();
        if (tid == 0 && t + S < total) issue(t + S);  // the slot is converted

        const uint32_t tile = base + buf * C::kTile;
        const uint32_t zit = base + C::OFF_ZI + j * C::kZBlk;
        const uint32_t zut = base + C::OFF_ZU;
        reg_fence(acc_u);
        reg_fence(acc_i[j]);
        wgmma_fence();
        // y_u[strip rows of warpgroup wg] += M[rows, sub-tile] @ z_i[sub-tile]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<D, 0>::run(acc_u, sw128_desc(tile + wg * 8192 + 32 * kk, 16),
                         sw128_desc(zit + 32 * kk, 16));
        wgmma_commit();
        // y_i[sub-tile, half wg of the columns] += M[strip, sub-tile]ᵀ @
        // z_u[strip, half wg]: the same instructions in both warpgroups
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          Mma<D / 2, 1>::run(acc_i[j], sw128_desc(tile + 2048 * kk, 1024),
                             sw128_desc(zut + (kk / 4) * C::kZBlk + wg * (D / 2) * 128 + 32 * (kk % 4), 16));
        wgmma_commit();
        // sub-tile t - 1's two groups are done: the buffer t + 1 takes is free
        wgmma_wait<2>();
        // the cluster barrier phase of the last strip's push, late enough
        // that its release finds the pushed values already delivered
        if (j == 0 && s > 0) cluster_arrive();
      }
    }
    if (nj == 0 && s > 0) cluster_arrive();
    // the strip's y_u is done; its last sub-tile's y_i may still run
    wgmma_wait<1>();
    reg_fence(acc_u);

    // The strip's y_u over the cluster's I range, through two exchange
    // buffers with one cluster barrier phase a strip: after this wait every
    // block has pushed strip s - 1 (so this block sums its rows of it) and
    // has summed strip s - 2 (so buffer s % 2 is free again).
    cluster_wait();
    if (s > 0) sum_strip(s - 1);
    {
      // row slice k of this block's sums into block k's buffer, in the slot
      // of this block's rank, four columns a store: lanes q and q ^ 1 hold
      // the two halves of a row's 4 columns, the even lane's row 8 above
      // the odd lane's; each takes the half of its row the other holds
      const int odd = q & 1;
      const int row = 64 * wg + 16 * wq + g8 + 8 * odd;
      const int owner = row / rs;
      const uint32_t dst = map_rank(
          smem_u32(xbuf(s)) + ((rank * rs + row % rs) * C::kXld + 2 * (q & 2)) * 4, owner);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float* a = acc_u + 4 * n;
        const float x = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float y = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        if (odd)
          st_dsmem(dst + 32 * n, x, y, a[2], a[3]);
        else
          st_dsmem(dst + 32 * n, a[0], a[1], x, y);
      }
    }
  }
  wgmma_wait<0>();
  if (ns > 0) cluster_arrive();
  // the last strip; no block writes to another's buffers after this wait,
  // so every block may leave once it is done with its own
  cluster_wait();
  if (ns > 0) sum_strip(ns - 1);

  // y_i of the block's columns over its U range
  {
    float* dst = R > 1 ? pi + (size_t)r * I * D : yi;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      if (j < nj) {
        reg_fence(acc_i[j]);
        const int i = i0 + 64 * j + 16 * wq + g8;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          const int col = wg * (D / 2) + 8 * n + 2 * q;
          if (i < I)
            *reinterpret_cast<float2*>(dst + (size_t)i * D + col) =
                make_float2(acc_i[j][4 * n], acc_i[j][4 * n + 1]);
          if (i + 8 < I)
            *reinterpret_cast<float2*>(dst + (size_t)(i + 8) * D + col) =
                make_float2(acc_i[j][4 * n + 2], acc_i[j][4 * n + 3]);
        }
      }
    }
  }

  // The partials of the cluster groups (y_u) and of the row blocks (y_i),
  // summed in group and row-block order by the whole grid at once.
  if (G > 1 || R > 1) {
    grid_sync(bar);
    const long long step = (long long)gridDim.x * gridDim.y * kThreads;
    const long long first = ((long long)r * gridDim.x + c) * kThreads + tid;
    if (G > 1)
      fold(reinterpret_cast<const float4*>(pu), (long long)U * D / 4, reinterpret_cast<float4*>(yu),
           (long long)U * D / 4, G, first, step);
    if (R > 1)
      fold(reinterpret_cast<const float4*>(pi), (long long)I * D / 4, reinterpret_cast<float4*>(yi),
           (long long)I * D / 4, R, first, step);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) !=
        cudaSuccess)
      return nullptr;
#endif
    if (res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 2-D map over rows x cols elements of `bytes` each, row stride ld_bytes,
// boxes of box_rows x box_cols, zero fill outside
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, long long rows,
              long long cols, long long ld_bytes, int box_rows, int box_cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// a launch of clusters of cs blocks along x; cooperative: the blocks are
// resident together (the kernel's grid barrier needs that)
cudaLaunchConfig_t config(dim3 grid, int cs, size_t smem, cudaStream_t stream, bool cooperative,
                          cudaLaunchAttribute (&attr)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative ? 2 : 1;
  return cfg;
}

// plan[0..6] = cluster size, Cpad, R, su, G, strips, kSI (see the top of the file)
template <int D, typename MT>
cudaError_t plan(int U, int I, int n_sm, int* out) {
  using C = Cfg<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(dual_kernel<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int cols = cdiv(I, kSI);
  const int strips = cdiv(U, kBU);
  int best = 0;
  // the cluster size that keeps the most blocks with columns on the card at
  // once (the grid is one wave: its blocks meet at the final grid barrier)
  for (int cs = min(kMaxCluster, cols); cs >= 1; --cs) {
    const int cpad = cdiv(cols, cs) * cs;
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg = config(dim3(cpad, 1), cs, C::SMEM, 0, false, attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, dual_kernel<D, MT>, &cfg);
    if (err != cudaSuccess) return err;
    const int room = min(n_sm, clusters * cs);
    if (room < cpad) continue;
    const int su = cdiv(strips, min(room / cpad, strips)) * kBU;
    const int R = cdiv(U, su);
    if (R * cols > best) {
      best = R * cols;
      out[0] = cs, out[1] = cpad, out[2] = R, out[3] = su, out[4] = cpad / cs, out[5] = strips;
      out[6] = kSI;
    }
  }
  return best > 0 ? cudaSuccess : cudaErrorInvalidValue;  // I too wide for one wave
}

template <int D, typename MT>
cudaError_t launch(const void* mat, long long ld, const void* zu, const void* zi, void* yu,
                   void* yi, void* pu, void* pi, void* ctr, int U, int I, const int* p,
                   cudaStream_t stream) {
  using C = Cfg<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(dual_kernel<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap mmap;
  const bool i8 = sizeof(MT) == 1;
  if (!make_map(&mmap, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, mat,
                U, I, ld * (long long)sizeof(MT), kBU, kBI))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(dim3(p[1], p[2]), p[0], C::SMEM, stream, p[4] > 1 || p[2] > 1, attr);
  err = cudaLaunchKernelEx(&cfg, dual_kernel<D, MT>, mmap, static_cast<const float*>(zu),
                           static_cast<const float*>(zi),
                           static_cast<float*>(yu), static_cast<float*>(yi),
                           static_cast<float*>(pu), static_cast<float*>(pi),
                           static_cast<unsigned*>(ctr), U, I, p[3], p[4], p[2]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for (U, I, D) and the storage type on a card of n_sm SMs:
// out[0..6] = cluster size, column blocks (a multiple of it), row blocks R,
// U rows a row block owns, cluster groups G along I, 128-row strips of U,
// I columns a column block owns.
// Returns a cudaError_t (cudaErrorInvalidValue for an unsupported D).
int spmm_dual_plan(int U, int I, int D, int mat_is_int8, int n_sm, int* out) {
  if (U <= 0 || I <= 0 || n_sm <= 0) return (int)cudaErrorInvalidValue;
  switch (D * 2 + (mat_is_int8 ? 1 : 0)) {
    case 33: return (int)plan<16, int8_t>(U, I, n_sm, out);
    case 32: return (int)plan<16, bf16>(U, I, n_sm, out);
    case 65: return (int)plan<32, int8_t>(U, I, n_sm, out);
    case 64: return (int)plan<32, bf16>(U, I, n_sm, out);
    case 129: return (int)plan<64, int8_t>(U, I, n_sm, out);
    case 128: return (int)plan<64, bf16>(U, I, n_sm, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The widest I one launch takes on a card of n_sm SMs (clusters of one
// block, one wave); 0 with an error.
int spmm_dual_max_items(int D, int mat_is_int8, int n_sm) {
  int out[7];
  for (int cols = n_sm; cols > 0; --cols)
    if (spmm_dual_plan(1, cols * kSI, D, mat_is_int8, n_sm, out) == 0) return cols * kSI;
  return 0;
}

// (y_u, y_i) = (M @ bf16(z_i), Mᵀ @ bf16(z_u)). mat: (U, I) int8
// (mat_is_int8 = 1) or bf16, row stride ld elements (ld * itemsize a multiple
// of 16, mat 16-byte aligned); zu (U, D), zi (I, D) f32, contiguous, 16-byte
// aligned; yu (U, D), yi (I, D) f32; pu (G, U, D) when G > 1 and pi (R, I, D)
// when R > 1, f32 scratch; ctr the barrier's words; plan from spmm_dual_plan
// for the same U, I, D and type.
int spmm_dual_forward(const void* mat, int mat_is_int8, long long ld, const void* zu,
                      const void* zi, void* yu, void* yi, void* pu, void* pi, void* ctr, int U,
                      int I, int D, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (mat_is_int8 ? 1 : 0)) {
    case 33: return (int)launch<16, int8_t>(mat, ld, zu, zi, yu, yi, pu, pi, ctr, U, I, plan, s);
    case 32: return (int)launch<16, bf16>(mat, ld, zu, zi, yu, yi, pu, pi, ctr, U, I, plan, s);
    case 65: return (int)launch<32, int8_t>(mat, ld, zu, zi, yu, yi, pu, pi, ctr, U, I, plan, s);
    case 64: return (int)launch<32, bf16>(mat, ld, zu, zi, yu, yi, pu, pi, ctr, U, I, plan, s);
    case 129: return (int)launch<64, int8_t>(mat, ld, zu, zi, yu, yi, pu, pi, ctr, U, I, plan, s);
    case 128: return (int)launch<64, bf16>(mat, ld, zu, zi, yu, yi, pu, pi, ctr, U, I, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
