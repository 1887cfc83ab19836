// K1: dual-direction dense bipartite propagation in one pass over the 0/1
// adjacency M (U, I), stored int8, bf16 or packed int4 with a row stride `ld`
// (storage elements) whose bytes are a multiple of 16:
//
//     y_u = M  @ bf16(z_i)      (U, D) f32
//     y_i = Mᵀ @ bf16(z_u)      (I, D) f32
//
// z_u (U, D) and z_i (I, D) arrive in f32 and are rounded to bf16 (to
// nearest even) on chip; products are exact in f32 (M is 0/1, any int8
// or int4 value is exact in bf16) and sums are f32. D is 16, 32 or 64.
//
// Packed int4 (train.dense_store = "int4"): two cells a byte, cell 2j of a
// row in the low nibble of byte j and cell 2j + 1 in its high nibble, each a
// signed 4-bit integer; rows of ld bytes. The tensor map reads it as bytes
// (boxes of 128 rows x 32 bytes: the 64 cells of a sub-tile); each landed
// box is converted once into the same swizzled bf16 tile as int8's (nibble n
// -> the f32 2^23 + (n ^ 8), minus 2^23 + 8, exact), and everything after
// the conversion is the int8 path's: the plan does not depend on the
// storage, so on the same M y is bitwise int8's.
//
// Replaces diffmm_tpu/ops/pallas/spmm_dual.py::_dual_kernel (called from
// _dual_call). On the TPU the grid walks U row-blocks in order and y_i
// accumulates in VMEM across the grid; Hopper blocks run in parallel and in
// no order, so each direction is summed across blocks in a fixed order.
//
// Bound at tiktok shape (U 9,308, I 6,710, D 64, int8 M): 62.5 MB of M +
// 4.1 MB of f32 z + 4.1 MB of f32 y = 70.7 MB, 21.1 us at 3.35 TB/s; 16.0
// GFLOP of bf16 products, 16.2 us at 989 TFLOP/s. Packed int4: 31.3 MB of M,
// 11.8 us, under its products' 16.2 us. The dense demo's (60,000, 15,000)
// block: 900 MB of M, 0.28 ms.
//
// Design: one cooperative launch (the whole grid resident: it meets at grid
// barriers), one block of 512 threads an SM. Block (c, r) owns the I range
// [ni c, ni c + ni), ni = 64 nj with nj <= 6 sub-tiles, and the U range
// [su r, su r + su), su a multiple of 128, walked in strips of 128 rows, each
// strip in sub-tiles of 128 x 64.
// - First phase: every block rounds its share of z's rows to bf16 into a
//   scratch zb = [z_u; zeros to a strip; z_i], rows of 64 columns (zeros at d
//   >= D); the grid meets. From then on z arrives by TMA, already in the
//   swizzled rows wgmma reads as an MN-major A: each z row is rounded once,
//   not once for every block that reads it, and read as bf16.
// - The products put M's tile on the wide side, with zᵀ's 64 rows (D padded
//   with zero rows) as wgmma's A, so each product reads the tile once:
//   warpgroup 1 y_uᵀ[strip] += z_iᵀ[sub-tile] · Mᵀ (m64n128k16, B K-major),
//   warpgroup 0 y_iᵀ[sub-tile] += z_uᵀ[strip] · M (m64n64k16, B MN-major).
// - Warp-specialised, on mbarriers, no block-wide barrier in the steady loop:
//   thread 0 of warpgroup 2 issues the TMA loads in order (M's boxes into a
//   32 KB ring, evicted first from L2; z_u of strip s + 1 two sub-tiles into
//   strip s); warpgroup 3 converts each landed box once into a bf16 tile in
//   the 128-byte swizzle (int8 by the f32 magic-number trick), in a ring of
//   four tiles (bf16 M lands swizzled in a ring of six, unconverted); both
//   consumers wait on a tile's barrier, issue, and release it when their
//   products on it are done, so the conversion of the next tiles overlaps
//   the products. setmaxnreg gives warpgroup 0 the registers of y_iᵀ of the
//   block's columns (nj x 32 a thread), kept over the whole U range.
// - Each strip's y_uᵀ is staged in shared memory; warps 1-3 of warpgroup 2
//   store it, 16 bytes a thread, while warpgroup 1 goes on with the next
//   strip. y_i is staged the same way at the end.
// Cross-block sums, in a fixed order, no atomics on values: with C column
// blocks each writes its strips' y_u to Pu[c] (C, U, D); with R > 1 row
// blocks each writes its y_i to Pi[r] (R, I, D). Then the grid meets at a
// barrier (two words the kernel leaves reset) and sums Pu[0..C-1] and
// Pi[0..R-1] in that order, every block a slice. The plan (column blocks,
// sub-tiles a block, row blocks) comes from the shape and the card's SM
// count alone: it minimises an estimate of the launch's time from the
// busiest block's sub-tiles and the partial bytes written and read.
// Partial bytes per call: (C > 1 ? C : 0) U D 4 + (R > 1 ? R : 0) I D 4,
// written once and read once: at tiktok shape 54.9 MB (18 x 7 blocks of 384
// columns and 1,408 rows), with M's 62.5 MB and z's the most of the bytes the
// launch moves, so they bound it; the dense demo's block, 626 MB (40 x 3
// blocks). Measured on an H100 SXM at 700 W: 0.090-0.093 ms at tiktok shape
// (23% of its bound; the first phase about 8 us, the loop 49, the fold 19),
// 0.96 ms at the demo's block (29%). The result does not vary from run to
// run; it differs from the plain PyTorch version only by the f32 summation
// order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 512;   // warpgroups 0: y_i; 1: y_u; 2: the loads and y_u's stores; 3: M's conversion
constexpr int kBU = 128;        // U rows of a strip
constexpr int kBI = 64;         // I columns of a sub-tile (one 128-byte swizzle row of bf16)
constexpr int kNJ = 6;          // most sub-tiles of a block's I range
constexpr int kSI = kNJ * kBI;  // 384 I columns of the widest column block
constexpr int kMaxTiles = 6;    // bf16 sub-tiles in flight: 4 converted ones, or 6 of bf16 M
constexpr int kTile = kBU * kBI * 2;
constexpr int kZRows = 64 * 128;  // 64 rows of bf16 z, 64 columns (d) a row of 128 bytes
constexpr int kRing = 32 * 1024;  // bytes of the ring of M's boxes (int8, int4)
constexpr int kYld = kBU + 4;     // f32 row stride of a strip's staged y_uᵀ (64 rows of d)
constexpr int kIld = 64 + 4;      // f32 row stride of a sub-tile's staged y_i (64 rows of i)
// registers a thread of warpgroups 0-3 (setmaxnreg): together the launch's 4 x 128
constexpr int kRegI = 240, kRegU = 112, kRegLoad = 64, kRegConv = 96;

// M's storage types: int8_t, bf16 and Int4x2 (packed int4, two cells a
// byte); kBits a cell, kCells cells a storage element (what the tensor map
// counts in)
struct Int4x2 {};
template <typename MT>
struct Store {
  static constexpr int kBits = 8 * (int)sizeof(MT);
  static constexpr int kCells = 1;
};
template <>
struct Store<Int4x2> {
  static constexpr int kBits = 4;
  static constexpr int kCells = 2;
};

template <int D, typename MT>
struct Cfg {
  static constexpr bool kDirect = Store<MT>::kBits == 16;  // bf16 M lands swizzled in the tile ring
  static constexpr int kSlot = kBU * kBI * Store<MT>::kBits / 8;
  static constexpr int kStages = kDirect ? 1 : kRing / kSlot;
  static constexpr int kTiles = kDirect ? kMaxTiles : 4;
  static constexpr int OFF_RAW = kTiles * kTile;
  static constexpr int OFF_ZI = OFF_RAW + (kDirect ? 0 : kRing);  // z_i of the block's columns, bf16 rows
  static constexpr int OFF_ZU = OFF_ZI + kNJ * kZRows;              // z_u of two strips, bf16 rows
  static constexpr int OFF_Y = OFF_ZU + 2 * 2 * kZRows;            // a strip's y_uᵀ, staged for its stores
  static constexpr int SMEM = OFF_Y + 64 * kYld * 4 + 1024;         // + slack to align to 1,024
  static_assert(D == 16 || D == 32 || D == 64, "D must be 16, 32 or 64");
  static_assert(SMEM <= 232448 - 512, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}


__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}


// TMA: the box at (x, y) of a 2-D tensor map into shared dst, completing on
// bar, with the L2 policy `pol`
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int x, int y, uint64_t* bar,
                                       uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1, "
      "{%2, %3}], [%4], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// a global store of four f32 with the L2 policy `pol`
__device__ __forceinline__ void st_l2_v4(float* p, float a, float b, float c, float d, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p), "f"(a), "f"(b), "f"(c),
               "f"(d), "l"(pol)
               : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}


// wgmma descriptor, 128-byte swizzle: rows of 128 bytes, 8-row groups 1,024
// bytes apart. K-major operands take lbo 16 (unused); the MN-major B takes
// 1,024 in both fields: its N extent is one 64-element block, so only the
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

template <int N>
__device__ __forceinline__ void set_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// keeps the compiler from moving accesses to d across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define R64                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define O8(d, o)                                                                                 \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define O32(d) O8(d, 0), O8(d, 8), O8(d, 16), O8(d, 24)
#define O64(d) O32(d), O8(d, 32), O8(d, 40), O8(d, 48), O8(d, 56)

// y_uᵀ (64 x 128 f32) += A (64 x 16, MN-major: z_i's rows) @ B (16 x 128,
// K-major: M's tile), both from shared memory
__device__ __forceinline__ void mma_u(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64 ", %64, %65, p, 1, 1, 1, 0;\n}\n"
      : O64(d)
      : "l"(a), "l"(b), "r"(1));
}
// y_iᵀ (64 x 64 f32) += A (64 x 16, MN-major: z_u's rows) @ B (16 x 64,
// MN-major: M's tile)
__device__ __forceinline__ void mma_i(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32 ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : O32(d)
      : "l"(a), "l"(b), "r"(1));
}

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

// 8 int4 -> 8 bf16, exact: nibble k of w is cell k; with its sign bit
// flipped a nibble n becomes the f32 2^23 + (n ^ 8) (bits 0x4B00000x), minus
// 2^23 + 8
__device__ __forceinline__ uint4 cvt_nibbles(uint32_t w) {
  w ^= 0x88888888u;
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = __uint_as_float(0x4B000000u | ((w >> (8 * k)) & 0xFu)) - 8388616.0f;
    const float hi = __uint_as_float(0x4B000000u | ((w >> (8 * k + 4)) & 0xFu)) - 8388616.0f;
    o[k] = pack_bf16(lo, hi);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// byte offset of element (row, col) in a tile of 128-byte rows with the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)); col in bf16
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// generic-proxy writes to global memory ordered before later TMA reads
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Rows [first, last) of zb = [z_u; zeros to Up; z_i] (Up = U rounded up to
// a strip) as bf16 rows of 64 columns (zeros at d >= D): what the TMA loads
// into the swizzled rows wgmma reads as an MN-major A. Thread `me` of `n`
// takes 16-byte chunks c of a row (eight values), two at once, loads first.
template <int D>
__device__ __forceinline__ void z_to_bf16(bf16* __restrict__ zb, const float* __restrict__ zu,
                                          const float* __restrict__ zi, int U, int Up, int I, int first,
                                          int last, int me, int n) {
  const int items = (last - first) * 8;
  for (int e0 = me; e0 < items; e0 += 2 * n) {
    float4 v[2][2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = e0 + k * n, row = first + e / 8, c = e % 8;
      const float* src = row < U ? zu + (size_t)row * D : zi + (size_t)(row - Up) * D;
      const bool ok = e < items && 8 * c < D && (row < U || (row >= Up && row - Up < I));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[k][h] = ok ? __ldg(reinterpret_cast<const float4*>(src + 8 * c + 4 * h)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = e0 + k * n, row = first + e / 8, c = e % 8;
      if (e < items)
        *reinterpret_cast<uint4*>(zb + (size_t)row * 64 + 8 * c) =
            make_uint4(pack_bf16(v[k][0].x, v[k][0].y), pack_bf16(v[k][0].z, v[k][0].w),
                       pack_bf16(v[k][1].x, v[k][1].y), pack_bf16(v[k][1].z, v[k][1].w));
    }
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread 0 of the grid's blocks waits here until all have arrived: bar[0]
// counts arrivals, bar[1] the barriers passed. The launch is cooperative, so
// the blocks are resident together. The last block to arrive resets the
// count, so the next call finds it at zero. The block's other threads meet
// thread 0 at named barrier 1 before and after.
__device__ __forceinline__ void grid_arrive_wait(unsigned* bar) {
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
    dual_kernel(const __grid_constant__ CUtensorMap mmap, const __grid_constant__ CUtensorMap zmap,
                const float* __restrict__ zu, const float* __restrict__ zi, bf16* __restrict__ zb,
                float* __restrict__ yu, float* __restrict__ yi, float* __restrict__ pu,
                float* __restrict__ pi, unsigned* __restrict__ bar, int U, int I, int ni, int su, int G,
                int R) {
  using C = Cfg<D, MT>;
  constexpr int S = C::kStages;
  // rfull / rempty: a box of M landed / read by its converter; tfull /
  // tempty: a bf16 tile ready / read by both consumers; zifull: z_i of the
  // block's columns landed; zfull / zempty: a strip's z_u landed / read;
  // yfull / yempty: a strip's y_uᵀ staged / stored
  __shared__ __align__(8) uint64_t rfull[S], rempty[S], tfull[C::kTiles], tempty[C::kTiles], zifull, zfull[2],
      zempty[2], yfull, yempty;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023u) & ~1023u;  // the swizzle needs 1,024
  unsigned char* sm = smem_raw + (base - raw_u32);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g8 = lane / 4, q = lane % 4;
  const int c = blockIdx.x, r = blockIdx.y;
  const int Up = (U + kBU - 1) / kBU * kBU;  // z_i's first row in zb
  const int i0 = c * ni;
  const int iend = min(i0 + ni, I);
  const int nj = iend > i0 ? (iend - i0 + kBI - 1) / kBI : 0;
  const int u0 = r * su;
  const int uend = min(u0 + su, U);
  const int ns = (uend - u0 + kBU - 1) / kBU;  // at least 1: the plan's R = ceil(U / su)
  const int total = ns * nj;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&rfull[s], 1);
      mbar_init(&rempty[s], 128);
    }
    for (int k = 0; k < C::kTiles; ++k) {
      mbar_init(&tfull[k], C::kDirect ? 1 : 128);
      mbar_init(&tempty[k], 8);  // lane 0 of each consumer warp
    }
    mbar_init(&zifull, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(&zfull[b], 1);
      mbar_init(&zempty[b], 4);
    }
    mbar_init(&yfull, 128);
    mbar_init(&yempty, 96);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // sub-tile t (strip t / nj, column block t % nj): M's box into its ring
  // slot, or for bf16 M swizzled into its tile; by thread 0 of warpgroup 2.
  // M's boxes are read once (evicted first), z's rows by many blocks.
  const uint64_t pol_m = evict_first_policy(), pol_z = evict_last_policy();
  auto issue = [&](int t) {
    const int x = (i0 + (t % nj) * kBI) / Store<MT>::kCells, y = u0 + (t / nj) * kBU;
    if constexpr (C::kDirect) {
      uint64_t* b = &tfull[t % C::kTiles];
      mbar_expect_tx(b, kTile);
      tma_2d(base + (t % C::kTiles) * kTile, &mmap, x, y, b, pol_m);
    } else {
      uint64_t* b = &rfull[t % S];
      mbar_expect_tx(b, C::kSlot);
      tma_2d(base + C::OFF_RAW + (t % S) * C::kSlot, &mmap, x, y, b, pol_m);
    }
  };
  // strip s's z_u (128 rows of zb) into buffer s % 2
  auto issue_zu = [&](int s) {
    uint64_t* b = &zfull[s & 1];
    mbar_expect_tx(b, 2 * kZRows);
    for (int h = 0; h < 2; ++h)
      tma_2d(base + C::OFF_ZU + ((s & 1) * 2 + h) * kZRows, &zmap, 0, u0 + s * kBU + 64 * h, b, pol_z);
  };
  constexpr int kAhead = C::kDirect ? C::kTiles : S;  // boxes in flight before the first conversion

  // z rounded to bf16 once: this block's rows of zb; then the grid meets, so
  // that every block's z rows are written before any block loads them
  {
    const int nb = gridDim.x * gridDim.y, b = r * gridDim.x + c;
    const int rows = Up + I, per = (rows + nb - 1) / nb;
    z_to_bf16<D>(zb, zu, zi, U, Up, I, min(b * per, rows), min(b * per + per, rows), tid, kThreads);
    __threadfence();  // every writer's rows visible on the card before the barrier
    fence_proxy_async_global();
    __syncthreads();
    if (tid == 0) grid_arrive_wait(bar);
    __syncthreads();
  }
  // M's first boxes (not earlier: the first phase has HBM to itself), z_i of
  // the block's columns, z_u of its first strip
  if (tid == 2 * 128)
    for (int t = 0; t < min(total, kAhead); ++t) issue(t);
  if (tid == 2 * 128 && nj > 0) {
    fence_proxy_async_global();
    mbar_expect_tx(&zifull, nj * kZRows);
    for (int j = 0; j < nj; ++j) tma_2d(base + C::OFF_ZI + j * kZRows, &zmap, 0, Up + i0 + j * kBI, &zifull, pol_z);
    issue_zu(0);
  }

  // The end of every role: the partial sums of the column blocks (y_u) and
  // of the row blocks (y_i), summed by the whole grid in a fixed order.
  auto finish = [&]() {
    if (G > 1 || R > 1) {
      __threadfence();  // every writer's partials visible on the card before the barrier
      named_bar(1, kThreads);
      if (tid == 0) grid_arrive_wait(bar);
      named_bar(1, kThreads);
      const long long step = (long long)gridDim.x * gridDim.y * kThreads;
      const long long first = ((long long)r * gridDim.x + c) * kThreads + tid;
      if (G > 1)
        fold(reinterpret_cast<const float4*>(pu), (long long)U * D / 4, reinterpret_cast<float4*>(yu),
             (long long)U * D / 4, G, first, step);
      if (R > 1)
        fold(reinterpret_cast<const float4*>(pi), (long long)I * D / 4, reinterpret_cast<float4*>(yi),
             (long long)I * D / 4, R, first, step);
    }
  };

  const int wg = tid / 128, wt = tid % 128, w = wt / 32;
  if (wg == 2) {
    // ---- warpgroup 2: its thread 0 issues the loads, in order: each box of
    // M once its ring slot is read (bf16 M: once both consumers are done
    // with the tile it replaces), and z_u of strip zs two sub-tiles into
    // strip zs - 1, once warpgroup 0 is done with strip zs - 2: by then every
    // sub-tile that strip needs is issued
    set_regs_dec<kRegLoad>();
    if (wt >= 32) {
      // warps 1-3: each strip's y_u (or its Pu[c] partial) from the staged
      // y_uᵀ, four columns of d a 16-byte store, whole rows a warp
      float* dst = G > 1 ? pu + (size_t)c * U * D : yu;
      const float* ys = reinterpret_cast<const float*>(sm + C::OFF_Y);
      const uint64_t pol = evict_last_policy();  // Pu stays in L2 for the fold
      for (int s = 0; s < ns; ++s) {
        mbar_wait(&yfull, s & 1);
        // a warp's store: 8 rows x 4 float4 columns (2-way bank conflicts
        // on the staged rows, full 32-byte sectors on the stores)
        for (int gi = wt / 32 - 1; gi < kBU / 8 * (D / 16); gi += 3) {
          const int ul = gi % (kBU / 8) * 8 + lane % 8, d = 4 * (gi / (kBU / 8) * 4 + lane / 8);
          const float* p = ys + d * kYld + ul;
          const int u = u0 + s * kBU + ul;
          if (u < uend) st_l2_v4(dst + (size_t)u * D + d, p[0], p[kYld], p[2 * kYld], p[3 * kYld], pol);
        }
        mbar_arrive(&yempty);
      }
    } else if (tid == 2 * 128 && nj > 0) {
      int zs = 1;
      for (int t = kAhead; t < total + kAhead; ++t) {
        for (; zs < ns && t - kAhead >= (zs - 1) * nj + 2; ++zs) {
          if (zs >= 2) mbar_wait(&zempty[zs & 1], ((zs - 2) >> 1) & 1);
          issue_zu(zs);
        }
        if (t < total) {
          if constexpr (C::kDirect)
            mbar_wait(&tempty[t % C::kTiles], ((t - C::kTiles) / C::kTiles) & 1);
          else
            mbar_wait(&rempty[t % S], ((t - S) / S) & 1);
          issue(t);
        }
      }
      for (; zs < ns; ++zs) {
        if (zs >= 2) mbar_wait(&zempty[zs & 1], ((zs - 2) >> 1) & 1);
        issue_zu(zs);
      }
    }
    finish();
  } else if (wg == 3) {
    // ---- warpgroup 3: each landed box of M converted once into its bf16 tile
    set_regs_dec<kRegConv>();
    if constexpr (!C::kDirect) {
      for (int t = 0; t < total; ++t) {
        const int slot = t % S, ts = t % C::kTiles;
        mbar_wait(&rfull[slot], (t / S) & 1);
        if (t >= C::kTiles) mbar_wait(&tempty[ts], ((t / C::kTiles) + 1) & 1);
        const unsigned char* src = sm + C::OFF_RAW + slot * C::kSlot;
        unsigned char* dst = sm + ts * kTile;
        constexpr int kPer = C::kSlot / 16 / 128;  // 16-byte chunks of the box a thread takes
        uint4 v[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) v[k] = reinterpret_cast<const uint4*>(src)[wt + k * 128];
        mbar_arrive(&rempty[slot]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = wt + k * 128;
          if constexpr (Store<MT>::kBits == 4) {
            const int row = e / 2, col = (e % 2) * 32;
            *reinterpret_cast<uint4*>(dst + swz(row, col)) = cvt_nibbles(v[k].x);
            *reinterpret_cast<uint4*>(dst + swz(row, col + 8)) = cvt_nibbles(v[k].y);
            *reinterpret_cast<uint4*>(dst + swz(row, col + 16)) = cvt_nibbles(v[k].z);
            *reinterpret_cast<uint4*>(dst + swz(row, col + 24)) = cvt_nibbles(v[k].w);
          } else {
            const int row = e / 4, col = (e % 4) * 16;
            uint4 lo, hi;
            cvt_chunk(v[k], lo, hi);
            *reinterpret_cast<uint4*>(dst + swz(row, col)) = lo;
            *reinterpret_cast<uint4*>(dst + swz(row, col + 8)) = hi;
          }
        }
        fence_proxy_async();
        mbar_arrive(&tfull[ts]);
      }
    }
    finish();
  } else if (wg == 1) {
    // ---- warpgroup 1: y_uᵀ of each strip, into y_u or Pu[c]
    set_regs_dec<kRegU>();
    if (nj > 0) mbar_wait(&zifull, 0);
    float* ys = reinterpret_cast<float*>(sm + C::OFF_Y);
    const int d0 = 16 * w + g8;
    float acc[64];
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[k] = 0.f;
      for (int j = 0; j < nj; ++j) {
        const int t = s * nj + j, ts = t % C::kTiles;
        mbar_wait(&tfull[ts], (t / C::kTiles) & 1);
        const uint32_t tile = base + ts * kTile;
        const uint32_t zit = base + C::OFF_ZI + j * kZRows;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_u(acc, sw128_desc(zit + 2048 * kk, 1024), sw128_desc(tile + 32 * kk, 16));
        wgmma_commit();
        wgmma_wait<1>();
        if (lane == 0 && j > 0) mbar_arrive(&tempty[(t - 1) % C::kTiles]);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0 && nj > 0) mbar_arrive(&tempty[(s * nj + nj - 1) % C::kTiles]);
      // acc: y_uᵀ of the strip, thread (w, g8, q) rows d = 16 w + g8 (+ 8),
      // columns u = 8 n + 2 q (+ 1), staged for warpgroup 2's stores once it
      // has stored the last strip
      if (s >= 1) mbar_wait(&yempty, (s - 1) & 1);
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(ys + (d0 + 8 * h) * kYld + 8 * n + 2 * q) =
              make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
      mbar_arrive(&yfull);
    }
    finish();
  } else {
    // ---- warpgroup 0: y_iᵀ of the block's columns over its U range
    set_regs_inc<kRegI>();
    float acc[kNJ][32];
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[j][k] = 0.f;
    if (nj > 0) {
      for (int s = 0; s < ns; ++s) {
        const int zb2 = s & 1;
        mbar_wait(&zfull[zb2], (s >> 1) & 1);
        const uint32_t zut = base + C::OFF_ZU + zb2 * 2 * kZRows;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          if (j < nj) {
            const int t = s * nj + j, ts = t % C::kTiles;
            mbar_wait(&tfull[ts], (t / C::kTiles) & 1);
            const uint32_t tile = base + ts * kTile;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              mma_i(acc[j], sw128_desc(zut + 2048 * kk, 1024), sw128_desc(tile + 2048 * kk, 1024));
            wgmma_commit();
            if (j == nj - 1) {
              wgmma_wait<0>();
            } else {
              wgmma_wait<1>();
            }
            if (lane == 0) {
              if (j > 0) mbar_arrive(&tempty[(t - 1) % C::kTiles]);
              if (j == nj - 1) {
                mbar_arrive(&tempty[ts]);
                mbar_arrive(&zempty[zb2]);
              }
            }
          }
        }
      }
    }
    // every product is done (the loop's last wait is wgmma_wait<0>, but only
    // at run time: without this one ptxas serialises the products)
    wgmma_wait<0>();
    // y_iᵀ of sub-tile j: thread (w, g8, q) rows d = 16 w + g8 (+ 8), columns
    // i = 64 j + 8 n + 2 q (+ 1); each sub-tile staged as rows of i in the
    // z_u buffers (read by no one now), then stored 16 bytes a thread
    float* dst = R > 1 ? pi + (size_t)r * I * D : yi;
    float* st = reinterpret_cast<float*>(sm + C::OFF_ZU);  // 64 rows of i, stride kIld
    const uint64_t pol = evict_last_policy();  // Pi stays in L2 for the fold
    const int d0 = 16 * w + g8;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) reg_fence(acc[j]);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      if (j < nj) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            st[(8 * n + 2 * q) * kIld + d0 + 8 * h] = acc[j][4 * n + 2 * h];
            st[(8 * n + 2 * q + 1) * kIld + d0 + 8 * h] = acc[j][4 * n + 2 * h + 1];
          }
        named_bar(4, 128);
        for (int e = wt; e < 64 * (D / 4); e += 128) {
          const int il = e / (D / 4), d = 4 * (e % (D / 4)), i = i0 + 64 * j + il;
          const float4 v = *reinterpret_cast<const float4*>(st + il * kIld + d);
          if (i < iend) st_l2_v4(dst + (size_t)i * D + d, v.x, v.y, v.z, v.w, pol);
        }
        named_bar(4, 128);
      }
    }
    finish();
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

// 2-D map over rows x cols elements, row stride ld_bytes, boxes of box_rows
// x box_cols, zero fill outside; swizzled 128 bytes or not
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, long long rows,
              long long cols, long long ld_bytes, int box_rows, int box_cols, bool swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// rows of the bf16 copy of z: z_u's, rounded up to a strip, then z_i's
int zb_rows(int U, int I) { return cdiv(U, kBU) * kBU + I; }

// a cooperative launch: the blocks are resident together (the kernel's grid
// barriers need that)
cudaLaunchConfig_t config(dim3 grid, size_t smem, cudaStream_t stream, cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan's estimate of a launch's time, in seconds on a card of n_sm SMs:
// the busiest block's sub-tiles at its share of HBM (an int8 box of 8 KB,
// whatever the storage, so every storage takes the same plan), and the
// partial sums written and read back at HBM's rate.
constexpr double kHbm = 3.0e12;

// plan[0..6] = 1 (blocks of a cluster: the launch has none), C, R, su, G = C
// (the partials of y_u), strips, ni (see the top of the file)
template <int D, typename MT>
cudaError_t plan(int U, int I, int n_sm, int* out) {
  using C = Cfg<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(dual_kernel<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dual_kernel<D, MT>, kThreads, C::SMEM);
  if (err != cudaSuccess) return err;
  const int fits = min(n_sm, per_sm * n_sm);  // one wave: the grid meets at barriers
  const int subs = cdiv(I, kBI);
  const int strips = cdiv(U, kBU);
  double best = 0.0;
  bool found = false;
  for (int nj = 1; nj <= kNJ; ++nj) {
    const int cols = cdiv(subs, nj);
    if (cols > fits) continue;
    const int per = cdiv(strips, min(fits / cols, strips));  // strips a row block
    const int R = cdiv(strips, per);
    const double part = ((cols > 1 ? (double)cols * U : 0.0) + (R > 1 ? (double)R * I : 0.0)) * D * 4;
    const double cost = (double)per * nj * kBU * kBI / (kHbm / n_sm) + 2.0 * part / kHbm;
    if (!found || cost < best) {
      found = true;
      best = cost;
      out[0] = 1, out[1] = cols, out[2] = R, out[3] = per * kBU, out[4] = cols, out[5] = strips;
      out[6] = nj * kBI;
    }
  }
  return found ? cudaSuccess : cudaErrorInvalidValue;  // I too wide for one wave
}

template <int D, typename MT>
cudaError_t launch(const void* mat, long long ld, const void* zu, const void* zi, void* zb, void* yu,
                   void* yi, void* pu, void* pi, void* ctr, int U, int I, const int* p,
                   cudaStream_t stream) {
  using C = Cfg<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(dual_kernel<D, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap mmap;
  // one storage element: a byte (int8, or two int4 cells) or a bf16
  constexpr int kCells = Store<MT>::kCells;
  constexpr int kElem = Store<MT>::kBits * kCells / 8;
  if (!make_map(&mmap, kElem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                mat, U, cdiv(I, kCells), ld * kElem, kBU, kBI / kCells, C::kDirect))
    return cudaErrorInvalidValue;
  // zb: z rounded to bf16 in the launch's first phase, rows of 64 columns
  CUtensorMap zmap;
  if (!make_map(&zmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, zb, zb_rows(U, I), 64, 128, 64, 64, true))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(dim3(p[1], p[2]), C::SMEM, stream, attr);
  err = cudaLaunchKernelEx(&cfg, dual_kernel<D, MT>, mmap, zmap, static_cast<const float*>(zu),
                           static_cast<const float*>(zi), static_cast<bf16*>(zb),
                           static_cast<float*>(yu), static_cast<float*>(yi),
                           static_cast<float*>(pu), static_cast<float*>(pi),
                           static_cast<unsigned*>(ctr), U, I, p[6], p[3], p[4], p[2]);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instances for the storage kind: 0 bf16, 1 int8, 2 packed int4
template <int D>
cudaError_t plan_kind(int kind, int U, int I, int n_sm, int* out) {
  switch (kind) {
    case 0: return plan<D, bf16>(U, I, n_sm, out);
    case 1: return plan<D, int8_t>(U, I, n_sm, out);
    case 2: return plan<D, Int4x2>(U, I, n_sm, out);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_kind(int kind, const void* mat, long long ld, const void* zu, const void* zi,
                        void* zb, void* yu, void* yi, void* pu, void* pi, void* ctr, int U, int I,
                        const int* p, cudaStream_t stream) {
  switch (kind) {
    case 0: return launch<D, bf16>(mat, ld, zu, zi, zb, yu, yi, pu, pi, ctr, U, I, p, stream);
    case 1: return launch<D, int8_t>(mat, ld, zu, zi, zb, yu, yi, pu, pi, ctr, U, I, p, stream);
    case 2: return launch<D, Int4x2>(mat, ld, zu, zi, zb, yu, yi, pu, pi, ctr, U, I, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The launch plan for (U, I, D) and the storage kind (0 bf16, 1 int8, 2
// packed int4) on a card of n_sm SMs: out[0..6] = blocks of a cluster (1),
// column blocks C, row blocks R, U rows a row block owns, partials of y_u G
// (= C), 128-row strips of U, I columns a column block owns.
// Returns a cudaError_t (cudaErrorInvalidValue for an unsupported D).
int spmm_dual_plan(int U, int I, int D, int mat_kind, int n_sm, int* out) {
  if (U <= 0 || I <= 0 || n_sm <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)plan_kind<16>(mat_kind, U, I, n_sm, out);
    case 32: return (int)plan_kind<32>(mat_kind, U, I, n_sm, out);
    case 64: return (int)plan_kind<64>(mat_kind, U, I, n_sm, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rows of the bf16 scratch zb a launch over (U, I) takes.
int spmm_dual_zb_rows(int U, int I) { return zb_rows(U, I); }

// The widest I one launch takes on a card of n_sm SMs (column blocks of the
// widest range, one wave); 0 with an error.
int spmm_dual_max_items(int D, int mat_kind, int n_sm) {
  int out[7];
  for (int cols = n_sm; cols > 0; --cols)
    if (spmm_dual_plan(1, cols * kSI, D, mat_kind, n_sm, out) == 0) return cols * kSI;
  return 0;
}

// (y_u, y_i) = (M @ bf16(z_i), Mᵀ @ bf16(z_u)). mat: (U, I) bf16 (mat_kind
// 0), int8 (1) or packed int4 (2: (U, ceil(I / 2)) bytes, see the top of the
// file), row stride ld storage elements (its bytes a multiple of 16, mat
// 16-byte aligned); zu (U, D), zi (I, D) f32, contiguous, 16-byte aligned;
// yu (U, D), yi (I, D) f32; zb (spmm_dual_zb_rows(U, I), 64) bf16 scratch,
// 16-byte aligned; pu (G, U, D) when G > 1 and pi (R, I, D) when R > 1, f32
// scratch; ctr the grid barrier's two words (zero before the first call; the
// kernel leaves them so); plan from spmm_dual_plan for the same U, I, D and
// kind.
int spmm_dual_forward(const void* mat, int mat_kind, long long ld, const void* zu,
                      const void* zi, void* zb, void* yu, void* yi, void* pu, void* pi, void* ctr,
                      int U, int I, int D, const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_kind<16>(mat_kind, mat, ld, zu, zi, zb, yu, yi, pu, pi, ctr, U, I, plan, s);
    case 32: return (int)launch_kind<32>(mat_kind, mat, ld, zu, zi, zb, yu, yi, pu, pi, ctr, U, I, plan, s);
    case 64: return (int)launch_kind<64>(mat_kind, mat, ld, zu, zi, zb, yu, yi, pu, pi, ctr, U, I, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
