// K2 and K3: the single-hidden-layer denoiser forward of the rebuild's
// reverse loop, with f32 accuracy (the rebuild's per-user top-k over these
// scores decides the graph edges):
//
//     K2 (denoise_layer1): h   = tanh(x @ W1x + temb_proj)   b1 folded into temb_proj
//     K3 (denoise_layer2): out = h @ W2 + b2
//
// x (B, K), temb_proj (B, H), h (B, H), b2 (N,) and the outputs are f32,
// row-major. The weights W1x (K, H) and W2 (H, N) arrive prepared once per
// rebuild (ops/kernels/denoise_mlp.py::prepare_weight): Wp (2, Kt, Np, 32)
// f32 holds hi = tf32(W^T) in [0] and lo = W^T - hi (exact in f32) in [1],
// K cut into Kt = ceil(K / 32) slabs of 32 and zero-padded, N padded to Np,
// a multiple of 128, with zero rows. In row n of a slab, stored position
// ((p / 4) ^ (n % 8)) * 4 + p % 4 holds contraction index perm(p) =
// 8 * (p % 4) + 2 * (p / 8) + (p % 8) / 4 of the slab: the 128-byte swizzle
// that wgmma's shared-memory operands take, and a permutation of each slab
// under which every thread's A fragment is 8 consecutive floats of a row.
//
// Replaces diffmm_tpu/ops/pallas/denoise_mlp.py::_layer1_kernel (K2) and
// _layer2_kernel (K3), both called from fused_denoise_mlp. The TPU version
// gets f32 from a bf16 matrix unit by multiple passes; this one does the
// same on Hopper's TF32 tensor cores (3xTF32): with a = a_hi + a_lo and
// b = b_hi + b_lo, a*b = a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, dropping only
// a_lo*b_lo (about 2^-22 relative).
//
// Two forms of one 3xTF32 GEMM, picked by the host from the contraction
// depth alone (ops/kernels/denoise_mlp.py::denoise_form): the gemm form
// (gemm_3xtf32) for a deep contraction, the strip form (strip_3xtf32) for
// one of at most 64 (K3 at a hidden width of 64, web scale's).
//
// Bound at the rebuild's shape (B 1,024, H 1,024, I 6,710 / 20,000): the
// function is 2 x B x I x H = 14.1 / 41.9 GFLOP of f32 products per launch,
// 0.028 / 0.085 ms at 495 TFLOP/s, the card's fastest rate for f32
// operands (TF32); it moves about 63 / 172 MB, 0.019 / 0.051 ms at
// 3.35 TB/s, so it is compute-bound. This design does three TF32 products
// per f32 one: its own bound is 0.085 / 0.254 ms (f32 FMA on the CUDA
// cores: 0.210 / 0.626 ms). At H 64 the same function is store-bound:
// K3 at (B 512, H 64, N 100,000) writes 204.8 MB of its 230.9 MB, 0.069 ms
// at 3.35 TB/s, against 0.040 ms for its 3 x 6.6 GFLOP of TF32 products.
//
// The gemm form. A block owns a 128 x BN output tile, two warpgroups of 64 rows
// (BN 128, or 104 where that takes no more waves of blocks:
// denoise_tile_n).
// - A ring of kStages weight tiles (hi and lo, 32 deep, BN x 128 bytes) in
//   shared memory, filled by bulk asynchronous copies (cp.async.bulk, one
//   contiguous piece each, thanks to the prepared layout) that
//   complete on the slot's "full" mbarrier. Thread 0 issues them: the
//   first kStages at the start, then at each tile the refill of the slot
//   the previous tile used, once all eight warps have arrived on its
//   "empty" mbarrier. (A producer warp of its own would cost the block a
//   warpgroup's registers: ptxas then allowed 168 a thread and spilled.)
// - A (x for K2, h for K3) is not prepared: x changes every step, and its
//   rows (6,710 floats at tiktok's catalog) do not start on 16-byte
//   boundaries, which TMA needs. Each thread loads its own wgmma A fragment
//   from global memory straight into registers (vectors of 4, 2 or 1
//   floats, the widest the row length and base allow; zero past B and K)
//   and splits it there: hi = cvt.rna.tf32, lo = a - hi. Software
//   pipeline: while tile i's wgmmas run, tile i + 1's fragment is split
//   into the other register set and tile i + 2's is loaded. wgmma reads A
//   from registers and B from shared memory (K-major, 128-byte swizzle),
//   m64nBNk8, three per 8-deep step.
// - The tensor cores add in f32 with truncation; summed over thousands of
//   products that error reaches about 3e-4 (tests/test_torch_denoise_split.py
//   emulates it). So each 32-deep tile's products go into a fresh register
//   accumulator, added to the running f32 sum with a rounded add after the
//   tile, and within the tile the hi*lo and lo*hi terms come first, so the
//   large hi*hi terms meet only 4 truncating adds: the error stays at the
//   f32 product's order.
// - Split-K: K2's output (1,024 x 1,024) makes only 64 tiles for 132 SMs,
//   so the caller may split the contraction into `splits` ranges of whole
//   tiles (grid z); each writes raw f32 partials and a second pass sums
//   them in a fixed order and applies the epilogue. No atomics anywhere:
//   the result is the same bits from run to run.
// - The epilogue (tanhf, not tanh.approx: its 2^-11 error would break the
//   tolerance) is a template parameter, applied from registers, stores
//   masked at the ragged B and N edges.
//
// The strip form (K <= 64: one or two 32-deep slabs). A tile's wgmma chain
// is two steps, so a tile's time is its store, and the gemm form (one
// 128 KB ring a block, one block an SM, no overlap of a tile's store with
// anything, 4-byte stores in wgmma's fragment layout) ran at 20% of the
// bound there (0.348 ms on an H100 SXM at 700 W, where this form takes
// 0.130 ms, 53%; chip_smoke.py, PERF.md). Instead:
// - A persistent grid, one block an SM, each block a contiguous run of the
//   (column strip, 128-row tile) units, row tiles fastest. A strip's whole
//   weight (BN 128 columns, hi and lo, at most 64 KB) is loaded once by
//   bulk copies and serves every row tile of the run; the strip's bias
//   goes to shared memory beside it.
// - The arithmetic is the gemm form's, step for step (the same wgmmas in
//   the same order, the same rounded add a slab, the same epilogue add):
//   the two forms give the same bits.
// - A's fragments of the next tile (h's rows, L2-resident) are loaded
//   while this tile's output leaves.
// - Each warpgroup stages its 64 x 128 tile in shared memory (rows padded
//   to 136 floats, so a warp's float2 writes of 4 rows meet no bank
//   conflict), two buffers, so one tile's store overlaps the next tile's
//   products. Where the output rows are 16-byte aligned (N % 4 == 0) each
//   row leaves as one bulk copy (cp.async.bulk, shared to global, issued by
//   one thread a row); else the warps store it with 16-byte vectors and a
//   scalar head and tail a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;   // output rows of a block: two warpgroups of 64
constexpr int kBK = 32;    // contraction depth of a tile: one 128-byte row
constexpr int kPadN = 128;  // the prepared weights' N padding
constexpr int kStages = 4;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// output columns of a block (the tile width BN): 128, or 104 where that
// takes no more waves of blocks (denoise_tile_n)
constexpr int kWidths[2] = {128, 104};

// shared memory of a block: the ring (hi and lo tiles of BN rows of 128
// bytes) + slack to align it to 1,024
constexpr int smem_bytes(int bn) { return kStages * 2 * bn * kBK * 4 + 1024; }

// The strip form: strips of kStripN columns, a weight of at most
// kStripMaxKt slabs, each warpgroup's 64-row tile staged in rows of
// kStageLd floats, two buffers a warpgroup
constexpr int kStripN = 128;
constexpr int kStripMaxKt = 2;
constexpr int kStageLd = kStripN + 8;
constexpr int kStageFloats = 64 * kStageLd;
constexpr int kSlabBytes = kStripN * kBK * 4;  // one half (hi or lo) of a slab
// the weight (1,024-aligned for the swizzle), 2 x 2 staging buffers, the bias
constexpr int kStripSmem = 1024 + kStripMaxKt * 2 * kSlabBytes + 4 * kStageFloats * 4 + kStripN * 4;

// kNone stores the raw product: K2's partial x_s @ W1x_s over one catalog
// shard of a model axis, whose tanh can only follow the sum over the shards
enum Epilogue { kTanhAddend = 0, kBias = 1, kNone = 2 };

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
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

// bytes from global src to shared dst, completing on barrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// f rounded to TF32, to nearest with ties away from zero, in f32 bits
__device__ __forceinline__ uint32_t tf32_hi(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r & 0xffffe000u;
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled rows of 128
// bytes: 8-row groups 1,024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// bytes from shared src to global dst (both 16-byte aligned, bytes a
// multiple of 16), in this thread's current bulk group
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until all but this thread's newest N bulk groups have read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// orders this thread's shared-memory writes before later bulk copies' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// the 128 threads of warpgroup wg (barriers 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses to d across the asynchronous wgmma
// (and, for the A fragments, from computing them between wgmma.fence and
// the wgmma, where ptxas would insert another warpgroup.arrive)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A's wgmma fragments of one 32-deep tile, split: hi and lo TF32 of each
// of the 4 steps
struct Frag {
  uint32_t hi[4][4], lo[4][4];
};

__device__ __forceinline__ void frag_fence(Frag& f) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f.hi[s][j]), "+r"(f.lo[s][j])::"memory");
}

// d (64 x BN, f32) = A (64 x 8, TF32 in registers) @ B (8 x BN, TF32 in
// shared memory) + (accumulate ? d : 0): wgmma m64nBNk8, one per tile width
template <int BN>
struct Wgmma;
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Wgmma<104> {
  static __device__ __forceinline__ void run(float (&d)[52], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
  }
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  typedef float T;
};
template <>
struct Vec<2> {
  typedef float2 T;
};
template <>
struct Vec<4> {
  typedef float4 T;
};

// v = row m of A (M, K), columns [k, k + 8); zeros past M and K (K % V == 0)
template <int V>
__device__ __forceinline__ void load_a(float (&v)[8], const float* __restrict__ A, int m, int M,
                                       int k, int K) {
#pragma unroll
  for (int j = 0; j < 8; j += V) {
    if (m < M && k + j < K) {
      const typename Vec<V>::T t =
          *reinterpret_cast<const typename Vec<V>::T*>(A + (size_t)m * K + k + j);
      const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
      for (int i = 0; i < V; ++i) v[j + i] = f[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j + i] = 0.0f;
    }
  }
}

// E is the (M, N) addend of kTanhAddend or the (N,) bias of kBias; kNone
// reads no E.
template <Epilogue EPI>
__device__ __forceinline__ float epilogue(float v, const float* E, int m, int n, int N) {
  if constexpr (EPI == kNone) return v;
  else if constexpr (EPI == kTanhAddend) return tanhf(v + E[(size_t)m * N + n]);
  else return v + E[n];
}

// C (M, N) = epilogue(A (M, K) @ W (K, N)) over the contraction tiles of
// blockIdx.z (kt_split tiles of 32); with gridDim.z > 1 the raw sums go to
// part[z] (M, N) instead. Wp is W prepared (see the top of the file). A
// block computes rows [128 blockIdx.x, + 128) and columns [BN blockIdx.y,
// + BN).
template <int V, int BN, Epilogue EPI>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_3xtf32(const float* __restrict__ A, const float* __restrict__ Wp,
                const float* __restrict__ E, float* __restrict__ C, float* __restrict__ part,
                int M, int N, int K, int kt_split) {
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t ring = (smem_u32(dyn_smem) + 1023u) & ~1023u;  // the swizzle needs 1,024

  const int Kt = (K + kBK - 1) / kBK;
  constexpr int kTileBytes = BN * kBK * 4;  // one half (hi or lo) of a weight tile
  const int Np = (N + kPadN - 1) / kPadN * kPadN;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  // rows of the weight tile that the padded weight holds (all but maybe
  // the last tile's); the rest of the slot is never read into a stored
  // column
  const int tile_bytes = min(BN, Np - n0) * kBK * 4;
  const int kt0 = blockIdx.z * kt_split;
  const int nt = max(0, min(Kt, kt0 + kt_split) - kt0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // weight tile i (hi and lo) into its slot of the ring, by one thread
  const size_t half = (size_t)Kt * Np * kBK;  // floats of one of the hi/lo halves
  auto fill = [&](int i) {
    const int slot = i % kStages;
    const uint32_t bar = smem_u32(&full[slot]);
    const uint32_t dst = ring + slot * 2 * kTileBytes;
    const float* src = Wp + ((size_t)(kt0 + i) * Np + n0) * kBK;
    mbar_expect_tx(bar, 2 * tile_bytes);
    bulk_load(dst, src, tile_bytes, bar);
    bulk_load(dst + kTileBytes, src + half, tile_bytes, bar);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(nt, kStages); ++i) fill(i);

  // warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile; a thread's A
  // fragment rows are r0 and r1, its 8 floats of a tile start at column
  // 8 q (the slab permutation puts them in step order)
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = m0 + 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) + g;
  const int r1 = r0 + 8;

  constexpr int kAcc = BN / 2;  // accumulators of a thread
  float acc[kAcc], tile_acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = tile_acc[i] = 0.0f;
  // x's raw values of the next tile to split (v0: row r0, v1: row r1)
  float v0[8], v1[8];
  auto load_tile = [&](int i) {
    load_a<V>(v0, A, r0, M, (kt0 + i) * kBK + 8 * q, K);
    load_a<V>(v1, A, r1, M, (kt0 + i) * kBK + 8 * q, K);
  };
  // v0/v1 split into f, in registers: the fragment of step s is (r0, 2s),
  // (r1, 2s), (r0, 2s + 1), (r1, 2s + 1)
  auto split_into = [&](Frag& f) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float a[4] = {v0[2 * s], v1[2 * s], v0[2 * s + 1], v1[2 * s + 1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f.hi[s][j] = tf32_hi(a[j]);
        f.lo[s][j] = __float_as_uint(a[j] - __uint_as_float(f.hi[s][j]));
      }
    }
    frag_fence(f);
  };

  // Tile i on the fragments in cur, while the next tile's are split into
  // nxt and the one after is loaded; then the tile's sum is added to acc.
  auto step = [&](int i, Frag& cur, Frag& nxt) {
    // thread 0 refills the slot of tile i - 1 once all warps are done with it
    if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < nt) {
      mbar_wait(smem_u32(&empty[(i - 1) % kStages]), ((i - 1) / kStages) & 1);
      fill(i - 1 + kStages);
    }
    const int slot = i % kStages;
    mbar_wait(smem_u32(&full[slot]), (i / kStages) & 1);
    const uint32_t bhi = ring + slot * 2 * kTileBytes;
    const uint32_t blo = bhi + kTileBytes;
    reg_fence(tile_acc);
    frag_fence(cur);
    wgmma_fence();
    // the small terms first: the tensor cores truncate each add to the
    // accumulator, so the large ones come last, in 4 adds instead of 12
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      Wgmma<BN>::run(tile_acc, cur.hi[s], sw128_desc(blo + 32 * s), s > 0);
      Wgmma<BN>::run(tile_acc, cur.lo[s], sw128_desc(bhi + 32 * s), 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) Wgmma<BN>::run(tile_acc, cur.hi[s], sw128_desc(bhi + 32 * s), 1);
    wgmma_commit();
    if (i + 1 < nt) split_into(nxt);
    if (i + 2 < nt) load_tile(i + 2);
    wgmma_wait_all();
    reg_fence(tile_acc);
    frag_fence(cur);  // cur stays live (and apart from nxt) until the wgmmas are done
    if (lane == 0) mbar_arrive(smem_u32(&empty[slot]));
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] += tile_acc[j];
  };

  Frag f0, f1;
  if (nt > 0) {
    load_tile(0);
    split_into(f0);
  }
  if (nt > 1) load_tile(1);
  // two tiles an iteration, so that each fragment set stays in its registers
  for (int i = 0; i < nt; i += 2) {
    step(i, f0, f1);
    if (i + 1 < nt) step(i + 1, f1, f0);
  }

  // accumulator j of a thread: row r0 (j % 4 < 2) or r1, column
  // 8 (j / 4) + 2 q + j % 2 of the tile
  const bool split = gridDim.z > 1;
  float* dst = split ? part + (size_t)blockIdx.z * M * N : C;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int m = (j % 4) < 2 ? r0 : r1;
    const int n = n0 + 8 * (j / 4) + 2 * q + j % 2;
    if (m < M && n < N) dst[(size_t)m * N + n] = split ? acc[j] : epilogue<EPI>(acc[j], E, m, n, N);
  }
}

// C = epilogue(sum over z, in order, of part[z]).
template <Epilogue EPI>
__global__ void splitk_sum(const float* __restrict__ part, const float* __restrict__ E,
                           float* __restrict__ C, int M, int N, int splits) {
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s += part[z * mn + i];
    C[i] = epilogue<EPI>(s, E, (int)(i / N), (int)(i % N), N);
  }
}

// One (M, N, K) product in the strip form (K <= 32 * KT): the units (column
// strip, 128-row tile), row tiles fastest, in contiguous runs of nearly
// equal length, one run a block (gridDim.x <= units). bulk: the output's
// rows are 16-byte aligned (N % 4 == 0, C aligned) and leave by bulk
// copies.
template <int V, int KT, Epilogue EPI>
__global__ void __launch_bounds__(kThreads, 1)
    strip_3xtf32(const float* __restrict__ A, const float* __restrict__ Wp,
                 const float* __restrict__ E, float* __restrict__ C, int M, int N, int K,
                 int bulk) {
  __shared__ __align__(8) uint64_t full;
  extern __shared__ unsigned char dyn_smem[];
  const uint32_t raw = smem_u32(dyn_smem);
  const uint32_t wsm = (raw + 1023u) & ~1023u;  // the swizzle needs 1,024
  float* stage = reinterpret_cast<float*>(dyn_smem + (wsm - raw) + kStripMaxKt * 2 * kSlabBytes);
  float* bias = stage + 4 * kStageFloats;

  const int Np = (N + kPadN - 1) / kPadN * kPadN;
  const int row_tiles = (M + kBM - 1) / kBM;
  const long long units = (long long)((N + kStripN - 1) / kStripN) * row_tiles;
  const long long u0 = blockIdx.x * units / gridDim.x;
  const long long u1 = (blockIdx.x + 1) * units / gridDim.x;
  const size_t half = (size_t)((K + kBK - 1) / kBK) * Np * kBK;  // floats of the hi or lo half

  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  // a thread's fragment rows within its warpgroup's 64, as in the gemm form
  const int rw0 = 16 * (wt / 32) + g, rw1 = rw0 + 8;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&full), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float v[KT][2][8];  // A's raw values of the next unit (rows rw0, rw1)
  auto load = [&](long long u) {
    const int r = (int)(u % row_tiles) * kBM + 64 * wg;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      load_a<V>(v[t][0], A, r + rw0, M, t * kBK + 8 * q, K);
      load_a<V>(v[t][1], A, r + rw1, M, t * kBK + 8 * q, K);
    }
  };
  Frag f[KT];
  float acc[64], tile_acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = tile_acc[j] = 0.0f;
  int phase = 0, buf = 0;
  long long strip = -1;
  if (u0 < u1) load(u0);
  for (long long u = u0; u < u1; ++u) {
    const int n0 = (int)(u / row_tiles) * kStripN;
    const int m0 = (int)(u % row_tiles) * kBM + 64 * wg;  // this warpgroup's rows
    if (u / row_tiles != strip) {
      strip = u / row_tiles;
      __syncthreads();  // every warp is done with the last strip's weight and bias
      if (threadIdx.x == 0) {
        const int bytes = min(kStripN, Np - n0) * kBK * 4;
        const uint32_t bar = smem_u32(&full);
        mbar_expect_tx(bar, 2 * KT * bytes);
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const float* src = Wp + ((size_t)t * Np + n0) * kBK;
          bulk_load(wsm + 2 * t * kSlabBytes, src, bytes, bar);
          bulk_load(wsm + (2 * t + 1) * kSlabBytes, src + half, bytes, bar);
        }
      }
      const int c = threadIdx.x;
      if (c < kStripN) bias[c] = EPI == kBias && n0 + c < N ? E[n0 + c] : 0.0f;
      __syncthreads();
      mbar_wait(smem_u32(&full), phase);
      phase ^= 1;
    }
    // split the fragments in registers, as the gemm form's split_into
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float a[4] = {v[t][0][2 * s], v[t][1][2 * s], v[t][0][2 * s + 1], v[t][1][2 * s + 1]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[t].hi[s][j] = tf32_hi(a[j]);
          f[t].lo[s][j] = __float_as_uint(a[j] - __uint_as_float(f[t].hi[s][j]));
        }
      }
      frag_fence(f[t]);
    }
    // the gemm form's step, slab by slab
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const uint32_t bhi = wsm + 2 * t * kSlabBytes, blo = bhi + kSlabBytes;
      reg_fence(tile_acc);
      frag_fence(f[t]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        Wgmma<kStripN>::run(tile_acc, f[t].hi[s], sw128_desc(blo + 32 * s), s > 0);
        Wgmma<kStripN>::run(tile_acc, f[t].lo[s], sw128_desc(bhi + 32 * s), 1);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        Wgmma<kStripN>::run(tile_acc, f[t].hi[s], sw128_desc(bhi + 32 * s), 1);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(tile_acc);
      frag_fence(f[t]);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = (t == 0 ? 0.0f : acc[j]) + tile_acc[j];
    }
    if (u + 1 < u1) load(u + 1);  // in flight while this tile leaves

    // the tile into this warpgroup's staging buffer, once the bulk copies
    // that read it two tiles ago are done reading
    float* st = stage + (2 * wg + buf) * kStageFloats;
    if (bulk && wt < 64) bulk_wait_read<1>();
    wg_sync(wg);
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int rw = (j % 4) < 2 ? rw0 : rw1;
      const int c = 8 * (j / 4) + 2 * q;
      float2 o;
      if constexpr (EPI == kBias) {
        o = make_float2(acc[j] + bias[c], acc[j + 1] + bias[c + 1]);
      } else if constexpr (EPI == kTanhAddend) {
        const int m = m0 + rw, n = n0 + c;
        o.x = m < M && n < N ? epilogue<EPI>(acc[j], E, m, n, N) : 0.0f;
        o.y = m < M && n + 1 < N ? epilogue<EPI>(acc[j + 1], E, m, n + 1, N) : 0.0f;
      } else {
        o = make_float2(acc[j], acc[j + 1]);
      }
      *reinterpret_cast<float2*>(st + rw * kStageLd + c) = o;
    }
    if (bulk) fence_proxy_async();
    wg_sync(wg);
    const int rows = min(64, M - m0), cols = min(kStripN, N - n0);
    if (bulk) {
      if (wt < rows) bulk_store(C + (size_t)(m0 + wt) * N + n0, smem_u32(st + wt * kStageLd), cols * 4);
      if (wt < 64) bulk_commit();
    } else {
      // a warp a row: a scalar head up to C's next 16-byte boundary, 16-byte
      // vectors, a scalar tail
      for (int r = wt / 32; r < rows; r += 4) {
        float* dst = C + (size_t)(m0 + r) * N + n0;
        const float* src = st + r * kStageLd;
        const int head = min(cols, (int)((4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3));
        if (lane < head) dst[lane] = src[lane];
        const int body = (cols - head) / 4;
        for (int i = lane; i < body; i += 32) {
          const float* s4 = src + head + 4 * i;
          *reinterpret_cast<float4*>(dst + head + 4 * i) = make_float4(s4[0], s4[1], s4[2], s4[3]);
        }
        const int tail = head + 4 * body + lane;
        if (tail < cols && lane < 4) dst[tail] = src[tail];
      }
    }
    buf ^= 1;
  }
  if (bulk && wt < 64) bulk_wait_all();
}

template <int V, int BN, Epilogue EPI>
cudaError_t launch_gemm(dim3 grid, cudaStream_t s, const float* A, const float* Wp, const float* E,
                        float* C, float* part, int M, int N, int K, int kt_split) {
  cudaError_t err = cudaFuncSetAttribute(gemm_3xtf32<V, BN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN));
  if (err != cudaSuccess) return err;
  gemm_3xtf32<V, BN, EPI><<<grid, kThreads, smem_bytes(BN), s>>>(A, Wp, E, C, part, M, N, K,
                                                                 kt_split);
  return cudaGetLastError();
}

template <int BN, Epilogue EPI>
cudaError_t launch_width(dim3 grid, cudaStream_t s, const float* A, const float* Wp,
                         const float* E, float* C, float* part, int M, int N, int K,
                         int kt_split) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(A);
  if (K % 4 == 0 && a % 16 == 0)
    return launch_gemm<4, BN, EPI>(grid, s, A, Wp, E, C, part, M, N, K, kt_split);
  if (K % 2 == 0 && a % 8 == 0)
    return launch_gemm<2, BN, EPI>(grid, s, A, Wp, E, C, part, M, N, K, kt_split);
  return launch_gemm<1, BN, EPI>(grid, s, A, Wp, E, C, part, M, N, K, kt_split);
}

template <int V, int KT, Epilogue EPI>
cudaError_t launch_strip_kt(int blocks, cudaStream_t s, const float* A, const float* Wp,
                            const float* E, float* C, int M, int N, int K) {
  cudaError_t err = cudaFuncSetAttribute(strip_3xtf32<V, KT, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kStripSmem);
  if (err != cudaSuccess) return err;
  const int bulk = N % 4 == 0 && reinterpret_cast<unsigned long long>(C) % 16 == 0;
  strip_3xtf32<V, KT, EPI><<<blocks, kThreads, kStripSmem, s>>>(A, Wp, E, C, M, N, K, bulk);
  return cudaGetLastError();
}

template <Epilogue EPI>
cudaError_t launch_strip(int blocks, cudaStream_t s, const float* A, const float* Wp,
                         const float* E, float* C, int M, int N, int K) {
  const bool v4 = K % 4 == 0 && reinterpret_cast<unsigned long long>(A) % 16 == 0;
  if (K <= kBK)
    return v4 ? launch_strip_kt<4, 1, EPI>(blocks, s, A, Wp, E, C, M, N, K)
              : launch_strip_kt<1, 1, EPI>(blocks, s, A, Wp, E, C, M, N, K);
  return v4 ? launch_strip_kt<4, 2, EPI>(blocks, s, A, Wp, E, C, M, N, K)
            : launch_strip_kt<1, 2, EPI>(blocks, s, A, Wp, E, C, M, N, K);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// blocks > 0: the strip form on that many blocks (K <= 64; splits and
// tile_n unused); 0: the gemm form.
template <Epilogue EPI>
int launch(const float* A, const float* Wp, const float* E, float* C, float* part, int M, int N,
           int K, int splits, int tile_n, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || blocks < 0) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    const long long units = (long long)cdiv(N, kStripN) * cdiv(M, kBM);
    if (K > kStripMaxKt * kBK || blocks > units) return (int)cudaErrorInvalidValue;
    return (int)launch_strip<EPI>(blocks, s, A, Wp, E, C, M, N, K);
  }
  if (splits < 1 || (tile_n != kWidths[0] && tile_n != kWidths[1]))
    return (int)cudaErrorInvalidValue;
  const int Kt = cdiv(K, kBK);
  const int kt_split = cdiv(Kt, splits);
  const int nz = cdiv(Kt, kt_split);
  // row tiles vary fastest, so the blocks that share a weight tile run together
  const dim3 grid(cdiv(M, kBM), cdiv(N, tile_n), nz);
  const cudaError_t err =
      tile_n == kWidths[0]
          ? launch_width<kWidths[0], EPI>(grid, s, A, Wp, E, C, part, M, N, K, kt_split)
          : launch_width<kWidths[1], EPI>(grid, s, A, Wp, E, C, part, M, N, K, kt_split);
  if (err != cudaSuccess || nz == 1) return (int)err;
  const long long mn = (long long)M * N;
  const long long want = (mn + 255) / 256;
  splitk_sum<EPI><<<(int)(want < 4096 ? want : 4096), 256, 0, s>>>(part, E, C, M, N, nz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Contraction ranges for an (M, N) output: enough blocks for one on each of
// the card's n_sm SMs (the kernel's occupancy) at tile width 128, each
// range at least 8 tiles (256) deep; 1 when the output alone has enough
// tiles.
int denoise_splits(int M, int N, int K, int n_sm) {
  const int s = min(n_sm / (cdiv(M, kBM) * cdiv(N, kWidths[0])), cdiv(K, kBK) / 8);
  return s > 1 ? s : 1;
}

// The gemm form's tile width for an (M, N) output: 104 where it takes no
// more waves of n_sm blocks than 128, else 128 (always 128 with splits >
// 1, which were counted at 128). At a deep contraction a tile's time is
// mostly its fixed chain of 32-deep steps, not its width, so the waves set
// the time (at 64 deep and less the store does: the strip form). On an H100 SXM (132
// SMs, 700 W) at B 1,024, an earlier revision of K3 took at N 6,710
// 0.203 ms at 128 and 0.190 ms at 104 (4 waves each), and at N 20,000
// 0.472 ms at 128 (10 waves) and 0.501 ms at 104 (12 waves)
// (chip_smoke.py; PERF.md has these runs).
int denoise_tile_n(int M, int N, int splits, int n_sm) {
  const int rows = cdiv(M, kBM);
  const int waves128 = cdiv(rows * cdiv(N, kWidths[0]), n_sm);
  const int waves104 = cdiv(rows * cdiv(N, kWidths[1]), n_sm);
  return splits == 1 && waves104 <= waves128 ? kWidths[1] : kWidths[0];
}

// K2: h (B, H) = tanh(x (B, K) @ w1x (K, H) + tp (B, H)), w1p the prepared
// w1x: the gemm form in blocks tile_n wide (denoise_tile_n), or with
// blocks > 0 the strip form on that many blocks. part: (splits, B, H) f32
// scratch when splits > 1 (the contraction is cut into at most `splits`
// ranges of whole 32-deep tiles).
int denoise_layer1(const float* x, const float* w1p, const float* tp, float* h, float* part,
                   int B, int K, int H, int splits, int tile_n, int blocks, void* stream) {
  return launch<kTanhAddend>(x, w1p, tp, h, part, B, H, K, splits, tile_n, blocks, stream);
}

// K2's partial: s (B, H) = x (B, K) @ w1x (K, H), the raw f32 product (the
// kNone epilogue), for a catalog shard of K rows of W1x; the caller sums
// the shards' s and applies tanh(s + tp). The other arguments as for K2.
int denoise_layer1_partial(const float* x, const float* w1p, float* s, float* part, int B, int K,
                           int H, int splits, int tile_n, int blocks, void* stream) {
  return launch<kNone>(x, w1p, nullptr, s, part, B, H, K, splits, tile_n, blocks, stream);
}

// K3: out (B, N) = h (B, H) @ w2 (H, N) + b2 (N,), w2p the prepared w2;
// the other arguments as for K2.
int denoise_layer2(const float* h, const float* w2p, const float* b2, float* out, float* part,
                   int B, int H, int N, int splits, int tile_n, int blocks, void* stream) {
  return launch<kBias>(h, w2p, b2, out, part, B, N, H, splits, tile_n, blocks, stream);
}

}  // extern "C"
