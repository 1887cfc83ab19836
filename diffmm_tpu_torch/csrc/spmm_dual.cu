// K1: dual-direction dense bipartite propagation in one pass over the 0/1
// adjacency M (U, I), stored int8 or bf16 with a row stride `ld` (elements)
// whose bytes are a multiple of 16:
//
//     y_u = M  @ z_i      (U, D) f32
//     y_i = Mᵀ @ z_u      (I, D) f32
//
// with z_u (U, D) and z_i (I, D) already rounded to bf16, products exact in
// f32 (M is 0/1) and f32 accumulation.
//
// Replaces diffmm_tpu/ops/pallas/spmm_dual.py::_dual_kernel (called from
// _dual_call). On the TPU the grid walks U row-blocks in order and y_i
// accumulates in VMEM across the grid. Hopper blocks run in parallel and in
// no order, so the reduction is split in two passes, deterministic:
//
//   pass 1 (dual_partial): a 2-D grid of (C, R) blocks, at most one per SM.
//     Block (c, r) owns the I range c (SI columns) and the U range r (su
//     rows) and walks it in 128 x 128 tiles of M. Each tile is read from
//     device memory once, in 16-byte vectors, converted to bf16 in shared
//     memory, and feeds both tensor-core products (mma.sync m16n8k16 bf16,
//     f32 accumulate, operands by ldmatrix; the .trans form reads Mᵀ from
//     the same tile). Warp w owns row strip w of the tile in both products,
//     so one A fragment serves all D/8 output tiles:
//       - y_u for the tile's 128 rows accumulates in registers over the
//         block's I range and is written as partial Pu[c] (C, U_pad, D);
//       - y_i for the block's whole I range accumulates in shared memory
//         (SI x D f32) over the block's U range and is written once as
//         partial Pi[r] (R, I_pad, D).
//     The next tile's loads are issued into registers before the current
//     tile's products, so device-memory latency overlaps compute.
//   pass 2 (sum_parts): y_u = sum_c Pu[c], y_i = sum_r Pi[r], in a fixed
//     order — the result does not vary from run to run. It differs from the
//     plain PyTorch version only by the f32 summation order.
//
// The ragged edges of U and I are masked to zero on load; D is not padded.
//
// Bound at tiktok shape (U 9,308, I 6,710, D 64, int8 M): 62.5 MB of M +
// 2.0 MB of bf16 z + 4.1 MB of f32 y = 68.6 MB, 20.5 us at 3.35 TB/s; 16.0
// GFLOP of bf16 products, 16.2 us at 989 TFLOP/s, so memory-bound. The
// partials add (C * U_pad + R * I_pad) * D * 4 bytes written and read again
// (about 50 MB at tiktok shape, much of it in L2); wgmma with TMA-fed tiles
// and a cluster-wide reduction in distributed shared memory are later work.
// (The WMMA API compiled its fragment loads here to generic loads and
// register transposes, not ldmatrix; PERF.md has both versions' times.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 128;   // tile edge: U rows = I columns = 16 * kWarps
constexpr int kPadB = 8;  // bf16 row padding in shared memory (16 bytes)
constexpr int kPadF = 8;  // f32 row padding (32 bytes: 64-bit accesses conflict-free)
static_assert(kT == 16 * kWarps, "one 16-row strip per warp");

template <int D, typename MT>
struct Cfg {
  static constexpr int SI = D == 16 ? 1024 : 32768 / D;  // I columns owned by a block
  static constexpr int LDM = kT + kPadB;     // M tile row stride (bf16)
  static constexpr int LDZ = D + kPadB;      // z tile row stride (bf16)
  static constexpr int LDA = D + kPadF;      // y_i accumulator row stride (f32)
  static constexpr int NT = D / 8;           // n8 output tiles of a strip
  static constexpr int EPC = 16 / sizeof(MT);              // M elements per 16-byte chunk
  static constexpr int NMC = kT * (kT / EPC) / kThreads;   // M chunks per thread per tile
  static constexpr int NZC = kT * (D / 8) / kThreads;      // z chunks per thread per tile
  static constexpr size_t SMEM =
      (size_t)SI * LDA * 4 + ((size_t)kT * LDM + 2 * (size_t)kT * LDZ) * 2;
  static_assert(SI % kT == 0, "a block's I range holds whole tiles");
  static_assert(NZC >= 1 && NZC * kThreads == kT * D / 8, "D must be 16, 32 or 64");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// ldmatrix: four 8x8 bf16 matrices from shared memory, one row address per
// lane (lanes 8q..8q+7 address matrix q); .trans transposes each matrix.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d (16x8 f32) += a (16x16 bf16, row) @ b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Convert one 16-byte chunk of M to bf16 in shared memory, keeping only the
// first `valid` elements (the rest are past the I edge).
__device__ __forceinline__ void put_m_chunk(bf16* dst, uint4 v, int valid, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
  __align__(16) bf16 out[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16(i < valid ? (float)b[i] : 0.0f);
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(out)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(out)[1];
}

__device__ __forceinline__ void put_m_chunk(bf16* dst, uint4 v, int valid, bf16) {
  if (valid < 8) {
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i >= valid) e[i] = __float2bfloat16(0.0f);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

template <int D, typename MT>
__global__ void __launch_bounds__(kThreads) dual_partial(
    const MT* __restrict__ mat, long long ld, const bf16* __restrict__ zu,
    const bf16* __restrict__ zi, float* __restrict__ pu, float* __restrict__ pi, int U, int I,
    int su, int u_pad, int i_pad) {
  using C = Cfg<D, MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_i = reinterpret_cast<float*>(smem);
  bf16* m_t = reinterpret_cast<bf16*>(smem + (size_t)C::SI * C::LDA * 4);
  bf16* zi_t = m_t + kT * C::LDM;
  bf16* zu_t = zi_t + kT * C::LDZ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int c = blockIdx.x;
  const int r = blockIdx.y;
  const int ibeg = c * C::SI;
  const int iend = min(ibeg + C::SI, I);
  const int ubeg = r * su;
  const int uend = min(ubeg + su, U);
  const int nk = (iend - ibeg + kT - 1) / kT;
  const int ntiles = nk * ((uend - ubeg + kT - 1) / kT);

  for (int e = tid; e < C::SI * C::LDA; e += kThreads) acc_i[e] = 0.0f;

  uint4 mreg[C::NMC];
  uint4 zireg[C::NZC];
  uint4 zureg[C::NZC];

  // Issue the global loads of tile t into registers (rows masked at U and
  // I; the columns of a chunk past I are dropped when it is stored).
  auto load = [&](int t) {
    const int u0 = ubeg + (t / nk) * kT;
    const int i0 = ibeg + (t % nk) * kT;
#pragma unroll
    for (int j = 0; j < C::NMC; ++j) {
      const int e = tid + j * kThreads;
      const int row = u0 + e / (kT / C::EPC);
      const int col = i0 + (e % (kT / C::EPC)) * C::EPC;
      mreg[j] = (row < uend && col < iend)
                    ? *reinterpret_cast<const uint4*>(mat + row * ld + col)
                    : zero4();
    }
#pragma unroll
    for (int j = 0; j < C::NZC; ++j) {
      const int e = tid + j * kThreads;
      const int row = i0 + e / (D / 8);
      zireg[j] = row < iend ? reinterpret_cast<const uint4*>(zi + (size_t)row * D)[e % (D / 8)]
                            : zero4();
    }
    if (t % nk == 0) {
#pragma unroll
      for (int j = 0; j < C::NZC; ++j) {
        const int e = tid + j * kThreads;
        const int row = u0 + e / (D / 8);
        zureg[j] = row < uend ? reinterpret_cast<const uint4*>(zu + (size_t)row * D)[e % (D / 8)]
                              : zero4();
      }
    }
  };

  // Move tile t from registers to shared memory, converting M to bf16.
  auto store = [&](int t) {
    const int i0 = ibeg + (t % nk) * kT;
#pragma unroll
    for (int j = 0; j < C::NMC; ++j) {
      const int e = tid + j * kThreads;
      const int row = e / (kT / C::EPC);
      const int cl = (e % (kT / C::EPC)) * C::EPC;
      put_m_chunk(m_t + row * C::LDM + cl, mreg[j], iend - (i0 + cl), MT());
    }
#pragma unroll
    for (int j = 0; j < C::NZC; ++j) {
      const int e = tid + j * kThreads;
      *reinterpret_cast<uint4*>(zi_t + (e / (D / 8)) * C::LDZ + (e % (D / 8)) * 8) = zireg[j];
    }
    if (t % nk == 0) {
#pragma unroll
      for (int j = 0; j < C::NZC; ++j) {
        const int e = tid + j * kThreads;
        *reinterpret_cast<uint4*>(zu_t + (e / (D / 8)) * C::LDZ + (e % (D / 8)) * 8) = zureg[j];
      }
    }
  };

  const int lane = tid % 32;
  // B operand rows for ldmatrix.x4.trans of two n8 tiles: lanes 8q..8q+7
  // address k rows (q & 1) * 8 + 0..7 at columns (q >> 1) * 8
  const int b_row = (lane % 8) + ((lane / 8) & 1) * 8;
  const int b_col = (lane / 16) * 8;
  float accu[C::NT][4];  // y_u of the warp's strip, m16n8 accumulator layout

  if (ntiles > 0) load(0);
  for (int t = 0; t < ntiles; ++t) {
    const int k = t % nk;
    __syncthreads();  // every warp is done with the previous tile
    store(t);
    __syncthreads();
    if (t + 1 < ntiles) load(t + 1);

    if (k == 0) {
#pragma unroll
      for (int n = 0; n < C::NT; ++n) accu[n][0] = accu[n][1] = accu[n][2] = accu[n][3] = 0.0f;
    }
    // y_u[strip rows] += M[strip, :] @ z_i[tile columns]
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, m_t + (warp * 16 + lane % 16) * C::LDM + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        unsigned b[4];
        ldsm_x4_t(b, zi_t + (kk * 16 + b_row) * C::LDZ + np * 16 + b_col);
        mma16816(accu[2 * np], a, b[0], b[1]);
        mma16816(accu[2 * np + 1], a, b[2], b[3]);
      }
    }
    // y_i[strip columns] += M[:, strip]ᵀ @ z_u[tile rows], accumulated in
    // shared memory across the tiles of the block's U range
    float* cbase = acc_i + (k * kT + warp * 16 + lane / 4) * C::LDA + (lane % 4) * 2;
    float acci[C::NT][4];
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const float2 lo = *reinterpret_cast<const float2*>(cbase + n * 8);
      const float2 hi = *reinterpret_cast<const float2*>(cbase + 8 * C::LDA + n * 8);
      acci[n][0] = lo.x, acci[n][1] = lo.y, acci[n][2] = hi.x, acci[n][3] = hi.y;
    }
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      // Mᵀ's A fragment: lanes 8q..8q+7 address u rows (q >> 1) * 8 + 0..7
      // of the stored tile at i columns (q & 1) * 8, transposed on load
      unsigned a[4];
      const int q = lane / 8;
      ldsm_x4_t(a, m_t + (kk * 16 + (lane % 8) + (q >> 1) * 8) * C::LDM + warp * 16 + (q & 1) * 8);
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        unsigned b[4];
        ldsm_x4_t(b, zu_t + (kk * 16 + b_row) * C::LDZ + np * 16 + b_col);
        mma16816(acci[2 * np], a, b[0], b[1]);
        mma16816(acci[2 * np + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      *reinterpret_cast<float2*>(cbase + n * 8) = make_float2(acci[n][0], acci[n][1]);
      *reinterpret_cast<float2*>(cbase + 8 * C::LDA + n * 8) = make_float2(acci[n][2], acci[n][3]);
    }

    if (k == nk - 1) {
      const int u0 = ubeg + (t / nk) * kT;
      float* dst = pu + ((size_t)c * u_pad + u0 + warp * 16 + lane / 4) * D + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < C::NT; ++n) {
        *reinterpret_cast<float2*>(dst + n * 8) = make_float2(accu[n][0], accu[n][1]);
        *reinterpret_cast<float2*>(dst + 8 * D + n * 8) = make_float2(accu[n][2], accu[n][3]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < C::SI * D / 4; e += kThreads) {
    const int row = e / (D / 4);
    const int col = (e % (D / 4)) * 4;
    *reinterpret_cast<float4*>(pi + ((size_t)r * i_pad + ibeg + row) * D + col) =
        *reinterpret_cast<const float4*>(acc_i + row * C::LDA + col);
  }
}

// y[i] = sum over parts q (in order) of p[q * part4 + i], float4 lanes.
__global__ void sum_parts(const float4* __restrict__ p, float4* __restrict__ y, int nparts,
                          long long n4, long long part4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = p[i];
    for (int q = 1; q < nparts; ++q) {
      const float4 v = p[q * part4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    y[i] = s;
  }
}

cudaError_t sum_launch(const float* p, float* y, int nparts, long long n, long long part,
                       cudaStream_t stream) {
  const long long n4 = n / 4;
  if (n4 == 0) return cudaSuccess;
  const long long want = (n4 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  sum_parts<<<blocks, kThreads, 0, stream>>>(reinterpret_cast<const float4*>(p),
                                             reinterpret_cast<float4*>(y), nparts, n4,
                                             part / 4);
  return cudaGetLastError();
}

template <int D, typename MT>
cudaError_t launch(const void* mat, long long ld, const void* zu, const void* zi, void* yu,
                   void* yi, void* pu, void* pi, int U, int I, int su, int nr, int nc,
                   int u_pad, int i_pad, cudaStream_t stream) {
  using C = Cfg<D, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      dual_partial<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dual_partial<D, MT><<<dim3(nc, nr), kThreads, C::SMEM, stream>>>(
      static_cast<const MT*>(mat), ld, static_cast<const bf16*>(zu),
      static_cast<const bf16*>(zi), static_cast<float*>(pu), static_cast<float*>(pi), U, I, su,
      u_pad, i_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sum_launch(static_cast<const float*>(pu), static_cast<float*>(yu), nc,
                   (long long)U * D, (long long)u_pad * D, stream);
  if (err != cudaSuccess) return err;
  return sum_launch(static_cast<const float*>(pi), static_cast<float*>(yi), nr,
                    (long long)I * D, (long long)i_pad * D, stream);
}

template <typename MT>
cudaError_t dispatch_d(int D, const void* mat, long long ld, const void* zu, const void* zi,
                       void* yu, void* yi, void* pu, void* pi, int U, int I, int su, int nr,
                       int nc, int u_pad, int i_pad, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16, MT>(mat, ld, zu, zi, yu, yi, pu, pi, U, I, su, nr, nc, u_pad, i_pad,
                            stream);
    case 32:
      return launch<32, MT>(mat, ld, zu, zi, yu, yi, pu, pi, U, I, su, nr, nc, u_pad, i_pad,
                            stream);
    case 64:
      return launch<64, MT>(mat, ld, zu, zi, yu, yi, pu, pi, U, I, su, nr, nc, u_pad, i_pad,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Columns of I that one block of pass 1 owns, for width D (0: unsupported D).
int spmm_dual_block_items(int D) {
  switch (D) {
    case 16:
      return Cfg<16, int8_t>::SI;
    case 32:
      return Cfg<32, int8_t>::SI;
    case 64:
      return Cfg<64, int8_t>::SI;
    default:
      return 0;
  }
}

// U rows per tile: a block's U range is a multiple of it.
int spmm_dual_tile_rows() { return kT; }

// (y_u, y_i) = (M @ z_i, Mᵀ @ z_u). mat: (U, I) int8 (mat_is_int8 = 1) or
// bf16 with row stride ld elements (ld * itemsize a multiple of 16, mat
// 16-byte aligned); zu (U, D), zi (I, D) bf16; yu (U, D), yi (I, D) f32;
// pu (nc, u_pad, D) and pi (nr, i_pad, D) f32 scratch, u_pad = nr * su,
// i_pad = nc * SI.
int spmm_dual_forward(const void* mat, int mat_is_int8, long long ld, const void* zu,
                      const void* zi, void* yu, void* yi, void* pu, void* pi, int U, int I,
                      int D, int su, int nr, int nc, int u_pad, int i_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mat_is_int8)
    return dispatch_d<int8_t>(D, mat, ld, zu, zi, yu, yi, pu, pi, U, I, su, nr, nc, u_pad,
                              i_pad, s);
  return dispatch_d<bf16>(D, mat, ld, zu, zi, yu, yi, pu, pi, U, I, su, nr, nc, u_pad, i_pad,
                          s);
}

}  // extern "C"
