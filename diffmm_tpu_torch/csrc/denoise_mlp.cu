// K2 and K3: the single-hidden-layer denoiser forward of the rebuild's
// reverse loop, in full f32 (no TF32: the rebuild's per-user top-k over
// these scores decides the graph edges):
//
//     K2 (denoise_layer1): h   = tanh(x @ W1x + temb_proj)   b1 folded into temb_proj
//     K3 (denoise_layer2): out = h @ W2 + b2
//
// x (B, K), W1x (K, H), temb_proj (B, H), W2 (H, N), b2 (N,), all f32 and
// row-major; W1x is the first K rows of the JAX layout's (K + d_emb, H) W1.
//
// Replaces diffmm_tpu/ops/pallas/denoise_mlp.py::_layer1_kernel (K2) and
// _layer2_kernel (K3), both called from fused_denoise_mlp. The TPU version
// pads K and N to 512 lanes and carries the layer-1 sum in VMEM across a
// sequential k grid. Here each block owns a 128 x 128 output tile and walks
// its range of the contraction itself; the ragged edges of B, K and N are
// masked on load and store.
//
// Design: a register-blocked SGEMM on the CUDA cores (f32 FMA; the tensor
// cores offer no full-f32 product). 256 threads, each computing 8 x 8
// outputs from 16-deep tiles in shared memory, read back as float4 in a
// split layout that keeps a warp's reads free of bank conflicts. Shared
// memory holds two tiles: the next tile's global loads are issued into
// registers before the current tile's FMAs and stored into the other
// buffer after them, so each tile costs one barrier. Global loads are
// vectors of 4, 2 or 1 floats, the widest that the row lengths and base
// addresses allow (rows of x and W2 are 6,710 floats: 8-byte vectors).
//
// Split-K: K2's output (1,024 x 1,024) makes only 64 tiles for 132 SMs, so
// the caller may split the contraction into `splits` ranges (grid z); each
// writes raw f32 partials and a second pass sums them in a fixed order and
// applies the epilogue, so the result does not vary from run to run. K3's
// output (1,024 x 6,710, 424 tiles) runs unsplit.
//
// Bound at the rebuild's shape (B 1,024, I 6,710, H 1,024): 2 * 1,024 *
// 6,710 * 1,024 = 14.07 GFLOP per launch, 210 us at the 67 TFLOP/s f32
// rate, so compute-bound (about 63 MB moved, 19 us at 3.35 TB/s).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output rows of a block
constexpr int kBN = 128;  // output columns of a block
constexpr int kBK = 16;   // contraction depth of a shared-memory tile
constexpr int kT = 8;     // outputs per thread along each side
constexpr int kPad = 4;
static_assert((kBM / kT) * (kBN / kT) == kThreads, "one 8 x 8 output block per thread");

enum Epilogue { kTanhAddend = 0, kBias = 1 };

// Offset of a thread's i-th output row (or column) inside the block tile:
// two groups of 4, at t*4 and B/2 + t*4, so the float4 reads of a warp
// from shared memory are contiguous (no bank conflicts).
template <int B>
__device__ __forceinline__ int lane_offset(int t, int i) {
  return i >= 4 ? B / 2 + t * 4 + (i - 4) : t * 4 + i;
}

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

// r = p[0..V) when ok, else zeros.
template <int V>
__device__ __forceinline__ void vload(float (&r)[V], const float* p, bool ok) {
  if (ok) {
    const typename Vec<V>::T v = *reinterpret_cast<const typename Vec<V>::T*>(p);
    const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = f[i];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = 0.0f;
  }
}

// E is the (M, N) addend of kTanhAddend or the (N,) bias of kBias.
template <int EPI>
__device__ __forceinline__ float epilogue(float v, const float* E, int m, int n, int N) {
  return EPI == kTanhAddend ? tanhf(v + E[(size_t)m * N + n]) : v + E[n];
}

// C (M, N) = epilogue(A (M, K) @ Bm (K, N)) over the contraction range of
// blockIdx.z (k_split wide, a multiple of kBK). With gridDim.z > 1 the raw
// sums go to part[z] (M, N) instead. K and N are multiples of V.
template <int V, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
    sgemm(const float* __restrict__ A, const float* __restrict__ Bm, const float* __restrict__ E,
          float* __restrict__ C, float* __restrict__ part, int M, int N, int K, int k_split) {
  constexpr int AV = kBM * kBK / V / kThreads;  // A vectors per thread per tile
  constexpr int BV = kBK * kBN / V / kThreads;  // B vectors per thread per tile
  static_assert(AV * V * kThreads == kBM * kBK && BV * V * kThreads == kBK * kBN, "tile split");
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];  // A tiles, transposed: As[k][m]
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kT);
  const int ty = tid / (kBN / kT);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int ntiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  float areg[AV][V];
  float breg[BV][V];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < AV; ++j) {
      const int e = tid + j * kThreads;
      const int m = m0 + e / (kBK / V);
      const int k = k0 + (e % (kBK / V)) * V;
      vload<V>(areg[j], A + (size_t)m * K + k, m < M && k < kend);
    }
#pragma unroll
    for (int j = 0; j < BV; ++j) {
      const int e = tid + j * kThreads;
      const int k = k0 + e / (kBN / V);
      const int n = n0 + (e % (kBN / V)) * V;
      vload<V>(breg[j], Bm + (size_t)k * N + n, k < kend && n < N);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < AV; ++j) {
      const int e = tid + j * kThreads;
      const int m = e / (kBK / V);
      const int k = (e % (kBK / V)) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) As[buf][k + v][m] = areg[j][v];
    }
#pragma unroll
    for (int j = 0; j < BV; ++j) {
      const int e = tid + j * kThreads;
      const int k = e / (kBN / V);
      const int n = (e % (kBN / V)) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) Bs[buf][k][n + v] = breg[j][v];
    }
  };

  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.0f;

  if (ntiles > 0) {
    load(kbeg);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) load(kbeg + (t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kT];
      float b[kT];
#pragma unroll
      for (int g = 0; g < kT / 4; ++g) {
        const float4 va = *reinterpret_cast<const float4*>(&As[cur][kk][lane_offset<kBM>(ty, 4 * g)]);
        a[4 * g] = va.x, a[4 * g + 1] = va.y, a[4 * g + 2] = va.z, a[4 * g + 3] = va.w;
        const float4 vb = *reinterpret_cast<const float4*>(&Bs[cur][kk][lane_offset<kBN>(tx, 4 * g)]);
        b[4 * g] = vb.x, b[4 * g + 1] = vb.y, b[4 * g + 2] = vb.z, b[4 * g + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < ntiles) store(cur ^ 1);
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
  float* dst = split ? part + (size_t)blockIdx.z * M * N : C;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int m = m0 + lane_offset<kBM>(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int n = n0 + lane_offset<kBN>(tx, j);
      if (n >= N) continue;
      dst[(size_t)m * N + n] = split ? acc[i][j] : epilogue<EPI>(acc[i][j], E, m, n, N);
    }
  }
}

// C = epilogue(sum over z, in order, of part[z]).
template <int EPI>
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

// Widest vector (4, 2 or 1 floats) that every row start of A and Bm allows.
int vec_width(const float* A, const float* Bm, int K, int N) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(A);
  const unsigned long long b = reinterpret_cast<unsigned long long>(Bm);
  if (K % 4 == 0 && N % 4 == 0 && a % 16 == 0 && b % 16 == 0) return 4;
  if (K % 2 == 0 && N % 2 == 0 && a % 8 == 0 && b % 8 == 0) return 2;
  return 1;
}

template <int EPI>
int launch(const float* A, const float* Bm, const float* E, float* C, float* part, int M, int N,
           int K, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_split = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const int nz = (K + k_split - 1) / k_split;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, nz);
  switch (vec_width(A, Bm, K, N)) {
    case 4:
      sgemm<4, EPI><<<grid, kThreads, 0, s>>>(A, Bm, E, C, part, M, N, K, k_split);
      break;
    case 2:
      sgemm<2, EPI><<<grid, kThreads, 0, s>>>(A, Bm, E, C, part, M, N, K, k_split);
      break;
    default:
      sgemm<1, EPI><<<grid, kThreads, 0, s>>>(A, Bm, E, C, part, M, N, K, k_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nz == 1) return (int)err;
  const long long mn = (long long)M * N;
  const long long want = (mn + kThreads - 1) / kThreads;
  splitk_sum<EPI><<<(int)(want < 4096 ? want : 4096), kThreads, 0, s>>>(part, E, C, M, N, nz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Contraction ranges for a (M, N) output: enough blocks for two on each of
// the card's n_sm SMs (the kernel's occupancy), each range at least 512
// deep; 1 when the output alone has enough tiles.
int denoise_splits(int M, int N, int K, int n_sm) {
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int s = min(2 * n_sm / tiles, K / 512);
  return s > 1 ? s : 1;
}

// K2: h (B, H) = tanh(x (B, K) @ w1x (K, H) + tp (B, H)). part: (splits, B,
// H) f32 scratch when splits > 1 (the contraction is cut into at most
// `splits` ranges of whole 16-deep tiles).
int denoise_layer1(const float* x, const float* w1x, const float* tp, float* h, float* part,
                   int B, int K, int H, int splits, void* stream) {
  return launch<kTanhAddend>(x, w1x, tp, h, part, B, H, K, splits, stream);
}

// K3: out (B, N) = h (B, H) @ w2 (H, N) + b2 (N,); part as for K2.
int denoise_layer2(const float* h, const float* w2, const float* b2, float* out, float* part,
                   int B, int H, int N, int splits, void* stream) {
  return launch<kBias>(h, w2, b2, out, part, B, N, H, splits, stream);
}

}  // extern "C"
