// K4: sorted segment sum over CSR offsets,
//
//     out[s, :] = sum_{offsets[s] <= e < offsets[s + 1], 0 <= e < nnz} msgs[e, :]     s < n
//
// for messages msgs (nnz, d), f32 or bf16, accumulated in f32 into out
// (n, d) f32. offsets (n + 1,) int64 are the non-decreasing segment
// boundaries of the ascending segment ids (offsets[s] = first edge whose id
// is >= s). Edges past offsets[n] (the sentinel pads, whose id is n) are
// never read, so their messages may hold anything; a boundary outside
// [0, nnz] is cut to it, so no offset makes the kernel read outside msgs.
//
// Replaces diffmm_tpu/ops/pallas/segsum.py::_segsum_kernel (called from
// _sorted_segment_sum_impl). The TPU kernel walks chunks of edges in order
// and adds a one-hot matrix product of each chunk into a 128-row-aligned
// window of an accumulator held whole in VMEM, so the number of segments a
// call can take is capped by VMEM and the host plans pieces around it. Here
// the segment boundaries are given, so each segment is reduced on its own and
// written once:
//
//   one warp per segment (kWarps segments a block); lane l owns the columns
//   tile * 32 * CPL + l + 32 * j, j < CPL, in f32 registers, so each edge's
//   row is read by the warp in CPL coalesced 32-element runs. The warp walks
//   the segment's edges in ascending order, kUnroll edges' loads at a time,
//   and adds each message to its registers, then writes its row of out once. Widths above 32 * CPL = 256
//   columns take more column tiles (grid y).
//
// Consequences: no atomics, so the result is bitwise the same from run to run
// and equals a sequential f32 sum in edge order; every row is written, so an
// empty segment comes out as zeros; there is no window and so no limit on n.
// Index arithmetic is int64 (edge * d exceeds int32 at 33.6M edges of d 64).
//
// Bound: memory. Each message is read once and each output row written once;
// there is one f32 add per message element (0.06 flop/byte). At the yelp shape
// (nnz 307,200, d 64, f32 messages, n 38,403): 78.6 MB of messages + 9.8 MB of
// output + 0.3 MB of offsets, about 26.5 us at 3.35 TB/s. The per-edge gather
// z[cols[e]] that makes msgs stays outside the kernel, as the TPU package
// keeps its `take` outside its kernel; fusing it (and splitting hub segments
// across warps) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // segments (warps) of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;  // edges whose loads a warp issues together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const T* __restrict__ msgs, const long long* __restrict__ offsets,
                  float* __restrict__ out, int n, long long nnz, int d) {
  const int lane = threadIdx.x & 31;
  const long long seg = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (seg >= n) return;
  const int col0 = blockIdx.y * (32 * CPL) + lane;
  const long long first = offsets[seg], last = offsets[seg + 1];
  const long long lo = first < 0 ? 0 : first;
  const long long hi = last > nnz ? nnz : last;
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
  // kUnroll edges' loads are issued before their adds, so a long segment
  // (a hub) keeps that many loads in flight; the adds stay in edge order
  long long e = lo;
  for (; e + kUnroll <= hi; e += kUnroll) {
    float v[kUnroll][CPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* row = msgs + (e + u) * d;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = col0 + 32 * j;
        v[u][j] = c < d ? to_f32(row[c]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] += v[u][j];
    }
  }
  for (; e < hi; ++e) {
    const T* row = msgs + e * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + 32 * j;
      if (c < d) acc[j] += to_f32(row[c]);
    }
  }
  float* dst = out + seg * d;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = col0 + 32 * j;
    if (c < d) dst[c] = acc[j];
  }
}

template <typename T, int CPL>
cudaError_t launch(const void* msgs, const void* offsets, void* out, int n, long long nnz,
                   int d, cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, (d + 32 * CPL - 1) / (32 * CPL));
  segsum_kernel<T, CPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(msgs), static_cast<const long long*>(offsets),
      static_cast<float*>(out), n, nnz, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* msgs, const void* offsets, void* out, int n, long long nnz,
                     int d, cudaStream_t stream) {
  if (d <= 32) return launch<T, 1>(msgs, offsets, out, n, nnz, d, stream);
  if (d <= 64) return launch<T, 2>(msgs, offsets, out, n, nnz, d, stream);
  if (d <= 128) return launch<T, 4>(msgs, offsets, out, n, nnz, d, stream);
  return launch<T, 8>(msgs, offsets, out, n, nnz, d, stream);
}

}  // namespace

extern "C" {

// out (n, d) f32 = per-segment sums of msgs (nnz, d) over offsets (n + 1,)
// int64; msgs f32 (msgs_is_bf16 = 0) or bf16, row-major and contiguous.
// Returns the launch's cudaError_t.
int segsum_forward(const void* msgs, int msgs_is_bf16, const void* offsets, void* out, int n,
                   long long nnz, int d, void* stream) {
  if (n <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (msgs_is_bf16) return dispatch<__nv_bfloat16>(msgs, offsets, out, n, nnz, d, s);
  return dispatch<float>(msgs, offsets, out, n, nnz, d, s);
}

}  // extern "C"
