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
// the segment boundaries are given, so no window exists, and the edges of
// a long segment are split over warps:
//
//   Warps [pieces, pieces + n) take one segment each (kWarps a block):
//   lane l owns the columns tile * 32 * CPL + l + 32 * j, j < CPL, in f32
//   registers; the warp walks the segment's edges in order, kUnroll edges'
//   loads before their adds, and writes its row of out once (zeros for an
//   empty segment). A segment longer than a piece (kPiece = 256 edges) it
//   leaves alone. Warps [0, pieces) take one piece of 256 consecutive edges
//   each, ahead of the segments in the grid. A
//   piece warp finds the segment that holds its first edge by a 32-way
//   search over offsets; if that segment is long and started before the
//   piece, the warp sums its share of it (and the share in the piece before,
//   where the segment started there) into a partial: tail[q] for the piece
//   q where the segment starts, head[q] for each later one. Each such share
//   takes a ticket (an atomic counter per segment and column tile, not on
//   values); the last sums the partials in piece order, writes the row and
//   resets the ticket, so calls on one stream need no memset. Widths above
//   32 * CPL = 256 columns take more column tiles (grid y).
//
// Consequences: no atomics on values, so the result is bitwise the same from
// run to run (a segment of at most 256 edges is one f32 sum in edge order; a
// longer one the sum in piece order of per-piece sums in edge order,
// whichever piece finishes last); every row is written once; no host plan
// and no host synchronisation. No warp walks more than 512 edges of a hub,
// however long it is. Index arithmetic is int64 (edge * d exceeds int32 at
// 33.6M edges of d 64). The segment warps keep the register count of one
// warp a segment (40 at d <= 64, 64 at d <= 128), so an SM holds as many of
// them as a kernel of segment warps alone; the rarer piece path spills a few
// words there.
//
// Bound: memory. Each message is read once and each output row written once;
// there is one f32 add per message element (0.06 flop/byte). At the yelp shape
// (nnz 307,200, d 64, f32 messages, n 38,403): 78.6 MB of messages + 9.8 MB of
// output + 0.3 MB of offsets, about 26.5 us at 3.35 TB/s. The partials add
// 2 x 256 bytes per crossing segment and piece (a 38,400-edge hub: 150
// pieces, 38 KB). The per-edge gather z[cols[e]] that makes msgs stays
// outside the kernel, as the TPU package keeps its `take` outside its kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPiece = 256;  // edges of a piece; a longer segment is summed by pieces
constexpr int kUnroll = 8;   // edges whose loads a warp issues together
constexpr int kFold = 8;     // partials whose loads the fold issues together
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc += msgs rows [a, b) in edge order, kUnroll rows' loads before their adds
template <typename T, int CPL>
__device__ __forceinline__ void sum_rows(float (&acc)[CPL], const T* __restrict__ msgs,
                                         long long a, long long b, int d, int col0) {
  long long e = a;
  for (; e + kUnroll <= b; e += kUnroll) {
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
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] += v[u][j];
  }
  for (; e < b; ++e) {
    const T* row = msgs + e * d;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + 32 * j;
      if (c < d) acc[j] += to_f32(row[c]);
    }
  }
}

template <int CPL>
__device__ __forceinline__ void put_row(float* dst, const float (&acc)[CPL], int d, int col0) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = col0 + 32 * j;
    if (c < d) dst[c] = acc[j];
  }
}

// blocks an SM holds: the registers of the segment path (see the top of the file)
template <int CPL>
constexpr int min_blocks() { return CPL <= 2 ? 6 : CPL == 4 ? 4 : 1; }

// Warps [0, pieces) take one piece each, the rest one segment each (see the
// top of the file): the pieces start first, so a hub's partials are ready
// while the segments stream.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads, min_blocks<CPL>())
    segsum_kernel(const T* __restrict__ msgs, const long long* __restrict__ offsets,
                  float* __restrict__ out, float* __restrict__ head, float* __restrict__ tail,
                  unsigned* __restrict__ tickets, int n, long long nnz, int d) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int col0 = blockIdx.y * (32 * CPL) + lane;
  auto cut = [&](long long v) { return v < 0 ? 0 : (v > nnz ? nnz : v); };
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;

  const long long pieces = (nnz + kPiece - 1) / kPiece;
  if (gw >= pieces) {
    // one segment: summed here unless it is longer than a piece
    const long long s = gw - pieces;
    if (s >= n) return;
    const long long lo = cut(offsets[s]), hi = cut(offsets[s + 1]);
    if (hi - lo > kPiece) return;
    sum_rows<T, CPL>(acc, msgs, lo, hi, d, col0);
    put_row<CPL>(out + s * d, acc, d, col0);
    return;
  }
  const long long w = gw;

  // piece w: edges [e0, e1); its share of each long segment that reaches it
  const long long e0 = w * kPiece;
  const long long e1 = min(e0 + kPiece, nnz);
  // the first segment in [a, n) whose end cut(offsets[s + 1]) is past x:
  // 32 probes a round; the ends do not decrease, so the probes at or
  // before x are a prefix of the lanes
  auto search = [&](long long a, long long x) {
    long long b = n;
    while (a < b) {
      const long long len = b - a;
      const bool before = cut(offsets[a + len * lane / 32 + 1]) <= x;
      const int k = __popc(__ballot_sync(kAll, before));
      if (k == 0) break;
      const long long nb = k < 32 ? a + len * k / 32 : b;
      a = a + len * (k - 1) / 32 + 1;
      b = nb;
    }
    return a;
  };
  // segment s's edges [a, b): a partial, in slot tail[q] of the piece q
  // where it starts, head[q] in each later one; the last of its pieces to
  // get here adds them in piece order.
  auto part = [&](long long s, long long lo, long long hi, long long a, long long b,
                  float* slot) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
    sum_rows<T, CPL>(acc, msgs, a, b, d, col0);
    put_row<CPL>(slot, acc, d, col0);
    __threadfence();
    __syncwarp();
    unsigned* tk = tickets + s * gridDim.y + blockIdx.y;
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(tk, 1u);
    t = __shfl_sync(kAll, t, 0);
    const long long q0 = lo / kPiece, q1 = (hi - 1) / kPiece;
    if (t != (unsigned)(q1 - q0)) return;
    if (lane == 0) *tk = 0u;
    __threadfence();
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
    for (long long q = q0; q <= q1; q += kFold) {
      float v[kFold][CPL];
#pragma unroll
      for (int u = 0; u < kFold; ++u) {
        const float* row = (q + u == q0 ? tail : head) + (q + u) * d;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = col0 + 32 * j;
          v[u][j] = q + u <= q1 && c < d ? __ldcg(row + c) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kFold; ++u)
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[j] += v[u][j];
    }
    put_row<CPL>(out + s * d, acc, d, col0);
  };

  // A long segment (more than 256 edges) holds the first edge of every
  // piece after the one where it starts, so one search finds it: this
  // piece sums its own share, and the previous piece's share too when the
  // segment started there.
  const long long s = search(0, e0);
  if (s >= n) return;
  const long long lo = cut(offsets[s]), hi = cut(offsets[s + 1]);
  if (hi - lo <= kPiece || lo >= e0) return;
  if (lo >= e0 - kPiece) part(s, lo, hi, lo, e0, tail + (w - 1) * d);
  part(s, lo, hi, e0, min(hi, e1), head + w * d);
}

template <typename T, int CPL>
cudaError_t launch(const void* msgs, const void* offsets, void* out, float* head, float* tail,
                   void* tickets, int n, long long nnz, int d, cudaStream_t stream) {
  const long long pieces = (nnz + kPiece - 1) / kPiece;
  const dim3 grid((unsigned)((n + pieces + kWarps - 1) / kWarps), (d + 32 * CPL - 1) / (32 * CPL));
  segsum_kernel<T, CPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(msgs), static_cast<const long long*>(offsets),
      static_cast<float*>(out), head, tail, static_cast<unsigned*>(tickets), n, nnz, d);
  return cudaGetLastError();
}

int cpl(int d) { return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8; }

template <typename T>
cudaError_t dispatch(const void* msgs, const void* offsets, void* out, float* head, float* tail,
                     void* tickets, int n, long long nnz, int d, cudaStream_t stream) {
  switch (cpl(d)) {
    case 1: return launch<T, 1>(msgs, offsets, out, head, tail, tickets, n, nnz, d, stream);
    case 2: return launch<T, 2>(msgs, offsets, out, head, tail, tickets, n, nnz, d, stream);
    case 4: return launch<T, 4>(msgs, offsets, out, head, tail, tickets, n, nnz, d, stream);
    default: return launch<T, 8>(msgs, offsets, out, head, tail, tickets, n, nnz, d, stream);
  }
}

}  // namespace

extern "C" {

// Scratch of a call: out[0] f32 values of the partials (head and tail, a
// row of d per piece each), out[1] int32 tickets (zero before the first
// call; the kernel leaves them zero).
void segsum_scratch(int n, long long nnz, int d, long long* out) {
  const long long pieces = (nnz + kPiece - 1) / kPiece;
  out[0] = 2 * pieces * d;
  out[1] = (long long)n * ((d + 32 * cpl(d) - 1) / (32 * cpl(d)));
}

// out (n, d) f32 = per-segment sums of msgs (nnz, d) over offsets (n + 1,)
// int64; msgs f32 (msgs_is_bf16 = 0) or bf16, row-major and contiguous;
// scratch and tickets as segsum_scratch sizes them. Returns the launch's
// cudaError_t. nnz must be positive (with no edges every row is zero).
int segsum_forward(const void* msgs, int msgs_is_bf16, const void* offsets, void* out,
                   void* scratch, void* tickets, int n, long long nnz, int d, void* stream) {
  if (n <= 0 || d <= 0) return cudaSuccess;
  if (nnz <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* head = static_cast<float*>(scratch);
  float* tail = head + (nnz + kPiece - 1) / kPiece * d;
  if (msgs_is_bf16)
    return dispatch<__nv_bfloat16>(msgs, offsets, out, head, tail, tickets, n, nnz, d, s);
  return dispatch<float>(msgs, offsets, out, head, tail, tickets, n, nnz, d, s);
}

}  // extern "C"
