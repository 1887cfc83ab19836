// K4: a gather-fused sorted segment sum over CSR offsets,
//
//     out[s, m*d + c] = sum_{offsets[s] <= e < offsets[s + 1], 0 <= e < nnz} table_m[src_m[e], c]
//
// for s < n, c < d, m < M: M tables (M, R, d), f32 or bf16, one index
// vector src_m (nnz,) int32 each, f32 sums into out (n, M * d) f32. A row
// index outside [0, R) reads as a zero row (the backward's edges whose
// forward segment is a pad). offsets (n + 1,) int64 are the non-decreasing
// segment boundaries of ascending segment ids; edges past offsets[n] (the
// sentinel pads) are never read, and a boundary outside [0, nnz] is cut to
// it. With every src_m null the row of edge e is e: the plain segment sum of
// a (nnz, d) message tensor, the port's earlier K4 (the unfused route).
//
// Replaces diffmm_tpu/ops/pallas/segsum.py::_segsum_kernel (called from
// _sorted_segment_sum_impl) together with the `take` in front of it
// (diffmm_tpu/ops/graph.py::_get_propagator): the TPU kernel takes gathered
// messages because a Pallas TPU kernel cannot gather rows cheaply, and adds
// one-hot products of edge chunks into a VMEM window. Hopper gathers rows
// from L2, so the whole function is one call (a small plan launch, then the
// sums) and no (nnz, d) message tensor exists.
//
// Bound: memory. What the function must move is the table's rows that the
// edges name, the indices, the offsets and the output, each once: at the
// yelp shape (307,200 edges, d 64, f32) about 5.1 + 1.2 + 0.3 + 9.8 MB,
// 4.9 us at 3.35 TB/s. The gathered rows are 78.6 MB; the table (5-10 MB)
// fits the 50 MB L2, so its rows are copied with an evict_last policy and
// come from L2, while the indices stream through (__ldcs). So the L2's
// gather rate and the latency of each segment's chain of rows, not HBM,
// set the time; one f32 add per gathered element.
//
// Work split. A small first launch (segsum_plan, one thread a segment)
// writes the plan; then warps [0, pieces) are piece warps, one per 256 edges
// (kPiece), and the rest segment warps. Segment warp w takes the segments
// whose merge key s + offsets[s] lies in [w * group, (w + 1) * group): a
// merge path over segments and edges, so a warp gets at most `group` segment
// starts and edges together, and runs of empty segments and skewed degrees
// both spread over warps; the plan holds each warp's first segment, so no
// warp searches. The warp walks its segments' edges as one stream in edge
// order (walk): 32 indices in one coalesced load a chunk ahead, handed out
// by __shfl_sync; the rows copied with cp.async (4-, 8- or 16-byte vectors a
// lane) into a ring of 8 KB a warp in shared memory, up to 3/4 of it in
// flight while the oldest quarter is added, across segment boundaries, so a
// segment's sequential chain of adds waits on few round trips and no
// register holds a row in flight; each segment's row is written once, when
// the stream passes its end (zeros for an empty one). A segment longer than
// a piece (a hub; its key spacing, over 256, exceeds any group, so it is the
// last of its warp's segments) is left to the piece warps: the plan names,
// for piece w, the long segment that holds its first edge and started before
// the piece, if there is one; the warp sums its share (and the share in the
// piece before, where the segment started there) into a partial, takes a
// ticket (an atomic counter per segment and column tile, not on values), and
// the last sums the partials in piece order, writes the row and resets the
// ticket. Widths above 32 * CPL take more column tiles, and each modality
// its own (grid y).
//
// The summation order is the earlier K4's on the gathered messages: a
// segment of at most 256 edges is one f32 sum in edge order from zero, a
// longer one the sum in piece order of per-piece sums in edge order, and a
// zero row adds +0.0 (which leaves a sum that started at +0.0 unchanged).
// So the fused launch is bitwise the unfused route, and bitwise from run
// to run: no atomics on values, one write per output row, no host plan or
// synchronisation, int64 edge and element arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPiece = 256;  // edges of a piece; a longer segment is summed by pieces
constexpr int kFold = 8;     // partials whose loads the fold issues together
constexpr int kMaxModal = 4;
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const void* table;           // (M, R, d), f32 or bf16
  const int* src[kMaxModal];   // rows of each edge per modality; all null: row = edge
  const long long* offsets;    // (n + 1,)
  float* out;                  // (n, M * d)
  float* head;                 // (pieces, M * d) partials of the piece where a hub starts
  float* tail;                 // (pieces, M * d) partials of every later piece
  unsigned* tickets;           // (n, gridDim.y)
  const int* first;            // (groups + 1,) the plan: each segment warp's first segment
  const int* pseg;             // (pieces,) the plan: each piece warp's long segment, or -1
  long long nnz, pieces, groups;
  int n, rows, d, modal, tiles, group;
};

__device__ __forceinline__ unsigned long long keep_policy() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// BYTES (4, 8 or 16) from global src into shared dst without registers, or
// zeros (take false: src-size 0, nothing read); L2 policy pol
template <int BYTES>
__device__ __forceinline__ void copy_async(char* dst, const void* src, bool take, unsigned long long pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = take ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;"
                 :: "r"(s), "l"(src), "r"(n), "l"(pol) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3, %4;"
                 :: "r"(s), "l"(src), "n"(BYTES), "r"(n), "l"(pol) : "memory");
  }
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Lane l owns, of its column tile, the VEC columns at col0 + 32 * VEC * j
// (j < J), col0 = tile * 32 * CPL + l * VEC; acc[j * VEC + v] is column
// col0 + 32 * VEC * j + v.
template <bool BF, int VEC, int J>
struct Tile {
  static constexpr int CPL = VEC * J;
  static constexpr int kBytes = BF ? 2 : 4;
  const char* base;  // the modality's table
  int rows, d, col0;
  unsigned long long pol;

  __device__ __forceinline__ void put(float* dst, const float (&acc)[CPL]) const {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = col0 + 32 * VEC * j;
      if (c >= d) continue;
      float* q = dst + c;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(q) =
            make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      } else if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(q) = make_float2(acc[2 * j], acc[2 * j + 1]);
      } else {
        *q = acc[j];
      }
    }
  }

  // cp.async of row r's columns into the ring slot at dst (lane l's vector j
  // at dst + (j * 32 + l) * kVec), zeros for a row outside the table or an
  // edge not taken (src-size 0: nothing is read)
  static constexpr int kVec = VEC * kBytes;
  __device__ __forceinline__ void copy(char* dst, int r, bool take, int lane) const {
    const bool in = take && (unsigned)r < (unsigned)rows;
    const char* row = base + (long long)r * d * kBytes;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = col0 + 32 * VEC * j;
      const bool ok = in && c < d;
      copy_async<kVec>(dst + (j * 32 + lane) * kVec, ok ? row + (long long)c * kBytes : base, ok, pol);
    }
  }

  // a ring slot's columns, as copy left them
  __device__ __forceinline__ void read(float (&v)[CPL], const char* src, int lane) const {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const char* q = src + (j * 32 + lane) * kVec;
      float* o = v + j * VEC;
      if constexpr (kVec == 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(q);
        o[0] = __uint_as_float(w.x); o[1] = __uint_as_float(w.y);
        o[2] = __uint_as_float(w.z); o[3] = __uint_as_float(w.w);
      } else if constexpr (kVec == 8) {
        const uint2 w = *reinterpret_cast<const uint2*>(q);
        if constexpr (BF) {
          o[0] = lo_bf16(w.x); o[1] = hi_bf16(w.x); o[2] = lo_bf16(w.y); o[3] = hi_bf16(w.y);
        } else {
          o[0] = __uint_as_float(w.x); o[1] = __uint_as_float(w.y);
        }
      } else {
        const unsigned w = *reinterpret_cast<const unsigned*>(q);
        if constexpr (BF) {
          o[0] = lo_bf16(w); o[1] = hi_bf16(w);
        } else {
          o[0] = __uint_as_float(w);
        }
      }
    }
  }

  // a partial written by another block: through L2
  __device__ __forceinline__ void load_partial(float (&v)[CPL], const float* src, bool take) const {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = col0 + 32 * VEC * j;
      if (take && c < d) {
        if constexpr (VEC == 4) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(src + c));
          v[4 * j] = x.x; v[4 * j + 1] = x.y; v[4 * j + 2] = x.z; v[4 * j + 3] = x.w;
        } else if constexpr (VEC == 2) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(src + c));
          v[2 * j] = x.x; v[2 * j + 1] = x.y;
        } else {
          v[j] = __ldcg(src + c);
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[j * VEC + k] = 0.0f;
      }
    }
  }
};

template <int CPL>
__device__ __forceinline__ void add(float (&acc)[CPL], const float (&v)[CPL]) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] += v[k];
}

template <int CPL>
__device__ __forceinline__ void zero(float (&acc)[CPL]) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.0f;
}

__device__ __forceinline__ long long cut(long long v, long long nnz) {
  return v < 0 ? 0 : (v > nnz ? nnz : v);
}

// the row of edge e (lanes whose edge lies outside the stream read nothing)
__device__ __forceinline__ int row_of(const int* src, long long e, bool take) {
  if (!take) return 0;
  return src ? __ldcs(src + e) : (int)e;
}

// The rows of a warp's stream in flight, in shared memory: kRing bytes a
// lane (64 words), slots of 32 lanes x CPL values, kDepth commit groups.
constexpr int kRing = 256;
constexpr int kDepth = 4;
template <bool BF, int CPL>
__host__ __device__ constexpr int ring_slots() { return kRing / (CPL * (BF ? 2 : 4)); }

// acc += the rows of edges [a, b), in edge order, each add after
// before_add(e). The indices come 32 at a time, one coalesced load a chunk
// ahead, handed out by __shfl_sync; the rows are copied (cp.async) into the
// warp's ring in shared memory, kDepth - 1 groups of ring_slots / kDepth
// rows in flight ahead of the group being added, no registers held for
// them. Each lane reads back only what it copied itself: no barrier.
template <bool BF, int VEC, int J, typename Before>
__device__ __forceinline__ void walk(float (&acc)[VEC * J], const Tile<BF, VEC, J>& t, char* ring,
                                     const int* src, long long a, long long b, int lane, Before before_add) {
  constexpr int CPL = VEC * J, SLOTS = ring_slots<BF, CPL>(), G = SLOTS / kDepth;
  constexpr int kSlot = J * 32 * Tile<BF, VEC, J>::kVec;  // bytes of a slot
  if (a >= b) return;
  long long c = a;  // the first edge of the chunk whose indices r_cur holds
  int r_cur = row_of(src, a + lane, a + lane < b);
  int r_nxt = row_of(src, a + 32 + lane, a + 32 + lane < b);
  long long next = a;  // the first edge of the next group to copy
  int slot = 0;        // its first slot
  // copy the rows of edges [next, next + G) (G divides 32: one chunk); a
  // group past b is empty, so every step waits on the same count
  auto start_group = [&]() {
    if (next < b) {
      if (next - c >= 32) {
        c += 32;
        r_cur = r_nxt;
        r_nxt = row_of(src, c + 32 + lane, c + 32 + lane < b);
      }
      const int k = (int)(next - c);
#pragma unroll
      for (int u = 0; u < G; ++u)
        t.copy(ring + (slot + u) * kSlot, __shfl_sync(kAll, r_cur, k + u), next + u < b, lane);
    }
    commit_copies();
    next += G;
    slot = (slot + G) % SLOTS;
  };
#pragma unroll
  for (int g = 0; g < kDepth - 1; ++g) start_group();
  int used = 0;  // the first slot of the group being added
  for (long long e = a; e < b; e += G) {
    start_group();
    wait_copies<kDepth - 1>();
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (e + u >= b) break;
      float v[CPL];
      t.read(v, ring + (used + u) * kSlot, lane);
      before_add(e + u);
      add<CPL>(acc, v);
    }
    used = (used + G) % SLOTS;
  }
  wait_copies<0>();
}

// blocks an SM holds: a cap on the registers of the segment stream
template <int CPL>
constexpr int min_blocks() { return CPL <= 4 ? 3 : 2; }

template <bool BF, int VEC, int J>
__global__ void __launch_bounds__(kThreads, min_blocks<VEC * J>()) segsum_kernel(const Params p) {
  constexpr int CPL = VEC * J;
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int m = blockIdx.y / p.tiles;
  const int width = p.modal * p.d;
  Tile<BF, VEC, J> t;
  t.base = static_cast<const char*>(p.table) + (long long)m * p.rows * p.d * t.kBytes;
  t.rows = p.rows;
  t.d = p.d;
  t.col0 = (blockIdx.y % p.tiles) * 32 * CPL + lane * VEC;
  t.pol = keep_policy();
  // (a constant index into the parameters, not a copy of them to local memory)
  const int* src = m == 0 ? p.src[0] : m == 1 ? p.src[1] : m == 2 ? p.src[2] : p.src[3];
  const long long nnz = p.nnz, n = p.n;
  const long long* off = p.offsets;
  auto at = [&](long long i) { return cut(__ldg(off + i), nnz); };
  float* out = p.out + (long long)m * p.d;  // row s at out + s * width
  // the modality's partials of piece q at head/tail + q * width (locals: the
  // lambdas below capture no kernel parameter)
  float* head = p.head + (long long)m * p.d;
  float* tail = p.tail + (long long)m * p.d;
  unsigned* tickets = p.tickets;
  float acc[CPL];
  zero<CPL>(acc);
  extern __shared__ __align__(16) char smem[];
  char* ring = smem + (threadIdx.x >> 5) * kRing * 32;

  if (gw >= p.pieces) {
    // segment warp w: the segments [first[w], first[w + 1]), those whose
    // merge key s + offsets[s] lies in [w * group, (w + 1) * group)
    const long long w = gw - p.pieces;
    if (w >= p.groups) return;  // the last block's spare warps
    const long long s0 = __ldg(p.first + w);
    long long s1 = __ldg(p.first + w + 1);
    if (s1 <= s0) return;
    // the segments' boundaries, 32 at a time: lane l holds at(sb + l)
    long long sb = s0;
    long long ob = at(min(sb + lane, n));
    // its last segment may be a hub: the piece warps sum that one
    long long last_lo, last_hi;
    if (s1 - s0 < 32) {
      last_lo = __shfl_sync(kAll, ob, (int)(s1 - 1 - s0));
      last_hi = __shfl_sync(kAll, ob, (int)(s1 - s0));
    } else {
      last_lo = at(s1 - 1);
      last_hi = at(s1);
    }
    const bool hub = last_hi - last_lo > kPiece;
    const long long e0 = __shfl_sync(kAll, ob, 0), end = hub ? last_lo : last_hi;
    s1 -= hub;
    if (s1 <= s0) return;
    long long s = s0;
    long long hi = __shfl_sync(kAll, ob, 1);
    // write segment s, go to s + 1
    auto flush = [&]() {
      t.put(out + s * width, acc);
      zero<CPL>(acc);
      ++s;
      if (s + 1 - sb >= 32) {
        sb = s;
        ob = at(min(sb + lane, n));
      }
      hi = __shfl_sync(kAll, ob, (int)(s + 1 - sb));
    };
    walk<BF, VEC, J>(acc, t, ring, src, e0, end, lane, [&](long long e) {
      while (e >= hi) flush();
    });
    while (s < s1) flush();
    return;
  }

  // piece warp w: edges [e0, e1); its share of the long segment that
  // reaches it
  const long long w = gw;
  const long long e0 = w * kPiece, e1 = min(e0 + kPiece, nnz);
  // segment s's edges [a, b): a partial, in slot tail[q] of the piece q
  // where it starts, head[q] in each later one; the last of its pieces to
  // get here adds them in piece order.
  auto part = [&](long long s, long long lo, long long hi, long long a, long long b, float* slot) {
    zero<CPL>(acc);
    walk<BF, VEC, J>(acc, t, ring, src, a, b, lane, [](long long) {});
    t.put(slot, acc);
    __threadfence();
    __syncwarp();
    unsigned* tk = tickets + s * gridDim.y + blockIdx.y;
    unsigned tn = 0;
    if (lane == 0) tn = atomicAdd(tk, 1u);
    tn = __shfl_sync(kAll, tn, 0);
    const long long q0 = lo / kPiece, q1 = (hi - 1) / kPiece;
    if (tn != (unsigned)(q1 - q0)) return;
    if (lane == 0) *tk = 0u;
    __threadfence();
    zero<CPL>(acc);
    for (long long q = q0; q <= q1; q += kFold) {
      float v[kFold][CPL];
#pragma unroll
      for (int u = 0; u < kFold; ++u)
        t.load_partial(v[u], (q + u == q0 ? tail : head) + (q + u) * width, q + u <= q1);
#pragma unroll
      for (int u = 0; u < kFold; ++u) add<CPL>(acc, v[u]);
    }
    t.put(out + s * width, acc);
  };
  // The long segment that holds e0 and started before it (segsum_plan):
  // this piece sums its own share, and the previous piece's share too when
  // the segment started there.
  const long long s = __ldg(p.pseg + w);
  if (s < 0) return;
  const long long lo = at(s), hi = at(s + 1);
  if (lo >= e0 - kPiece) part(s, lo, hi, lo, e0, tail + (w - 1) * width);
  part(s, lo, hi, e0, min(hi, e1), head + w * width);
}

// The plan of a call, one thread per s in [0, n]: first[w] for every merge
// group w, the first segment whose key s + offsets[s] is at or past
// w * group (n past the last segment; thread s takes the groups w with
// key(s - 1) < w * group <= key(s)); pseg[q] for every piece q, the long
// segment that holds the piece's first edge and started before it, else -1
// (thread s takes the pieces whose first edge lies in its edges, thread n
// those past offsets[n]). Every entry is written on every call: no memset.
// A thread writes the first kOwn entries of each of its two ranges; the
// rest (after a hub: hundreds of groups, one piece per 256 edges) the
// whole warp writes, 32 at a time.
__global__ void __launch_bounds__(kThreads) segsum_plan(const long long* __restrict__ offsets,
                                                        int* __restrict__ first, int* __restrict__ pseg,
                                                        int n, long long nnz, int group, long long groups) {
  constexpr int kOwn = 4;
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  auto at = [&](long long i) { return cut(__ldg(offsets + i), nnz); };
  long long w0 = 0, w1 = 0, q0 = 0, q1 = 0, lo = 0;
  bool hub = false;
  if (s <= n) {
    lo = at(s);
    const long long hi = s < n ? at(s + 1) : nnz;
    const long long key_before = s == 0 ? -1 : s - 1 + at(s - 1);
    const long long key = s < n ? s + lo : groups * group;
    w0 = (key_before + group) / group;
    w1 = min(key / group, groups) + 1;
    q0 = ((s == 0 ? 0 : lo) + kPiece - 1) / kPiece;
    q1 = (hi + kPiece - 1) / kPiece;
    hub = s < n && hi - lo > kPiece;
  }
  for (long long w = w0; w < min(w1, w0 + kOwn); ++w) first[w] = (int)s;
  for (long long q = q0; q < min(q1, q0 + kOwn); ++q) pseg[q] = hub && lo < q * kPiece ? (int)s : -1;
  unsigned longer = __ballot_sync(kAll, w1 - w0 > kOwn || q1 - q0 > kOwn);
  while (longer) {
    const int l = __ffs(longer) - 1;
    longer &= longer - 1;
    const long long ls = __shfl_sync(kAll, s, l), llo = __shfl_sync(kAll, lo, l);
    const long long lw0 = __shfl_sync(kAll, w0, l), lw1 = __shfl_sync(kAll, w1, l);
    const long long lq0 = __shfl_sync(kAll, q0, l), lq1 = __shfl_sync(kAll, q1, l);
    const bool lhub = __shfl_sync(kAll, hub, l);
    for (long long w = lw0 + kOwn + lane; w < lw1; w += 32) first[w] = (int)ls;
    for (long long q = lq0 + kOwn + lane; q < lq1; q += 32) pseg[q] = lhub && llo < q * kPiece ? (int)ls : -1;
  }
}

int cpl(int d) { return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8; }

long long merge_groups(int n, long long nnz, int group) { return (n + nnz + group - 1) / group; }

template <bool BF, int VEC, int J>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  segsum_plan<<<(unsigned)((p.n + kThreads) / kThreads), kThreads, 0, stream>>>(
      p.offsets, const_cast<int*>(p.first), const_cast<int*>(p.pseg), p.n, p.nnz, p.group, p.groups);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.pieces + p.groups + kWarps - 1) / kWarps), (unsigned)(p.modal * p.tiles));
  constexpr int smem = kWarps * kRing * 32;
  static const cudaError_t allowed =
      cudaFuncSetAttribute(segsum_kernel<BF, VEC, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return allowed;
  segsum_kernel<BF, VEC, J><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// VEC: 16-, 8- or 4-byte copies where the width and the table's address
// allow (a bf16 table takes at least two columns a lane: cp.async moves 4
// bytes or more)
cudaError_t dispatch_f32(const Params& p, int vec, cudaStream_t s) {
  const int c = cpl(p.d);
  switch (c * 8 + (vec < c ? vec : c)) {
    case 1 * 8 + 1: return launch<false, 1, 1>(p, s);
    case 2 * 8 + 2: return launch<false, 2, 1>(p, s);
    case 2 * 8 + 1: return launch<false, 1, 2>(p, s);
    case 4 * 8 + 4: return launch<false, 4, 1>(p, s);
    case 4 * 8 + 2: return launch<false, 2, 2>(p, s);
    case 4 * 8 + 1: return launch<false, 1, 4>(p, s);
    case 8 * 8 + 4: return launch<false, 4, 2>(p, s);
    case 8 * 8 + 2: return launch<false, 2, 4>(p, s);
    default: return launch<false, 1, 8>(p, s);
  }
}

cudaError_t dispatch_bf16(const Params& p, int vec, cudaStream_t s) {
  const int c = cpl(p.d) < 2 ? 2 : cpl(p.d);
  switch (c * 8 + (vec < c ? vec : c)) {
    case 2 * 8 + 2: return launch<true, 2, 1>(p, s);
    case 4 * 8 + 4: return launch<true, 4, 1>(p, s);
    case 4 * 8 + 2: return launch<true, 2, 2>(p, s);
    case 8 * 8 + 4: return launch<true, 4, 2>(p, s);
    case 8 * 8 + 2: return launch<true, 2, 4>(p, s);
    default: return cudaErrorInvalidValue;  // one column a copy: the wrapper widens such a table to f32
  }
}

}  // namespace

extern "C" {

// Scratch of a call: out[0] f32 values of the partials (head and tail, a
// row of M * d per piece each), out[1] int32 words: the tickets (zero
// before the first call; the kernel leaves them zero), then the plan
// (first and pseg, written by every call).
void segsum_scratch(int n, long long nnz, int modal, int d, int group, long long* out) {
  const long long pieces = (nnz + kPiece - 1) / kPiece;
  out[0] = 2 * pieces * modal * d;
  out[1] = (long long)n * modal * ((d + 32 * cpl(d) - 1) / (32 * cpl(d))) + merge_groups(n, nnz, group) + 1 +
           pieces;
}

// out (n, modal * d) f32: segment sums over offsets (n + 1,) int64 of the
// rows src[m][e] of table m, table (modal, rows, d) f32 (table_is_bf16 = 0)
// or bf16, row-major and contiguous; src holds modal int32 (nnz,) vectors,
// or nulls for row = edge; vec (1, 2 or 4) the widest load the table's
// address allows; group the merge items of a segment warp (at most 256);
// scratch and tickets as segsum_scratch sizes them. Launches the plan, then
// the sums, on the stream; returns the first nonzero cudaError_t. nnz must
// be positive (with no edges every row is zero).
int segsum_forward(const void* table, int table_is_bf16, const void* const* src, int modal, int rows,
                   int d, int vec, const void* offsets, void* out, void* scratch, void* tickets, int n,
                   long long nnz, int group, void* stream) {
  if (n <= 0 || d <= 0) return cudaSuccess;
  if (nnz <= 0 || modal < 1 || modal > kMaxModal || group < 1 || group > kPiece)
    return cudaErrorInvalidValue;
  Params p;
  p.table = table;
  for (int m = 0; m < kMaxModal; ++m) p.src[m] = m < modal ? static_cast<const int*>(src[m]) : nullptr;
  p.offsets = static_cast<const long long*>(offsets);
  p.out = static_cast<float*>(out);
  p.pieces = (nnz + kPiece - 1) / kPiece;
  p.head = static_cast<float*>(scratch);
  p.tail = p.head + p.pieces * modal * d;
  p.tickets = static_cast<unsigned*>(tickets);
  p.tiles = (d + 32 * cpl(d) - 1) / (32 * cpl(d));
  p.first = reinterpret_cast<const int*>(p.tickets) + (long long)n * modal * p.tiles;
  p.groups = merge_groups(n, nnz, group);
  p.pseg = p.first + p.groups + 1;
  p.nnz = nnz;
  p.n = n;
  p.rows = rows;
  p.d = d;
  p.modal = modal;
  p.group = group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_is_bf16 ? dispatch_bf16(p, vec, s) : dispatch_f32(p, vec, s);
}

}  // extern "C"
