// Adam: one f32 step over every leaf of a parameter tree in one pass,
//
//     mu = mu * b1 + (1 - b1) * g
//     nu = nu * b2 + (1 - b2) * g * g
//     p  = p - ((mu / bc1) / (sqrt(nu / bc2) + eps)) * lr
//
// with b1 0.9, b2 0.999, eps 1e-8, and lr, bc1 = 1 - b1^t, bc2 = 1 - b2^t read
// from a (3,) f32 row on the card (train/optim.py::adam_scalars), so a
// captured CUDA graph replays it with each step's row.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses optax's update
// (diffmm_tpu/train/optim.py) into the step's program. The port ran it as
// eleven torch._foreach_* passes (train/optim.py::_adam_f32), each over the
// whole tree, about 106 bytes a parameter with two tree-sized temporaries.
//
// Bound: memory. The function reads p, g, mu and nu and writes p, mu and nu,
// 28 bytes a parameter, with a dozen flops; 258 M parameters (two denoisers
// at I 63,001, hidden 1,024) take 2.16 ms at 3.35 TB/s. So the kernel moves
// each byte once: one launch over all the tree's leaves (a table of their
// pointers and lengths in the kernel's parameters), a grid of one wave (the
// blocks every SM holds at once: a second, partial wave cost 1.4-2.7% of the
// time) walking each leaf in turn, every thread issuing the 16-byte loads
// of all four streams for two units of 4 elements before any arithmetic,
// then storing p, mu and nu; no temporaries. It runs at 82-84% of the bound
// on the denoisers' trees (PERF.md); streaming cache hints and a register
// cap for a fourth block an SM measured no faster. A leaf whose p, mu and
// nu share an alignment runs 16-byte accesses after a head of up to 3
// single elements; its g (a view into a mesh's flat all-reduce buffer, cut
// at leaf boundaries such as 63,001 floats) is read 16 bytes at a time where
// it shares that alignment too, else as four single loads; a leaf whose p,
// mu and nu differ in alignment runs single elements throughout.
//
// Bits: each operation is rounded to f32 as the _foreach passes round it
// (held bit for bit against _adam_f32 on the card): the moment updates are
// a product, then a fused multiply-add (torch's add with alpha and addcmul
// compute input + alpha * value as one fma); the divisions and the square
// root are correctly rounded; the constants are the f32 roundings of the
// doubles the passes take (1 - 0.9, 1 - 0.999).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 48;  // a table of 48 leaves fits the 4 KB of kernel parameters
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kC1 = (float)(1.0 - 0.9);
constexpr float kC2 = (float)(1.0 - 0.999);
constexpr float kEps = 1e-8f;

struct Leaf {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  long long n;      // elements
  long long head;   // single elements before the 16-byte body (all n where there is none)
  long long units;  // 4-element units of the body; single elements again after it, to n
  int g_vec;        // g shares the body's alignment
};

struct Table {
  Leaf leaf[kMaxLeaves];
  const float* scalars;  // (3,): lr, bc1, bc2
  int count;
};

__device__ __forceinline__ void adam(float& p, float g, float& mu, float& nu, float lr, float bc1, float bc2) {
  mu = __fmaf_rn(kC1, g, __fmul_rn(mu, kB1));
  nu = __fmaf_rn(kC2, __fmul_rn(g, g), __fmul_rn(nu, kB2));
  const float d = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), kEps);
  p = __fsub_rn(p, __fmul_rn(__fdiv_rn(__fdiv_rn(mu, bc1), d), lr));
}

__device__ __forceinline__ void adam4(float4& p, float4 g, float4& mu, float4& nu, float lr, float bc1,
                                      float bc2) {
  adam(p.x, g.x, mu.x, nu.x, lr, bc1, bc2);
  adam(p.y, g.y, mu.y, nu.y, lr, bc1, bc2);
  adam(p.z, g.z, mu.z, nu.z, lr, bc1, bc2);
  adam(p.w, g.w, mu.w, nu.w, lr, bc1, bc2);
}

__device__ __forceinline__ float4 load_g(const float* g, int vec) {
  if (vec) return *reinterpret_cast<const float4*>(g);
  return make_float4(g[0], g[1], g[2], g[3]);
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Table t) {
  const float lr = t.scalars[0], bc1 = t.scalars[1], bc2 = t.scalars[2];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int l = 0; l < t.count; ++l) {
    const Leaf& f = t.leaf[l];
    float4* p4 = reinterpret_cast<float4*>(f.p + f.head);
    float4* mu4 = reinterpret_cast<float4*>(f.mu + f.head);
    float4* nu4 = reinterpret_cast<float4*>(f.nu + f.head);
    const float* g = f.g + f.head;
    // the body, two units a thread in flight: every load, then the arithmetic
    for (long long i = tid; i < f.units; i += 2 * stride) {
      const long long j = i + stride;
      const bool two = j < f.units;
      float4 pa = p4[i], ma = mu4[i], na = nu4[i];
      const float4 ga = load_g(g + 4 * i, f.g_vec);
      float4 pb, mb, nb, gb;
      if (two) {
        pb = p4[j], mb = mu4[j], nb = nu4[j];
        gb = load_g(g + 4 * j, f.g_vec);
      }
      adam4(pa, ga, ma, na, lr, bc1, bc2);
      p4[i] = pa, mu4[i] = ma, nu4[i] = na;
      if (two) {
        adam4(pb, gb, mb, nb, lr, bc1, bc2);
        p4[j] = pb, mu4[j] = mb, nu4[j] = nb;
      }
    }
    // the single elements: the head, then what follows the body
    const long long singles = f.n - 4 * f.units;
    for (long long s = tid; s < singles; s += stride) {
      const long long k = s < f.head ? s : s + 4 * f.units;
      float p = f.p[k], mu = f.mu[k], nu = f.nu[k];
      adam(p, f.g[k], mu, nu, lr, bc1, bc2);
      f.p[k] = p, f.mu[k] = mu, f.nu[k] = nu;
    }
  }
}

// blocks of the kernel one SM holds at once (asked once): the grid is one
// wave, so no block starts its share after the others have finished theirs
int resident_blocks() {
  static int per_sm = 0;
  if (per_sm == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel, kThreads, 0) != cudaSuccess)
    per_sm = 1;
  return per_sm;
}

}  // namespace

extern "C" {

// One Adam step over `count` leaves (1 to kMaxLeaves): p, g, mu and nu hold
// `count` f32 pointers each, n each leaf's elements; scalars (3,) f32 on the
// card. The grid is one wave, as many blocks as the card's `sms` hold at
// once, fewer where the largest leaf's units would not fill them. Launches
// on the stream; returns the launch's cudaError_t.
int adam_step(void* const* p, const void* const* g, void* const* mu, void* const* nu, const long long* n,
              int count, const void* scalars, int sms, void* stream) {
  if (count < 1 || count > kMaxLeaves || sms < 1) return cudaErrorInvalidValue;
  Table t;
  long long most = 0;
  for (int l = 0; l < count; ++l) {
    Leaf& f = t.leaf[l];
    f.p = static_cast<float*>(p[l]);
    f.g = static_cast<const float*>(g[l]);
    f.mu = static_cast<float*>(mu[l]);
    f.nu = static_cast<float*>(nu[l]);
    f.n = n[l];
    const unsigned long long at = reinterpret_cast<unsigned long long>(f.p) & 15;
    if (at == (reinterpret_cast<unsigned long long>(f.mu) & 15) &&
        at == (reinterpret_cast<unsigned long long>(f.nu) & 15)) {
      f.head = ((16 - at) & 15) / 4;
      if (f.head > f.n) f.head = f.n;
      f.units = (f.n - f.head) / 4;
      f.g_vec = (reinterpret_cast<unsigned long long>(f.g) & 15) == at;
    } else {
      f.head = f.n;
      f.units = 0;
      f.g_vec = 0;
    }
    const long long work = f.units > 0 ? f.units : f.n;
    if (work > most) most = work;
  }
  t.scalars = static_cast<const float*>(scalars);
  t.count = count;
  const long long wanted = (most + 2LL * kThreads - 1) / (2LL * kThreads);
  const long long full = (long long)resident_blocks() * sms;
  const int blocks = (int)(wanted < 1 ? 1 : (wanted < full ? wanted : full));
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

}  // extern "C"
