// Adam over every leaf of a model, with the train step's NaN guard and the
// gradients' global norm, in two launches a step — hand-written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its optimizer to optax
// and XLA (ddsp_pytorch_tpu/training/train.py make_optimizer).  The port's
// plain path (training/optim.py Optimizer.update and the guard's copies)
// runs ~23 PyTorch operations a leaf, ~1 100 graph nodes over the
// decoder's 47 leaves.  Here (ops/adam.py):
//
//   adam_norm_kernel     Σ g² of one (leaf, chunk) a block, in float64, into
//                        that block's partial (only where the step reports
//                        the norm or clips)
//   adam_update_kernel   one (leaf, chunk) a block: reads the loss (the
//                        guard: a non-finite loss writes nothing), Adam's
//                        count and the schedule's, the partials where it
//                        clips, and writes p, mu and nu in place; the last
//                        block to finish (a done counter) writes the norm,
//                        the counts + 1 and resets the counter, so no block
//                        still reads a count that is being written.
//
// The leaves pass by value (the multi-tensor-apply layout): a table of
// pointers, element counts and each leaf's first block, at most kMaxLeaves
// leaves a launch so that the table and the other arguments fit the 4 KB
// of a kernel's parameters; ops/adam.py `plan` splits more leaves over
// several launches, and only the last update launch finishes the step.
// Nothing is copied to the device: a captured graph replays the pointers it
// was launched with.  A block finds its leaf by a binary search over the
// first blocks (ops/adam.py `block_leaf` is the same search in Python).
//
// Arithmetic: optax's float32 operations in training/optim.py's order, each
// rounded once (no FMA contraction: __fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn), the bias corrections 1 − powf(β, n), as PyTorch's float32
// kernels compute them on the card.  The norm is a float64 sum in an order
// fixed by the shapes alone, so it is the same in every block and run.
//
// What bounds it on an H100: bytes.  p, g, mu and nu read and p, mu and nu
// written, 28 bytes a parameter, and 4 more for the norm's read of g: 32
// bytes, 0.046 ms for the decoder's 4.33 M parameters at the card's
// measured 2 983 GB/s.  A block of 256 threads walks its chunk in float4s
// where all four pointers are 16-byte aligned, element by element where
// not.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v  (see ops/kernels/__init__.py)

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLeaves = 80;  // ops/adam.py MAX_LEAVES
constexpr int kThreads = 256;
constexpr int kIntMax = 2147483647;
constexpr float kEps = 1e-8f;

// ops/adam.py pack(): MAX_LEAVES int64s each of p, g, mu, nu and the
// element counts, then MAX_LEAVES + 4 int32s: the first blocks (and the
// launch's blocks after the last leaf), the leaves, the first partial
struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_block[kMaxLeaves + 1];
  int leaves;
  int partial0;
  int pad;
};
static_assert(sizeof(Leaves) == 3536, "the table's layout is ops/adam.py's TABLE_BYTES");

// the last leaf whose first block is at most `block`
__device__ __forceinline__ int leaf_of(const Leaves& t, int block) {
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= block) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// the sum over the block of each thread's `x`, in a fixed order; every
// thread gets it
__device__ __forceinline__ double block_sum(double x, double* sh) {
  __syncthreads();  // sh may still be read by an earlier call
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// the gradients' global norm from every launch's partials
__device__ __forceinline__ float norm_of(const double* __restrict__ partials, int n, double* sh) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  return static_cast<float>(sqrt(block_sum(acc, sh)));
}

__global__ void __launch_bounds__(kThreads)
adam_norm_kernel(const Leaves t, double* __restrict__ partials, int chunk) {
  __shared__ double sh[kThreads];
  const int leaf = leaf_of(t, blockIdx.x);
  const long long start = static_cast<long long>(blockIdx.x - t.first_block[leaf]) * chunk;
  const long long end = min(start + chunk, t.n[leaf]);
  const float* __restrict__ g = t.g[leaf];
  double acc = 0.0;
  long long i = start;
  if (aligned16(g)) {
    for (i = start + 4 * threadIdx.x; i + 3 < end; i += 4 * kThreads) {
      const float4 x = *reinterpret_cast<const float4*>(g + i);
      acc += static_cast<double>(x.x) * x.x + static_cast<double>(x.y) * x.y +
             static_cast<double>(x.z) * x.z + static_cast<double>(x.w) * x.w;
    }
    i = start + ((end - start) & ~3LL) + threadIdx.x;  // the chunk's ragged tail
  } else {
    i = start + threadIdx.x;
  }
  for (; i < end; i += kThreads) acc += static_cast<double>(g[i]) * g[i];
  const double total = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[t.partial0 + blockIdx.x] = total;
}

// b1, b2 and their complements arrive as float32 arguments (ops/adam.py
// `betas`: each complement computed in float64 and rounded once, as
// PyTorch rounds the Python floats of training/optim.py)
struct Step {
  float b1, b2, one_minus_b1, one_minus_b2, c1, c2, step, norm, clip;
  bool clipped;
};

// one element: optim.py's clip, moments, bias corrections and step, in order
__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v, const Step& s) {
  if (s.clipped) g = __fmul_rn(__fdiv_rn(g, s.norm), s.clip);
  m = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  const float u = __fdiv_rn(__fdiv_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), kEps));
  p = __fadd_rn(p, __fmul_rn(s.step, u));
}

// lr: the constant rate, or (init − end) of a linear schedule over `steps`
// counts (steps > 0, inv_steps = 1/steps in float32, as PyTorch divides a
// tensor by a Python number); loss, schedule_count, norm_out: null where
// there is none; clips: clip by the global norm at `clip`; finalize: this
// is the step's last update launch
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const Leaves t, const double* __restrict__ partials, int n_partials,
                   float* __restrict__ norm_out, unsigned int* __restrict__ done,
                   const float* __restrict__ loss, int* __restrict__ count,
                   int* __restrict__ schedule_count, float lr, float lr_end, float inv_steps,
                   int steps, int clips, float clip, float b1, float b2, float one_minus_b1,
                   float one_minus_b2, int chunk, int finalize) {
  __shared__ double sh[kThreads];
  __shared__ bool last;
  const bool apply = loss == nullptr || isfinite(*loss);
  const int c = *count;
  const int n = c < kIntMax ? c + 1 : c;
  const int sc = schedule_count == nullptr ? 0 : *schedule_count;
  if (apply) {
    Step s;
    const float nf = static_cast<float>(n);
    s.b1 = b1;
    s.b2 = b2;
    s.one_minus_b1 = one_minus_b1;
    s.one_minus_b2 = one_minus_b2;
    s.c1 = __fsub_rn(1.0f, powf(b1, nf));
    s.c2 = __fsub_rn(1.0f, powf(b2, nf));
    if (steps > 0) {
      const float frac = __fsub_rn(1.0f, __fmul_rn(static_cast<float>(min(max(sc, 0), steps)), inv_steps));
      s.step = -__fadd_rn(__fmul_rn(lr, frac), lr_end);
    } else {
      s.step = -lr;
    }
    s.clip = clip;
    s.norm = clips ? norm_of(partials, n_partials, sh) : 0.f;
    s.clipped = clips && !(s.norm < clip);

    const int leaf = leaf_of(t, blockIdx.x);
    const long long start = static_cast<long long>(blockIdx.x - t.first_block[leaf]) * chunk;
    const long long end = min(start + chunk, t.n[leaf]);
    float* __restrict__ P = t.p[leaf];
    const float* __restrict__ G = t.g[leaf];
    float* __restrict__ M = t.m[leaf];
    float* __restrict__ V = t.v[leaf];
    long long i;
    if (aligned16(P) && aligned16(G) && aligned16(M) && aligned16(V)) {
      for (i = start + 4 * threadIdx.x; i + 3 < end; i += 4 * kThreads) {
        float4 p = *reinterpret_cast<float4*>(P + i);
        const float4 g = *reinterpret_cast<const float4*>(G + i);
        float4 m = *reinterpret_cast<float4*>(M + i);
        float4 v = *reinterpret_cast<float4*>(V + i);
        adam_element(p.x, g.x, m.x, v.x, s);
        adam_element(p.y, g.y, m.y, v.y, s);
        adam_element(p.z, g.z, m.z, v.z, s);
        adam_element(p.w, g.w, m.w, v.w, s);
        *reinterpret_cast<float4*>(P + i) = p;
        *reinterpret_cast<float4*>(M + i) = m;
        *reinterpret_cast<float4*>(V + i) = v;
      }
      i = start + ((end - start) & ~3LL) + threadIdx.x;
    } else {
      i = start + threadIdx.x;
    }
    for (; i < end; i += kThreads) adam_element(P[i], G[i], M[i], V[i], s);
  }
  if (!finalize) return;
  // last block done: every block has read the counts before it counts
  // itself done, so the last one may write them
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  if (norm_out != nullptr) {
    const float norm = norm_of(partials, n_partials, sh);
    if (threadIdx.x == 0) *norm_out = norm;
  }
  if (threadIdx.x == 0) {
    if (apply) {
      *count = n;
      if (schedule_count != nullptr) *schedule_count = sc < kIntMax ? sc + 1 : sc;
    }
    *done = 0u;
  }
}

Leaves read_table(const void* table) {
  Leaves t;
  memcpy(&t, table, sizeof(Leaves));
  return t;
}

}  // namespace

// table: a host buffer of ops/adam.py's layout, read before the launch
// returns (its values travel as the kernel's parameters)
extern "C" int ddsp_adam_norm(const void* table, double* partials, int blocks, int chunk,
                              void* stream) {
  adam_norm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(read_table(table),
                                                                               partials, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddsp_adam_update(const void* table, const double* partials, int n_partials,
                                float* norm_out, unsigned int* done, const float* loss, int* count,
                                int* schedule_count, float lr, float lr_end, float inv_steps,
                                int steps, int clips, float clip, float b1, float b2,
                                float one_minus_b1, float one_minus_b2, int blocks, int chunk,
                                int finalize, void* stream) {
  adam_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      read_table(table), partials, n_partials, norm_out, done, loss, count, schedule_count, lr,
      lr_end, inv_steps, steps, clips, clip, b1, b2, one_minus_b1, one_minus_b2, chunk, finalize);
  return static_cast<int>(cudaGetLastError());
}
