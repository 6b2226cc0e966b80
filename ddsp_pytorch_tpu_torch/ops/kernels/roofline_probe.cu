// Roofline probes — the card's FP32 FMA and accurate-sinf ceilings, hand-
// written for Hopper (sm_90a).
//
// Replaces: scripts/bench_roofline.py::measure_vpu_rates_pallas, its two
// Pallas TPU kernels `fma_kernel` and `sin_kernel` (both called through the
// one pl.pallas_call there).  They measure what the oscillator kernels'
// instruction mix can reach at best; add_vpu_model turns the two rates into
// an instruction-mix bound of those kernels.
//
// Computes, element for element, what each Pallas body computes on its f32
// input x (each input read once, each output written once):
//   fma:  s = x; c = 1 + s*1e-9; p = 0.9*s; acc = 0.5*s
//         256 times: (s, p) = (c*s - p, s); acc = acc + c*p
//         out = acc
//   sin:  y_j = sin(x + 0.1*(j+1)) for j = 0..7, then y_j = sin(y_j) three
//         more times; out = y_0, then out = 0.5*out + 0.0625*y_j, j = 1..7
// A TPU grid of 256 tiles of 32×512 becomes one thread an element here (the
// 4 194 304 elements fill every SM many times over), in blocks of a size the
// caller picks (bench_roofline.py sweeps it and keeps the fastest); the
// chains' value dependence is what keeps the compiler from folding the work.
//
// What bounds it on an H100: the fma probe does 2*256 + 3 FMAs an element
// against 8 bytes moved (~130 flop/byte, far above the card's FP32 ridge
// of ~20): operations.  The sin probe does 32 sinf and 22 other FP32
// instructions an element; each accurate sinf is ~17 FP32 instructions on
// its fast path (573 an element in the sm_90a SASS, counted by
// bench_roofline.sin_probe_sass), so it too is bound by operations.  Each
// thread's two FMA chains are dependent, so the rate comes from the warps
// in flight (up to 64 an SM hide the FMA's few cycles of latency), not
// from ILP within a thread.
//
// The fma chain uses explicit fmaf (one rounding), which equals the plain
// version's multiply-then-subtract bit for bit where c rounds to 1 (every
// |x| below ~60); c itself is formed with round-to-nearest multiply and add
// as the Pallas body forms it.  sinf is the accurate libdevice routine that
// the oscillator kernels' sincosf shares its range reduction with: build
// WITHOUT --use_fast_math (which would give __sinf), so that the measured
// rate bounds those kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v  (see ops/kernels/__init__.py)

#include <cuda_runtime.h>

namespace {

constexpr int kFmaDepth = 256;  // bench_roofline.py FMA_DEPTH
constexpr int kChains = 8;      // bench_roofline.py ILP
constexpr int kSinDepth = 4;    // bench_roofline.py SIN_DEPTH

// The lanes past n run the chain on a dummy and store nothing, rather than
// return early: with the early return ptxas assigned the chain other
// registers and the probe ran slower on an H100 at every block size (511
// FFMAs either way; PERF.md §6), a sign of register-bank conflicts in the
// three-operand chain.  A ceiling probe keeps its fastest form.
__global__ void roofline_fma_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float s = i < n ? x[i] : 0.5f;
  const float c = __fadd_rn(1.0f, __fmul_rn(s, 1e-9f));
  float p = __fmul_rn(s, 0.9f);
  float acc = __fmul_rn(s, 0.5f);
#pragma unroll
  for (int d = 0; d < kFmaDepth; ++d) {
    const float next = fmaf(c, s, -p);
    p = s;
    s = next;
    acc = fmaf(c, p, acc);
  }
  if (i < n) out[i] = acc;
}

__global__ void roofline_sin_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float y = x[i];
  float ys[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    // the Pallas body adds the Python float 0.1*(j+1), rounded to f32
    ys[j] = sinf(__fadd_rn(y, static_cast<float>(0.1 * (j + 1))));
  }
#pragma unroll
  for (int d = 0; d < kSinDepth - 1; ++d) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) ys[j] = sinf(ys[j]);
  }
  float o = ys[0];
#pragma unroll
  for (int j = 1; j < kChains; ++j) {
    o = __fadd_rn(__fmul_rn(o, 0.5f), __fmul_rn(ys[j], 0.0625f));
  }
  out[i] = o;
}

}  // namespace

// kind 0: the fma probe, kind 1: the sin probe, in blocks of `threads`.
// Launches on `stream` (PyTorch's current stream); returns
// cudaGetLastError() so the caller can raise on a refused launch (or
// cudaErrorInvalidValue for an unknown kind).  Shapes and the block size are
// checked by the Python wrapper (ops/roofline.py).
extern "C" int ddsp_roofline_probe(const float* x, float* out, int n, int kind,
                                   int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + threads - 1) / threads);
  if (kind == 0) {
    roofline_fma_kernel<<<grid, threads, 0, s>>>(x, out, n);
  } else if (kind == 1) {
    roofline_sin_kernel<<<grid, threads, 0, s>>>(x, out, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
