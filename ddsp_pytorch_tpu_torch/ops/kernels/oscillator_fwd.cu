// Harmonic oscillator bank, forward — hand-written for Hopper (sm_90a).
//
// Replaces: ddsp_pytorch_tpu/ops/pallas_kernels/oscillator.py::_fwd_kernel
// (the Pallas TPU kernel, called through pl.pallas_call in _osc_rows_fwd).
//
// Computes, for each independent row r (one frame of one batch item):
//   theta_i = phi_r + (i + 1) * omega_r                 i = 0 .. S-1
//   out_ri  = sum_{k=1..K} amp_rk * sin(k * theta_i)
// with sin(k*theta) from the Chebyshev recurrence
//   sin(k*theta) = 2 cos(theta) * sin((k-1)*theta) - sin((k-2)*theta),
// so each sample costs one sincosf and 2K FMAs; the (R, S, K) sine tensor
// never exists.
//
// What bounds it on an H100: per row it reads 4*(K+2) bytes and writes
// 4*S bytes, and does 4*S*K flops (two FMAs per harmonic per sample) plus
// one sincosf per sample, i.e. about K flops per byte written.  At K = 64
// and S = 512 that is 57 flop/byte, above the card's FP32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flop/byte), so a large launch is bound by FP32 FMA
// throughput; the serving path launches one row per block, where launch
// latency is the whole cost.
//
// Design: one CTA per row (no padding of R to a tile), threads stride over
// the S samples so every store is coalesced.  The row's K amplitudes are
// staged once in shared memory (read by every thread, K times each);
// phi, omega and the three-term recurrence stay in registers.  f32
// throughout.  The fundamental phase is formed with explicit round-to-
// nearest multiply and add (no FMA contraction) so that theta is bitwise
// the value the plain PyTorch version computes; theta reaches ~140 rad at
// f0 = 2 kHz, where one rounding step of theta is amplified k-fold by the
// recurrence.  sincosf is the accurate libdevice routine: build WITHOUT
// --use_fast_math, which would turn it into __sinf/__cosf, whose absolute
// error grows with |theta|.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (see ops/kernels/__init__.py)

#include <cuda_runtime.h>

namespace {

__global__ void oscillator_fwd_kernel(const float* __restrict__ phi,
                                      const float* __restrict__ omega,
                                      const float* __restrict__ amp,
                                      float* __restrict__ out,
                                      int n_harmonic, int block_size) {
  extern __shared__ float amp_s[];
  const int row = blockIdx.x;
  const float* amp_row = amp + static_cast<size_t>(row) * n_harmonic;
  for (int k = threadIdx.x; k < n_harmonic; k += blockDim.x) {
    amp_s[k] = amp_row[k];
  }
  __syncthreads();

  const float p = phi[row];
  const float w = omega[row];
  float* out_row = out + static_cast<size_t>(row) * block_size;
  for (int i = threadIdx.x; i < block_size; i += blockDim.x) {
    const float theta = __fadd_rn(p, __fmul_rn(w, static_cast<float>(i + 1)));
    float s, c;
    sincosf(theta, &s, &c);
    const float two_c = 2.0f * c;
    float s_prev = 0.0f;  // sin(0 * theta)
    float s_cur = s;      // sin(1 * theta)
    float acc = 0.0f;
    for (int k = 0; k < n_harmonic; ++k) {
      acc = fmaf(amp_s[k], s_cur, acc);
      const float s_next = fmaf(two_c, s_cur, -s_prev);
      s_prev = s_cur;
      s_cur = s_next;
    }
    out_row[i] = acc;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the caller can raise on a refused launch.  Shapes are checked by the
// Python wrapper (ops/oscillator.py::oscillator_bank).
extern "C" int ddsp_oscillator_fwd(const float* phi, const float* omega,
                                   const float* amp, float* out, int rows,
                                   int n_harmonic, int block_size,
                                   void* stream) {
  int threads = ((block_size + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  const size_t smem = static_cast<size_t>(n_harmonic) * sizeof(float);
  oscillator_fwd_kernel<<<rows, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      phi, omega, amp, out, n_harmonic, block_size);
  return static_cast<int>(cudaGetLastError());
}
