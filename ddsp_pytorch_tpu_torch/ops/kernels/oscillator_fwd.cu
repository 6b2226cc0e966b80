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
// Design.  The first port ran one sample per thread and read one amplitude
// from shared memory per two FMAs, so at many rows the load pipe set its
// pace.  This source holds two kernels, and the launcher picks by R:
//   * many rows (training, R = 16*375 = 6000; from kManyRows on):
//     `oscillator_fwd_rows_kernel`.  A CTA of 4 warps takes 4 rows, a warp
//     a row; each thread runs 4 samples interleaved (i, i+32, i+64, i+96,
//     so the stores stay coalesced), and the amplitudes are read from
//     shared memory as 16-byte float4 broadcasts: one load feeds 4
//     harmonics of 4 samples, 32 FMAs, and the 4 recurrences are
//     independent chains for the scheduler to overlap;
//   * few rows (serving, R = 1): `oscillator_fwd_row_kernel`, one CTA a
//     row with a thread a sample (up to 512), the compact loop of the first
//     port.  The block's latency is what a served block waits for; the
//     many-row kernel's wider per-thread work measured slower here;
//   * K is a template parameter of both: K = 64 is the main path (every
//     committed config), whose harmonic loop unrolls fully; any other K
//     runs the SAME kernels with K a runtime value (the many-row kernel's
//     amplitudes zero-padded to a multiple of 4).
// f32 throughout.  The fundamental phase is formed with explicit round-to-
// nearest multiply and add (no FMA contraction) so that theta is bitwise
// the value the plain PyTorch version computes; theta reaches ~140 rad at
// f0 = 2 kHz, where one rounding step of theta is amplified k-fold by the
// recurrence.  sincosf is the accurate libdevice routine: build WITHOUT
// --use_fast_math, which would turn it into __sinf/__cosf, whose absolute
// error grows with |theta|.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v  (see ops/kernels/__init__.py)

#include <cuda_runtime.h>

namespace {

constexpr int kFixedK = 64;    // the main path's harmonics
constexpr int kManyRows = 528;  // the many-row kernel from here on (a CTA an SM)
constexpr int kRowsPerCta = 4;  // many rows: a warp a row
constexpr int kSamples = 4;     // many rows: samples a thread, interleaved
constexpr int kMaxThreads = 512;  // few rows: a thread a sample

__device__ __forceinline__ void harmonic(float a, float (&s)[kSamples], float (&sp)[kSamples],
                                         const float (&two_c)[kSamples],
                                         float (&acc)[kSamples]) {
#pragma unroll
  for (int n = 0; n < kSamples; ++n) {
    acc[n] = fmaf(a, s[n], acc[n]);
    const float next = fmaf(two_c[n], s[n], -sp[n]);
    sp[n] = s[n];
    s[n] = next;
  }
}

// Many rows.  KC > 0: K == KC, known at compile time; KC == 0: K at run time.
template <int KC>
__global__ void oscillator_fwd_rows_kernel(const float* __restrict__ phi,
                                           const float* __restrict__ omega,
                                           const float* __restrict__ amp,
                                           float* __restrict__ out, int rows,
                                           int n_harmonic, int block_size) {
  extern __shared__ float4 smem4[];
  const int slot = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerCta + slot;
  const bool live = row < rows;
  const int r = live ? row : rows - 1;  // a CTA's last slots may be empty
  const int k_pad = KC > 0 ? KC : (n_harmonic + 3) / 4 * 4;
  float* amp_s = reinterpret_cast<float*>(smem4) + slot * k_pad;
  const float* amp_row = amp + static_cast<size_t>(r) * n_harmonic;
  for (int k = lane; k < k_pad; k += 32) amp_s[k] = k < n_harmonic ? amp_row[k] : 0.0f;
  __syncthreads();
  if (!live) return;

  const float p = phi[r];
  const float w = omega[r];
  float* out_row = out + static_cast<size_t>(r) * block_size;
  for (int base = lane; base < block_size; base += 32 * kSamples) {
    float s[kSamples], sp[kSamples], two_c[kSamples], acc[kSamples];
#pragma unroll
    for (int n = 0; n < kSamples; ++n) {
      const float ramp = static_cast<float>(base + 32 * n + 1);
      float sv, cv;
      sincosf(__fadd_rn(p, __fmul_rn(w, ramp)), &sv, &cv);
      s[n] = sv;     // sin(1 * theta)
      sp[n] = 0.0f;  // sin(0 * theta)
      two_c[n] = 2.0f * cv;
      acc[n] = 0.0f;
    }
    if constexpr (KC > 0) {
#pragma unroll
      for (int k = 0; k < KC; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(amp_s + k);
        harmonic(a.x, s, sp, two_c, acc);
        harmonic(a.y, s, sp, two_c, acc);
        harmonic(a.z, s, sp, two_c, acc);
        harmonic(a.w, s, sp, two_c, acc);
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < k_pad; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(amp_s + k);
        harmonic(a.x, s, sp, two_c, acc);
        harmonic(a.y, s, sp, two_c, acc);
        harmonic(a.z, s, sp, two_c, acc);
        harmonic(a.w, s, sp, two_c, acc);
      }
    }
#pragma unroll
    for (int n = 0; n < kSamples; ++n) {
      const int i = base + 32 * n;
      if (i < block_size) out_row[i] = acc[n];
    }
  }
}

// Few rows: one CTA a row, a thread a sample.
template <int KC>
__global__ void oscillator_fwd_row_kernel(const float* __restrict__ phi,
                                          const float* __restrict__ omega,
                                          const float* __restrict__ amp,
                                          float* __restrict__ out, int n_harmonic,
                                          int block_size) {
  extern __shared__ float4 smem4[];
  float* amp_s = reinterpret_cast<float*>(smem4);
  const int row = blockIdx.x;
  const int n_k = KC > 0 ? KC : n_harmonic;
  const float* amp_row = amp + static_cast<size_t>(row) * n_k;
  for (int k = threadIdx.x; k < n_k; k += blockDim.x) amp_s[k] = amp_row[k];
  __syncthreads();

  const float p = phi[row];
  const float w = omega[row];
  float* out_row = out + static_cast<size_t>(row) * block_size;
  for (int i = threadIdx.x; i < block_size; i += blockDim.x) {
    float s, c;
    sincosf(__fadd_rn(p, __fmul_rn(w, static_cast<float>(i + 1))), &s, &c);
    const float two_c = 2.0f * c;
    float s_prev = 0.0f;  // sin(0 * theta)
    float acc = 0.0f;
    for (int k = 0; k < n_k; ++k) {
      acc = fmaf(amp_s[k], s, acc);
      const float next = fmaf(two_c, s, -s_prev);
      s_prev = s;
      s = next;
    }
    out_row[i] = acc;
  }
}

template <int KC>
void launch(const float* phi, const float* omega, const float* amp, float* out,
            int rows, int n_harmonic, int block_size, cudaStream_t stream) {
  if (rows >= kManyRows) {
    const int k_pad = KC > 0 ? KC : (n_harmonic + 3) / 4 * 4;
    const dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta);
    const size_t smem = sizeof(float) * kRowsPerCta * k_pad;
    oscillator_fwd_rows_kernel<KC><<<grid, 32 * kRowsPerCta, smem, stream>>>(
        phi, omega, amp, out, rows, n_harmonic, block_size);
  } else {
    int threads = (block_size + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const size_t smem = sizeof(float) * n_harmonic;
    oscillator_fwd_row_kernel<KC><<<rows, threads, smem, stream>>>(
        phi, omega, amp, out, n_harmonic, block_size);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the caller can raise on a refused launch.  Shapes are checked by the
// Python wrapper (ops/oscillator.py::oscillator_bank), which bounds K so
// that the shared memory stays under 48 KB.
extern "C" int ddsp_oscillator_fwd(const float* phi, const float* omega,
                                   const float* amp, float* out, int rows,
                                   int n_harmonic, int block_size,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_harmonic == kFixedK) {
    launch<kFixedK>(phi, omega, amp, out, rows, n_harmonic, block_size, s);
  } else {
    launch<0>(phi, omega, amp, out, rows, n_harmonic, block_size, s);
  }
  return static_cast<int>(cudaGetLastError());
}
