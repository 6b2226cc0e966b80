// Harmonic oscillator bank, backward — hand-written for Hopper (sm_90a).
//
// Replaces: ddsp_pytorch_tpu/ops/pallas_kernels/oscillator.py::_bwd_kernel
// (the Pallas TPU kernel, called through pl.pallas_call in _osc_rows_bwd).
//
// Computes, for each independent row r, given the audio cotangent g (R, S):
//   theta_i  = phi_r + (i + 1) * omega_r                  i = 0 .. S-1
//   dA_rk    = sum_i g_ri * sin(k * theta_i)              k = 1 .. K
//   dtheta_i = g_ri * sum_k k * A_rk * cos(k * theta_i)
//   dphi_r   = sum_i dtheta_i
//   domega_r = sum_i (i + 1) * dtheta_i
// The sines and cosines are recomputed, not stored: the sin recurrence of
// the forward and its cos twin
//   cos(k*theta) = 2 cos(theta) * cos((k-1)*theta) - cos((k-2)*theta)
// run in registers, one sincosf per sample.
//
// What bounds it on an H100: per row it reads 4*(S+K+2) bytes and writes
// 4*(K+2) bytes, and does about 8*S*K flops (two recurrences, the dA
// product and the dtheta FMA), i.e. ~2K flops per byte: at K = 64 the FP32
// pipe bounds it (8*R*S*K over 67 TFLOP/s).  This design spends more on the
// K per-sample reductions than on the arithmetic: every dA_rk is a sum over
// the S samples, done as a 5-step warp shuffle per k per sample.
//
// Design (simple and right first): one CTA per row, threads stride over the
// S samples.  The row's K amplitudes, pre-multiplied by k, sit in shared
// memory.  For each k every warp reduces g*sin(k*theta) by shuffles and its
// lane 0 adds the warp's partial to partial_s[warp][k] (each warp owns its
// own slice, so there is no race and no atomic); after the sample loop the
// warps' partials are summed in warp order.  dtheta is accumulated per
// sample in a register, folded into per-thread dphi/domega sums, and those
// are reduced the same way at the end.  theta is formed with explicit
// round-to-nearest multiply and add exactly as in oscillator_fwd.cu, so it
// is bitwise the plain version's; sincosf is the accurate libdevice routine
// (build WITHOUT --use_fast_math).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC  (see ops/kernels/__init__.py)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFullMask, v, off);
  }
  return v;  // the sum is in lane 0
}

__global__ void oscillator_bwd_kernel(const float* __restrict__ phi,
                                      const float* __restrict__ omega,
                                      const float* __restrict__ amp,
                                      const float* __restrict__ grad,
                                      float* __restrict__ dphi,
                                      float* __restrict__ domega,
                                      float* __restrict__ damp,
                                      int n_harmonic, int block_size) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x / 32;
  float* kamp_s = smem;                       // [K]: k * A_k
  float* partial_s = smem + n_harmonic;       // [n_warps][K]
  float* red_s = partial_s + n_warps * n_harmonic;  // [2][n_warps]

  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* amp_row = amp + static_cast<size_t>(row) * n_harmonic;
  for (int k = threadIdx.x; k < n_harmonic; k += blockDim.x) {
    kamp_s[k] = static_cast<float>(k + 1) * amp_row[k];
  }
  for (int j = threadIdx.x; j < n_warps * n_harmonic; j += blockDim.x) {
    partial_s[j] = 0.0f;
  }
  __syncthreads();

  const float p = phi[row];
  const float w = omega[row];
  const float* g_row = grad + static_cast<size_t>(row) * block_size;
  float* my_partial = partial_s + warp * n_harmonic;
  float dphi_acc = 0.0f;
  float domega_acc = 0.0f;
  // every thread runs the same number of iterations so that the full-mask
  // shuffles see all 32 lanes; samples past the end contribute g = 0
  for (int base = 0; base < block_size; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const bool valid = i < block_size;
    const float g = valid ? g_row[i] : 0.0f;
    const float ramp = static_cast<float>(i + 1);
    const float theta = __fadd_rn(p, __fmul_rn(w, ramp));
    float s, c;
    sincosf(theta, &s, &c);
    const float two_c = 2.0f * c;
    float s_prev = 0.0f, s_cur = s;  // sin(0*theta), sin(1*theta)
    float c_prev = 1.0f, c_cur = c;  // cos(0*theta), cos(1*theta)
    float fac = 0.0f;                // sum_k k * A_k * cos(k*theta)
    for (int k = 0; k < n_harmonic; ++k) {
      const float part = warp_sum(g * s_cur);
      if (lane == 0) my_partial[k] += part;
      fac = fmaf(kamp_s[k], c_cur, fac);
      const float s_next = fmaf(two_c, s_cur, -s_prev);
      const float c_next = fmaf(two_c, c_cur, -c_prev);
      s_prev = s_cur;
      s_cur = s_next;
      c_prev = c_cur;
      c_cur = c_next;
    }
    const float dtheta = g * fac;
    dphi_acc += dtheta;
    domega_acc = fmaf(ramp, dtheta, domega_acc);
  }

  dphi_acc = warp_sum(dphi_acc);
  domega_acc = warp_sum(domega_acc);
  if (lane == 0) {
    red_s[warp] = dphi_acc;
    red_s[n_warps + warp] = domega_acc;
  }
  __syncthreads();

  float* damp_row = damp + static_cast<size_t>(row) * n_harmonic;
  for (int k = threadIdx.x; k < n_harmonic; k += blockDim.x) {
    float acc = 0.0f;
    for (int v = 0; v < n_warps; ++v) acc += partial_s[v * n_harmonic + k];
    damp_row[k] = acc;
  }
  if (threadIdx.x == 0) {
    float a = 0.0f, b = 0.0f;
    for (int v = 0; v < n_warps; ++v) {
      a += red_s[v];
      b += red_s[n_warps + v];
    }
    dphi[row] = a;
    domega[row] = b;
  }
}

}  // namespace

// Threads per CTA for a row of `block_size` samples: a multiple of 32 (the
// shuffles assume whole warps), at most 512.
static int bwd_threads(int block_size) {
  int threads = ((block_size + 31) / 32) * 32;
  return threads > 512 ? 512 : threads;
}

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the caller can raise on a refused launch.  Shapes are checked by the
// Python wrapper (ops/oscillator.py::oscillator_bank_bwd).
extern "C" int ddsp_oscillator_bwd(const float* phi, const float* omega,
                                   const float* amp, const float* grad,
                                   float* dphi, float* domega, float* damp,
                                   int rows, int n_harmonic, int block_size,
                                   void* stream) {
  const int threads = bwd_threads(block_size);
  const int warps = threads / 32;
  // k*A (K), the per-warp dA partials (warps*K), the dphi/domega partials
  // (2*warps); ops/oscillator.py bounds K so that this stays under 48 KB
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_harmonic) * (1 + warps) + 2 * warps);
  oscillator_bwd_kernel<<<rows, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      phi, omega, amp, grad, dphi, domega, damp, n_harmonic, block_size);
  return static_cast<int>(cudaGetLastError());
}
