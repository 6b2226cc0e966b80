// The multiscale spectral loss's passes around cuFFT — hand-written for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves its STFTs and the loss
// to XLA (ddsp_pytorch_tpu/ops/spectral.py stft, training/loss.py).  The
// port's plain path (ops/spectral.py stft, training/loss.py) made ~50
// PyTorch launches a scale forward and back: the reflect pad, the unfold,
// the window rebuilt and applied, the spectrum scaled and transposed, the
// magnitudes, logs and means, and autograd's replay of each of them.  Per
// scale n (hop h, pad n/2, F frames) the train step now runs, over both
// signals at once (ops/stft_loss.py MultiscaleSpectralLoss):
//
//   stft_frame_kernel       target and reconstruction as 2B rows: every
//                           frame read through the centred reflect pad by
//                           index arithmetic, times c[k] = Hann[k]·n^-1/2
//                           (one cached constant a scale), written once as
//                           (2B, F, n) float32
//   (cuFFT R2C, torch.fft.rfft)
//   stft_loss_grad_kernel   both spectra read once: |S_x|, |S_y|, the terms
//                           |S_x − S_y| and |log(S_x + ε) − log(S_y + ε)|
//                           summed into per-block partials (float64), and
//                           in the same pass the gradient of the loss with
//                           respect to the reconstruction's spectrum for an
//                           upstream gradient of 1,
//                             g = (sgn(S_y − S_x) + sgn(log S_y − log S_x)
//                                  / (S_y + ε)) / M · Y/|Y|
//                           (M = B·bins·F; sgn(0) = 0 and Y/|Y| = 0 at
//                           |Y| = 0, as torch's abs backward has them),
//                           weighted for an unnormalised C2R as rfft's
//                           adjoint wants it: ×1/2 except at DC and Nyquist,
//                           whose imaginary parts the adjoint drops
//   stft_loss_sum_kernel    every scale's partials summed in one fixed
//                           order into the loss (one block, after all scales)
//   backward, per scale:
//   (cuFFT C2R, torch.fft.irfft norm="forward")
//   stft_overlap_add_kernel each output sample gathers the ⌈n/h⌉ frames'
//                           contributions at its own padded position and at
//                           the reflect pad's mirror positions, times c[k]
//                           and the scalar upstream gradient; the first
//                           scale writes, the others add in scale order.
//
// RAVE v1's distance (models/rave.py) replaces the linear term by the
// scale's relative Frobenius norm ‖S_x − S_y‖ / ‖S_x‖, whose gradient needs
// both norms over the whole scale before any element's can be written, so
// its form takes one pass more in front (the log term is DDSP's):
//
//   stft_rave_norms_kernel      both spectra read: Σ(|S_x| − |S_y|)² and
//                               Σ|S_x|² of the bins a block walks, into
//                               per-block partials (float64)
//   stft_rave_loss_grad_kernel  every block sums those partials in one
//                               fixed order, then as stft_loss_grad_kernel
//                               with the linear gradient (|S_y| − |S_x|) /
//                               (‖S_x − S_y‖·‖S_x‖) (0 where the norms are
//                               0); block 0 adds ‖S_x − S_y‖ / ‖S_x‖ to its
//                               partial, so stft_loss_sum_kernel sums it in.
//
// DDSP's kernels above are left as they were: their arithmetic, and so the
// two DDSP cells' losses, are bit for bit what they were.
//
// What bounds it on an H100: bytes.  The transforms are 5.26 GFLOP a step
// at the published shape (B 16 × 192 000 samples, six scales), 0.26 ms at
// cuFFT's measured rate; the five passes move ≈ 208 B a sample of one
// signal a scale (K1 40, R2C 64, K2 48, C2R 32, overlap-add 24), ≈ 3.8 GB a
// step, 1.3 ms at the card's measured 2 983 GB/s.  Each kernel reads and
// writes contiguous runs (a warp's 32 threads on neighbouring addresses);
// the signal's rereads by overlapping frames hit L2.
//
// Numerics: float32 arithmetic, the partial sums in float64; no atomics,
// and every sum in an order fixed by the shapes alone: two launches agree
// bit for bit and a graph replay equals eager.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v  (see ops/kernels/__init__.py)

#include <cuda_runtime.h>

namespace {

constexpr int kFrameThreads = 256;
constexpr int kLossThreads = 256;  // ops/stft_loss.py LOSS_THREADS
constexpr int kSumThreads = 1024;
constexpr int kAddThreads = 256;
constexpr float kEps = 1e-7f;  // ops/core.py safe_log

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// blockIdx.x = row · n_frames + frame; rows < rows_x read x, the rest y
__global__ void stft_frame_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                  const float* __restrict__ c, float* __restrict__ frames,
                                  int rows_x, int T, int n, int hop, int n_frames) {
  const int rf = blockIdx.x;
  const int r = rf / n_frames;
  const int f = rf - r * n_frames;
  const float* src = r < rows_x ? x + static_cast<long long>(r) * T
                                : y + static_cast<long long>(r - rows_x) * T;
  float* out = frames + static_cast<long long>(rf) * n;
  const int base = f * hop - n / 2;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    int i = base + k;  // the padded position's index into the signal
    i = i < 0 ? -i : (i >= T ? 2 * (T - 1) - i : i);
    out[k] = src[i] * c[k];
  }
}

// spec: (2B, F, bins) complex, the target's rows first; grad: (B, F, bins)
__global__ void __launch_bounds__(kLossThreads)
stft_loss_grad_kernel(const float2* __restrict__ spec, float2* __restrict__ grad,
                      double* __restrict__ partials, int count, int bins, int nyquist,
                      float inv_m, double inv_m_d) {
  const float2* sx = spec;
  const float2* sy = spec + count;
  double acc = 0.0;
  for (int i = blockIdx.x * kLossThreads + threadIdx.x; i < count; i += gridDim.x * kLossThreads) {
    const float2 a = sx[i];
    const float2 b = sy[i];
    const float ax = hypotf(a.x, a.y);
    const float ay = hypotf(b.x, b.y);
    const float lx = logf(ax + kEps);
    const float ly = logf(ay + kEps);
    acc += static_cast<double>(fabsf(ax - ay)) + static_cast<double>(fabsf(lx - ly));
    const float g = (sgn(ay - ax) + sgn(ly - lx) / (ay + kEps)) * inv_m;
    const int m = i % bins;
    const bool edge = m == 0 || m == nyquist;
    float2 o = make_float2(0.f, 0.f);
    if (ay > 0.f) {
      const float s = (edge ? g : 0.5f * g) / ay;
      o.x = b.x * s;
      o.y = edge ? 0.f : b.y * s;
    }
    grad[i] = o;
  }
  __shared__ double sh[kLossThreads];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kLossThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0] * inv_m_d;
}

__global__ void __launch_bounds__(kSumThreads)
stft_loss_sum_kernel(const double* __restrict__ partials, int n, float* __restrict__ loss) {
  __shared__ double sh[kSumThreads];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) acc += partials[i];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = static_cast<float>(sh[0]);
}

// Σ over the frames f that hold padded position p (k = p − f·hop < n) of
// g[f, k]·c[k], f descending from p / hop
__device__ __forceinline__ float gather(const float* __restrict__ g, const float* __restrict__ c,
                                        int p, int n, int hop, int n_frames) {
  float acc = 0.f;
  for (int f = p / hop, k = p - f * hop; k < n && f >= 0; --f, k += hop) {
    if (f < n_frames) acc += g[static_cast<long long>(f) * n + k] * c[k];
  }
  return acc;
}

// gframes: (B, F, n) the frames' gradients after the C2R; out: (B, T)
__global__ void __launch_bounds__(kAddThreads)
stft_overlap_add_kernel(const float* __restrict__ gframes, const float* __restrict__ c,
                        const float* __restrict__ go, float* __restrict__ out, int rows, int T,
                        int n, int hop, int n_frames, int accumulate) {
  const long long idx = static_cast<long long>(blockIdx.x) * kAddThreads + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * T) return;
  const int b = static_cast<int>(idx / T);
  const int t = static_cast<int>(idx - static_cast<long long>(b) * T);
  const int pad = n / 2;
  const float* g = gframes + static_cast<long long>(b) * n_frames * n;
  // the sample's own padded position, then the reflect pad's mirrors
  float acc = gather(g, c, t + pad, n, hop, n_frames);
  if (t >= 1 && t <= pad) acc += gather(g, c, pad - t, n, hop, n_frames);
  if (t >= T - 1 - pad && t <= T - 2) acc += gather(g, c, pad + 2 * (T - 1) - t, n, hop, n_frames);
  const float v = *go * acc;
  out[idx] = accumulate ? out[idx] + v : v;
}

// the sum over the block of each thread's `x`, in a fixed order; every
// thread gets it
__device__ __forceinline__ double block_sum(double x, double* sh) {
  __syncthreads();  // sh may still be read by an earlier call
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int s = kLossThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// spec: (2B, F, bins) complex, the target's rows first; norms: (2, blocks)
__global__ void __launch_bounds__(kLossThreads)
stft_rave_norms_kernel(const float2* __restrict__ spec, double* __restrict__ norms, int count) {
  const float2* sx = spec;
  const float2* sy = spec + count;
  double dd = 0.0, xx = 0.0;
  for (int i = blockIdx.x * kLossThreads + threadIdx.x; i < count; i += gridDim.x * kLossThreads) {
    const float2 a = sx[i];
    const float2 b = sy[i];
    const float ax = hypotf(a.x, a.y);
    const float d = ax - hypotf(b.x, b.y);
    dd += static_cast<double>(d) * d;
    xx += static_cast<double>(ax) * ax;
  }
  __shared__ double sh[kLossThreads];
  dd = block_sum(dd, sh);
  xx = block_sum(xx, sh);
  if (threadIdx.x == 0) {
    norms[blockIdx.x] = dd;
    norms[gridDim.x + blockIdx.x] = xx;
  }
}

// as stft_loss_grad_kernel, with the relative linear term; norms: the
// (2, blocks) partials of stft_rave_norms_kernel over the same grid
__global__ void __launch_bounds__(kLossThreads)
stft_rave_loss_grad_kernel(const float2* __restrict__ spec, float2* __restrict__ grad,
                           double* __restrict__ partials, const double* __restrict__ norms,
                           int count, int bins, int nyquist, float inv_m, double inv_m_d) {
  __shared__ double sh[kLossThreads];
  double dd = 0.0, xx = 0.0;
  for (int i = threadIdx.x; i < gridDim.x; i += kLossThreads) {
    dd += norms[i];
    xx += norms[gridDim.x + i];
  }
  const double nd = sqrt(block_sum(dd, sh));
  const double nx = sqrt(block_sum(xx, sh));
  const float lin = nd > 0.0 && nx > 0.0 ? static_cast<float>(1.0 / (nd * nx)) : 0.f;
  const float2* sx = spec;
  const float2* sy = spec + count;
  double acc = 0.0;
  for (int i = blockIdx.x * kLossThreads + threadIdx.x; i < count; i += gridDim.x * kLossThreads) {
    const float2 a = sx[i];
    const float2 b = sy[i];
    const float ax = hypotf(a.x, a.y);
    const float ay = hypotf(b.x, b.y);
    const float lx = logf(ax + kEps);
    const float ly = logf(ay + kEps);
    acc += static_cast<double>(fabsf(lx - ly));
    const float g = (ay - ax) * lin + sgn(ly - lx) / (ay + kEps) * inv_m;
    const int m = i % bins;
    const bool edge = m == 0 || m == nyquist;
    float2 o = make_float2(0.f, 0.f);
    if (ay > 0.f) {
      const float s = (edge ? g : 0.5f * g) / ay;
      o.x = b.x * s;
      o.y = edge ? 0.f : b.y * s;
    }
    grad[i] = o;
  }
  const double total = block_sum(acc, sh) * inv_m_d;
  if (threadIdx.x == 0) partials[blockIdx.x] = blockIdx.x == 0 && nx > 0.0 ? total + nd / nx : total;
}

}  // namespace

extern "C" int ddsp_stft_frame(const float* x, const float* y, const float* c, float* frames,
                               int rows_x, int T, int n, int hop, int n_frames, void* stream) {
  const int threads = n < kFrameThreads ? ((n + 31) / 32) * 32 : kFrameThreads;
  stft_frame_kernel<<<2 * rows_x * n_frames, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, c, frames, rows_x, T, n, hop, n_frames);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddsp_stft_loss_grad(const float* spec, float* grad, double* partials, int count,
                                   int bins, int nyquist, float inv_m, double inv_m_d, int blocks,
                                   void* stream) {
  stft_loss_grad_kernel<<<blocks, kLossThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(spec), reinterpret_cast<float2*>(grad), partials, count,
      bins, nyquist, inv_m, inv_m_d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddsp_stft_loss_sum(const double* partials, int n, float* loss, void* stream) {
  stft_loss_sum_kernel<<<1, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(partials, n, loss);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddsp_stft_overlap_add(const float* gframes, const float* c, const float* go,
                                     float* out, int rows, int T, int n, int hop, int n_frames,
                                     int accumulate, void* stream) {
  const long long total = static_cast<long long>(rows) * T;
  const int blocks = static_cast<int>((total + kAddThreads - 1) / kAddThreads);
  stft_overlap_add_kernel<<<blocks, kAddThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gframes, c, go, out, rows, T, n, hop, n_frames, accumulate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddsp_stft_rave_norms(const float* spec, double* norms, int count, int blocks,
                                    void* stream) {
  stft_rave_norms_kernel<<<blocks, kLossThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(spec), norms, count);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ddsp_stft_rave_loss_grad(const float* spec, float* grad, double* partials,
                                        const double* norms, int count, int bins, int nyquist,
                                        float inv_m, double inv_m_d, int blocks, void* stream) {
  stft_rave_loss_grad_kernel<<<blocks, kLossThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(spec), reinterpret_cast<float2*>(grad), partials, norms, count,
      bins, nyquist, inv_m, inv_m_d);
  return static_cast<int>(cudaGetLastError());
}
