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
// 4*(K+2) bytes, and does 4 FMAs (8 flops) per harmonic per sample: the two
// recurrences, the dA product and the dtheta sum.  At K = 64 that is ~2K
// flops per byte, so the FP32 pipe bounds it (8*R*S*K over 67 TFLOP/s);
// the bytes take a fifth of that time.
//
// Design.  The first port reduced every dA_rk across the 32 lanes of a warp
// for every sample (a 5-step shuffle per harmonic per sample), so the
// shuffle pipe, not the FP32 pipe, set its pace.  Here no value crosses
// lanes inside the sample loop:
//   * a warp owns a share of one row's samples, two at a time per lane
//     (i and i + 32, so the g loads stay coalesced), and keeps the row's
//     dA partials for a tile of TILE harmonics in registers across all its
//     samples (`part[TILE]`, indexed by compile-time constants only);
//   * after the sample loop each warp reduces its TILE partials across its
//     lanes ONCE, by a reduce-scatter butterfly: 5 halving steps of
//     TILE/2, TILE/4, ... shuffles (62 at TILE = 64) leave each lane with
//     TILE/32 finished sums; the warps sharing a row add theirs through
//     shared memory.  S*K warp reductions become one per warp and tile;
//   * the row's k*A_k sit in shared memory, read as 16-byte float4
//     broadcasts: one load feeds 4 harmonics of 2 samples, 8 dtheta FMAs
//     (the first port re-read one float per FMA);
//   * a CTA of 4 warps takes 4 rows (a warp a row) when there are many
//     rows, so a row's set-up and reduction are paid once (2 warps a row
//     measured slower at R = 6000); with few rows it puts all 4 warps on
//     one row, for latency;
//   * K is a template parameter: TILE = 64 with one pass is the main path
//     (every committed config has 64 harmonics), so the harmonic loop and
//     `part` unroll fully into registers.  Any other K runs the SAME kernel
//     with TILE = 32 in ceil(K/32) passes; a pass first advances both
//     recurrences to its first harmonic without accumulating, so the sines
//     are those of the one-pass kernel.  The launcher picks by K.
// Tensor cores do not apply: the per-row products share no operand across
// rows (each row has its own theta grid and amplitudes), and TF32 would
// not meet the 1e-4 check against the plain version.
//
// Numerics as in oscillator_fwd.cu: theta from explicit round-to-nearest
// multiply and add (bitwise the plain version's), the accurate libdevice
// sincosf (build WITHOUT --use_fast_math), f32 throughout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v  (see ops/kernels/__init__.py)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 4;         // warps per CTA
constexpr int kFixedK = 64;       // the main path's harmonics: one pass
constexpr int kRuntimeTile = 32;  // harmonics per pass for any other K
constexpr int kManyRows = 1056;   // from here on a warp a row, else 4

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Reduce-scatter of v[0..N) across the warp: at each step the lanes whose
// bit M is set keep the upper half and send the lower, the others the
// reverse, so N/2 shuffles halve what a lane holds.  After the steps
// M = 16 .. 1 lane L holds in v[0 .. N/32) the warp's sums of harmonics
// base + j (base from L's bits).
template <int N, int M, int A>
__device__ __forceinline__ void reduce_scatter(float (&v)[A], int lane, int& base) {
  if constexpr (M >= 1) {
    constexpr int H = N / 2;
    const bool upper = (lane & M) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = upper ? v[j] : v[j + H];
      const float keep = upper ? v[j + H] : v[j];
      v[j] = keep + __shfl_xor_sync(kFullMask, send, M);
    }
    if (upper) base += H;
    reduce_scatter<H, M / 2>(v, lane, base);
  }
}

// sin and cos of (k-1)*theta and k*theta for one sample
struct Osc {
  float sp, sk, cp, ck, two_c;
};

__device__ __forceinline__ void advance(Osc& o) {
  const float sn = fmaf(o.two_c, o.sk, -o.sp);
  const float cn = fmaf(o.two_c, o.ck, -o.cp);
  o.sp = o.sk;
  o.sk = sn;
  o.cp = o.ck;
  o.ck = cn;
}

// One harmonic of two samples: dA partial, dtheta sums, recurrences.
__device__ __forceinline__ void harmonic(float kamp, float& part, Osc& o0, Osc& o1,
                                         float g0, float g1, float& fac0, float& fac1) {
  part = fmaf(g0, o0.sk, part);
  part = fmaf(g1, o1.sk, part);
  fac0 = fmaf(kamp, o0.ck, fac0);
  fac1 = fmaf(kamp, o1.ck, fac1);
  advance(o0);
  advance(o1);
}

__device__ __forceinline__ Osc start(float p, float w, float ramp) {
  float s, c;
  sincosf(__fadd_rn(p, __fmul_rn(w, ramp)), &s, &c);
  return Osc{0.0f, s, 1.0f, c, 2.0f * c};
}

// Shared memory: [kWarps][TILE] reduced dA partials, [kWarps][2] dphi and
// domega partials, then [rows per CTA][k_pad] k*A_k (16-byte aligned: the
// two earlier parts are 4*TILE + 8 floats).
template <int TILE, bool kOnePass>
__global__ void __launch_bounds__(32 * kWarps)
    oscillator_bwd_kernel(const float* __restrict__ phi, const float* __restrict__ omega,
                          const float* __restrict__ amp, const float* __restrict__ grad,
                          float* __restrict__ dphi, float* __restrict__ domega,
                          float* __restrict__ damp, int rows, int n_harmonic,
                          int block_size, int warps_per_row) {
  static_assert(TILE >= 32 && (TILE & (TILE - 1)) == 0, "TILE: a power of two >= 32");
  constexpr int kPerLane = TILE / 32;
  extern __shared__ float4 smem4[];
  float* red_s = reinterpret_cast<float*>(smem4);
  float* acc_s = red_s + kWarps * TILE;
  float* kamp_all = acc_s + 2 * kWarps;

  const int rows_per_cta = kWarps / warps_per_row;
  const int k_pad = kOnePass ? TILE : (n_harmonic + TILE - 1) / TILE * TILE;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = warp / warps_per_row;   // the CTA's row this warp works on
  const int share = warp % warps_per_row;  // and which share of its samples
  const int row = blockIdx.x * rows_per_cta + slot;
  const bool live = row < rows;
  const int r = live ? row : rows - 1;  // a CTA's last slot may be empty

  float* kamp_s = kamp_all + slot * k_pad;
  const float* amp_row = amp + static_cast<size_t>(r) * n_harmonic;
  for (int k = share * 32 + lane; k < k_pad; k += warps_per_row * 32) {
    kamp_s[k] = k < n_harmonic ? static_cast<float>(k + 1) * amp_row[k] : 0.0f;
  }
  __syncthreads();

  const float p = phi[r];
  const float w = omega[r];
  const float* g_row = grad + static_cast<size_t>(r) * block_size;
  float* damp_row = damp + static_cast<size_t>(r) * n_harmonic;
  const int n_pairs = (block_size + 63) / 64;
  float dphi_acc = 0.0f;
  float domega_acc = 0.0f;

  for (int k0 = 0; k0 < k_pad; k0 += TILE) {
    float part[TILE];
#pragma unroll
    for (int j = 0; j < TILE; ++j) part[j] = 0.0f;

    for (int pair = share; pair < n_pairs; pair += warps_per_row) {
      const int i0 = pair * 64 + lane;
      const int i1 = i0 + 32;
      // samples past the end take g = 0: they add nothing
      const float g0 = i0 < block_size ? g_row[i0] : 0.0f;
      const float g1 = i1 < block_size ? g_row[i1] : 0.0f;
      const float ramp0 = static_cast<float>(i0 + 1);
      const float ramp1 = static_cast<float>(i1 + 1);
      Osc o0 = start(p, w, ramp0);
      Osc o1 = start(p, w, ramp1);
      if constexpr (!kOnePass) {
        for (int k = 0; k < k0; ++k) {
          advance(o0);
          advance(o1);
        }
      }
      float fac0 = 0.0f;
      float fac1 = 0.0f;
#pragma unroll
      for (int j = 0; j < TILE; j += 4) {
        const float4 a = *reinterpret_cast<const float4*>(kamp_s + k0 + j);
        harmonic(a.x, part[j], o0, o1, g0, g1, fac0, fac1);
        harmonic(a.y, part[j + 1], o0, o1, g0, g1, fac0, fac1);
        harmonic(a.z, part[j + 2], o0, o1, g0, g1, fac0, fac1);
        harmonic(a.w, part[j + 3], o0, o1, g0, g1, fac0, fac1);
      }
      const float dt0 = g0 * fac0;
      const float dt1 = g1 * fac1;
      dphi_acc += dt0;
      dphi_acc += dt1;
      domega_acc = fmaf(ramp0, dt0, domega_acc);
      domega_acc = fmaf(ramp1, dt1, domega_acc);
    }

    int base = 0;
    reduce_scatter<TILE, 16>(part, lane, base);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) red_s[warp * TILE + base + j] = part[j];
    __syncthreads();
    if (share == 0 && live) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        float sum = 0.0f;
        for (int v = 0; v < warps_per_row; ++v) sum += red_s[(warp + v) * TILE + base + j];
        const int k = k0 + base + j;
        if (k < n_harmonic) damp_row[k] = sum;
      }
    }
    __syncthreads();  // red_s is reused by the next pass
  }

  dphi_acc = warp_sum(dphi_acc);
  domega_acc = warp_sum(domega_acc);
  if (lane == 0) {
    acc_s[2 * warp] = dphi_acc;
    acc_s[2 * warp + 1] = domega_acc;
  }
  __syncthreads();
  if (share == 0 && lane == 0 && live) {
    float a = 0.0f, b = 0.0f;
    for (int v = 0; v < warps_per_row; ++v) {
      a += acc_s[2 * (warp + v)];
      b += acc_s[2 * (warp + v) + 1];
    }
    dphi[row] = a;
    domega[row] = b;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the caller can raise on a refused launch.  Shapes are checked by the
// Python wrapper (ops/oscillator.py::oscillator_bank_bwd), which bounds K so
// that the shared memory stays under 48 KB.
extern "C" int ddsp_oscillator_bwd(const float* phi, const float* omega,
                                   const float* amp, const float* grad,
                                   float* dphi, float* domega, float* damp,
                                   int rows, int n_harmonic, int block_size,
                                   void* stream) {
  const int warps_per_row = rows >= kManyRows ? 1 : kWarps;
  const int rows_per_cta = kWarps / warps_per_row;
  const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta);
  const dim3 block(32 * kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_harmonic == kFixedK) {
    const size_t smem =
        sizeof(float) * (kWarps * kFixedK + 2 * kWarps + rows_per_cta * kFixedK);
    oscillator_bwd_kernel<kFixedK, true><<<grid, block, smem, s>>>(
        phi, omega, amp, grad, dphi, domega, damp, rows, n_harmonic, block_size,
        warps_per_row);
  } else {
    const int k_pad = (n_harmonic + kRuntimeTile - 1) / kRuntimeTile * kRuntimeTile;
    const size_t smem =
        sizeof(float) * (kWarps * kRuntimeTile + 2 * kWarps + rows_per_cta * k_pad);
    oscillator_bwd_kernel<kRuntimeTile, false><<<grid, block, smem, s>>>(
        phi, omega, amp, grad, dphi, domega, damp, rows, n_harmonic, block_size,
        warps_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}
