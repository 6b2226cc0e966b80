// GRU recurrence, backward — hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX GRU is a lax.scan, whose backward XLA
// derives.  The port's loop (models/decoder.py GRU.forward) left autograd
// ~23 kernels a frame backward; this kernel runs the chain of all frames in
// one launch.
//
// Computes, for each batch row and frame t = F-1 .. 0, from the output
// cotangent dout (B, F, H), the final state's cotangent dh_final (B, H)
// (or 0), W_hh (3H, H) and what gru_fwd.cu saved (r, z, n, hp_n, h_{t−1};
// planes of (5, B, F, H)):
//   dh    = dout_t + carry                      carry: dh_{F−1} = dh_final
//   dn    = dh·(1 − z)             dz = dh·(h_{t−1} − n)
//   da_n  = dn·(1 − n·n)           dhp_n = da_n·r
//   da_r  = (da_n·hp_n)·(r·(1 − r))
//   da_z  = dz·(z·(1 − z))
//   d(x_proj)_t = [da_r, da_z, da_n]            d(hp)_t = [da_r, da_z, dhp_n]
//   carry = d(hp)_t·W_hh + dh·z                 (the cotangent of h_{t−1})
// and writes d(x_proj) and d(hp) (B, F, 3H) and the last carry, the initial
// state's cotangent (B, H).  dW_hh = Σ d(hp)ᵀ·h_{t−1} over all B·F rows and
// db_hh = Σ d(hp) are one plain product and one sum after the launch
// (ops/gru.py), as the guide allows a plain large product outside a kernel.
//
// What bounds it on an H100: as the forward, 2·B·F·3H·H flops of chain
// products, and F dependent frames, each one exchange and one barrier.
//
// Design: the forward's cluster of 16 blocks, each owning H/16 units and
// holding those units' r, z and n rows of W_hh in registers, a thread two
// columns of them (192 floats at H = 512).  A frame:
//   * phase A, a thread per (unit, row) of the block: the carry is the sum
//     of the 16 blocks' partials for its unit (in block order, 0 .. 15)
//     plus the previous frame's dh·z; then the gates' cotangents above, and
//     d(hp) for its unit into the block's shared memory;
//   * phase B, a thread per two columns c of H, one row at a time: the
//     block's partial of the next carry, Σ over its units u and gates g
//     (g, then u, ascending) of d(hp)[g, u]·W_hh[g·H + u, c], in float32
//     FMAs (d(hp) read as 16-byte broadcasts), stored into the receive
//     buffer of the block that owns column c (distributed shared memory,
//     8-byte stores, double buffered);
//   * one barrier.cluster ends the frame.
// As in the forward, the global stores of a frame's results are issued
// after the next barrier, and the loads of a frame's saved values a frame
// ahead, so neither waits inside the chain; the batch is split across
// independent clusters the same way.
//
// Numerics: float32 FMA only (no TF32, no tensor cores), each product and
// sum of the gates rounded one by one (__fmul_rn, __fadd_rn), no atomics,
// and each sum in an order fixed by H alone: two launches agree bit for bit
// and a graph replay equals eager.  H is padded as in the forward.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v  (see ops/kernels/__init__.py)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;     // blocks a cluster; each owns H/16 units
constexpr int kMaxRows = 8;      // batch rows a cluster carries at most
constexpr int kMaxHidden = 512;  // W_hh has to fit the cluster's registers
constexpr int kMaxThreads = kMaxHidden / 2;  // a thread per two padded columns

// The padded width for H: the next of 64, 128, 256 and 512.
constexpr int padded(int hidden) {
  return hidden <= 64 ? 64 : hidden <= 128 ? 128 : hidden <= 256 ? 256 : 512;
}

template <int kHp>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ dh_final,
               const float* __restrict__ saved, const float* __restrict__ w_hh,
               float* __restrict__ dxp, float* __restrict__ dhp, float* __restrict__ dh0,
               int batch, int frames, int hidden, int rows) {
  constexpr int kUnits = kHp / kCluster;  // units this block owns
  extern __shared__ float4 smem4[];
  float* recv = reinterpret_cast<float*>(smem4);  // [2][kCluster][rows][kUnits]: partials
  float* d_s = recv + 2 * kCluster * rows * kUnits;  // [rows][3][kUnits]: this frame's d(hp)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kCluster) * rows;
  const int nrows = min(rows, batch - row0);
  const int tid = threadIdx.x;

  // phase B's columns c0, c0 + 1: their owner block and place there, and
  // w[g][u][e] = W_hh[g·H + rank·units + u, c0 + e], zero past H
  const int c0 = 2 * tid;
  const int dest = c0 / kUnits, col = c0 % kUnits;
  float w[3][kUnits][2];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = rank * kUnits + u;
        w[g][u][e] = (j < hidden && c0 + e < hidden)
                         ? w_hh[static_cast<size_t>(g * hidden + j) * hidden + c0 + e]
                         : 0.0f;
      }
  cluster.sync();  // every block is running before any peer writes into it

  // phase A's (unit, row)
  const bool phase_a = tid < kUnits * nrows;
  const int u = tid % kUnits, r = tid / kUnits;
  const int j = rank * kUnits + u;
  const bool act = phase_a && j < hidden;
  const int row = row0 + r;
  const size_t plane = static_cast<size_t>(batch) * frames * hidden;
  const size_t g3 = 3 * static_cast<size_t>(hidden);

  float carry = (act && dh_final != nullptr) ? dh_final[static_cast<size_t>(row) * hidden + j] : 0.0f;
  float direct = 0.0f;  // dh·z of the frame after this one
  // the saved values (dout, r, z, n, hp_n, h_{t−1}) of the frame ahead
  float pre[6] = {};
  if (act) {
    const size_t o = (static_cast<size_t>(row) * frames + frames - 1) * hidden + j;
    pre[0] = dout[o];
#pragma unroll
    for (int p = 0; p < 5; ++p) pre[1 + p] = saved[p * plane + o];
  }
  // the previous frame's results, stored after this frame's barrier
  float p_dx[3] = {}, p_dh[3] = {};

  for (int t = frames - 1; t >= 0; --t) {
    if (phase_a) {
      if (t < frames - 1) {
        const float* in = recv + ((t + 1) & 1) * kCluster * rows * kUnits + r * kUnits + u;
        float sum = in[0];
#pragma unroll
        for (int q = 1; q < kCluster; ++q) sum = __fadd_rn(sum, in[q * rows * kUnits]);
        carry = __fadd_rn(sum, direct);
      }
      float v[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) v[p] = pre[p];
      if (act) {
        if (t > 0) {
          const size_t o = (static_cast<size_t>(row) * frames + t - 1) * hidden + j;
          pre[0] = dout[o];
#pragma unroll
          for (int p = 0; p < 5; ++p) pre[1 + p] = saved[p * plane + o];
        }
        if (t < frames - 1) {
          const size_t o = (static_cast<size_t>(row) * frames + t + 1) * g3 + j;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            dxp[o + g * hidden] = p_dx[g];
            dhp[o + g * hidden] = p_dh[g];
          }
        }
      }
      const float r_ = v[1], z_ = v[2], n_ = v[3], hn = v[4], prev = v[5];
      const float dh = __fadd_rn(v[0], carry);
      const float dn = __fmul_rn(dh, __fsub_rn(1.0f, z_));
      const float dz = __fmul_rn(dh, __fsub_rn(prev, n_));
      const float da_n = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(n_, n_)));
      const float dhn = __fmul_rn(da_n, r_);
      const float da_r = __fmul_rn(__fmul_rn(da_n, hn), __fmul_rn(r_, __fsub_rn(1.0f, r_)));
      const float da_z = __fmul_rn(dz, __fmul_rn(z_, __fsub_rn(1.0f, z_)));
      direct = __fmul_rn(dh, z_);
      p_dx[0] = da_r, p_dx[1] = da_z, p_dx[2] = da_n;
      p_dh[0] = da_r, p_dh[1] = da_z, p_dh[2] = dhn;
      float* d = d_s + r * 3 * kUnits + u;
#pragma unroll
      for (int g = 0; g < 3; ++g) d[g * kUnits] = act ? p_dh[g] : 0.0f;
    }
    __syncthreads();

    float* out = cluster.map_shared_rank(
        recv + ((t & 1) * kCluster + rank) * rows * kUnits + col, dest);
    for (int rr = 0; rr < nrows; ++rr) {
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int u4 = 0; u4 < kUnits; u4 += 4) {
          const float4 d = *reinterpret_cast<const float4*>(d_s + (rr * 3 + g) * kUnits + u4);
          a0 = fmaf(w[g][u4][0], d.x, a0);
          a1 = fmaf(w[g][u4][1], d.x, a1);
          a0 = fmaf(w[g][u4 + 1][0], d.y, a0);
          a1 = fmaf(w[g][u4 + 1][1], d.y, a1);
          a0 = fmaf(w[g][u4 + 2][0], d.z, a0);
          a1 = fmaf(w[g][u4 + 2][1], d.z, a1);
          a0 = fmaf(w[g][u4 + 3][0], d.w, a0);
          a1 = fmaf(w[g][u4 + 3][1], d.w, a1);
        }
      *reinterpret_cast<float2*>(out + rr * kUnits) = make_float2(a0, a1);
    }
    cluster.sync();
  }

  if (phase_a) {
    const float* in = recv + r * kUnits + u;  // frame 0's partials, buffer 0
    float sum = in[0];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) sum = __fadd_rn(sum, in[q * rows * kUnits]);
    if (act) {
      dh0[static_cast<size_t>(row) * hidden + j] = __fadd_rn(sum, direct);
      const size_t o = static_cast<size_t>(row) * frames * g3 + j;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        dxp[o + g * hidden] = p_dx[g];
        dhp[o + g * hidden] = p_dh[g];
      }
    }
  }
}

struct Plan {
  int rows, clusters, threads;
  size_t smem;
};

// Rows a cluster and clusters for a batch of `batch` rows, as the forward
// plans them (gru_fwd.cu), for this kernel's shared memory.
template <typename Kernel>
cudaError_t plan_launch(Kernel kernel, int batch, int hidden, Plan* plan) {
  // clusters resident at once, by device and padded H (0: not asked yet)
  static int capacities[16][kMaxHidden / 64 + 1];
  const int hp = padded(hidden);
  const int units = hp / kCluster;
  const size_t row_bytes = sizeof(float) * (2 * kCluster + 3) * units;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int capacity = device < 16 ? capacities[device][hp / 64] : 0;
  if (capacity == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(hp / 2);
    cfg.dynamicSmemBytes = kMaxRows * row_bytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&capacity, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (capacity < 1) return cudaErrorLaunchOutOfResources;
    if (device < 16) capacities[device][hp / 64] = capacity;
  }
  plan->rows = min(kMaxRows, max(1, (batch + capacity - 1) / capacity));
  plan->clusters = (batch + plan->rows - 1) / plan->rows;
  plan->threads = hp / 2;
  plan->smem = plan->rows * row_bytes;
  return cudaSuccess;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns the launch's
// cudaError_t so the caller can raise.  dh_final may be null (a zero
// cotangent).  plan_out, if not null, gets the rows a cluster carries and
// the number of clusters.  Shapes are checked by the Python wrapper
// (ops/gru.py::gru_bwd): 1 ≤ hidden ≤ 512, frames ≥ 1.
extern "C" int ddsp_gru_bwd(const float* dout, const float* dh_final, const float* saved,
                            const float* w_hh, float* dxp, float* dhp, float* dh0, int batch,
                            int frames, int hidden, int* plan_out, void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || frames < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hp = padded(hidden);
  const auto kernel = hp == 64    ? gru_bwd_kernel<64>
                      : hp == 128 ? gru_bwd_kernel<128>
                      : hp == 256 ? gru_bwd_kernel<256>
                                  : gru_bwd_kernel<512>;
  Plan plan;
  cudaError_t err = plan_launch(kernel, batch, hidden, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan_out != nullptr) plan_out[0] = plan.rows, plan_out[1] = plan.clusters;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster * plan.clusters);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, dout, dh_final, saved, w_hh, dxp, dhp, dh0, batch,
                           frames, hidden, plan.rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
