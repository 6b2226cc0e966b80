// GRU recurrence, forward — hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX GRU (ddsp_pytorch_tpu/models/decoder.py
// GRU) is a lax.scan that XLA compiles.  The port's loop (models/decoder.py
// GRU.forward) launched ~13 kernels a frame forward, a (B, H)·(H, 3H)
// product and the gates; this kernel runs all frames in one launch.
//
// Computes, for each batch row and frame t = 0 .. F-1, given the input
// projection x_proj (B, F, 3H) (x·W_ihᵀ + b_ih, one plain product before
// the launch), W_hh (3H, H), b_hh (3H) and h_{-1} = h0 or 0, gate order
// [r, z, n]:
//   hp  = h_{t-1}·W_hhᵀ + b_hh
//   r   = σ(x_r + hp_r),  z = σ(x_z + hp_z),  σ(a) = 1 / (1 + exp(−a))
//   n   = tanh(x_n + r·hp_n)
//   h_t = (1 − z)·n + z·h_{t−1}
// It writes h_t (B, F, H) and h_{F−1} (B, H) and, when the caller trains,
// what the backward kernel (gru_bwd.cu) reads: r, z, n, hp_n and h_{t−1},
// the planes of `saved` (5, B, F, H).
//
// What bounds it on an H100: the product is 2·B·F·3H·H flops (9.4 GFLOP at
// B = 16, F = 375, H = 512, 0.14 ms at the 67 TFLOP/s float32 peak), but
// the frames are a chain: frame t needs all of h_{t−1}.  So the floor is F
// times what one frame's exchange of h and one barrier across the SMs that
// share the work cost (`gru_barrier_probe` below measures it).
//
// Design.  One thread-block cluster of 16 blocks (the non-portable size,
// one block an SM) holds all of W_hh on chip for every frame, in
// registers: each block owns H/16 hidden units, a thread two of them, and
// the thread keeps those units' r, z and n weights for its k slice in
// registers (192 floats at H = 512).  Streaming them from shared memory
// instead cost ~1.5 us a frame (PERF.md).  A frame:
//   * every block computes its units' 3·H/16 rows of hp for the cluster's
//     batch rows, one row at a time, from its own full copy of h_{t−1}
//     (shared memory, double buffered).  Sixteen lanes share a unit pair:
//     lane s sums the products over k = 64c + 4s + e (c = 0 .. H/64−1,
//     e = 0 .. 3) in that order (one float4 load of h feeds 24 FMAs, the
//     16 lanes on 256 contiguous bytes), then the 16 lanes add their sums
//     in an xor butterfly (8, 4, 2, 1), which leaves the same bits in every
//     lane (a + b == b + a);
//   * lane s finishes batch row s: the gates and h_t of its two units, into
//     the block's next h buffer; after a __syncthreads the block's threads
//     copy its units' slice of it into the 15 other blocks' next buffers
//     (distributed shared memory, 16-byte stores);
//   * one barrier.cluster (arrive.release, wait.acquire) ends the frame.
// The global stores of a frame's results are issued after the next
// barrier, and the loads of a frame's x_proj right after the barrier
// before it, so neither waits inside the frame's chain.
// Clusters never wait for each other: the batch is split into groups of
// `rows` rows (at most 8), one group a cluster; `rows` is the fewest that
// lets all groups be resident at once (cudaOccupancyMaxActiveClusters), so
// more groups than that run in waves.
//
// Numerics: float32 FMA only (no TF32, no tensor cores), the accurate
// expf and tanhf (build WITHOUT --use_fast_math), the gates' products and
// sums rounded one by one (__fmul_rn, __fadd_rn: no contraction) in the
// loop's order, no atomics.  Each (row, frame, unit) sum is taken in an
// order fixed by H alone, not by B, F, the row's place or `rows`: two
// launches agree bit for bit, a graph replay equals eager, and a clip run
// in blocks of frames with the state carried equals one pass over it.
// H up to 512 is taken, padded to the next of 64, 128, 256 and 512 (a
// template instance each, so every loop unrolls and the weights' indices
// are constants) with zero weights, whose units stay 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v  (see ops/kernels/__init__.py)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;     // blocks a cluster; each owns H/16 units
constexpr int kSlices = 16;      // lanes that share a unit pair's sums
constexpr int kMaxRows = 8;      // batch rows a cluster carries at most
constexpr int kMaxHidden = 512;  // W_hh has to fit the cluster's registers
constexpr int kMaxThreads = kMaxHidden / kCluster / 2 * kSlices;  // a thread a (unit pair, slice)

__device__ __forceinline__ float sigmoid(float a) { return 1.0f / (1.0f + expf(-a)); }

// The padded width for H: the next of 64, 128, 256 and 512.
__host__ __device__ constexpr int padded(int hidden) {
  return hidden <= 64 ? 64 : hidden <= 128 ? 128 : hidden <= 256 ? 256 : 512;
}

// This block's units of the rows' next h, h_next[r][rank·units .. +units),
// stored into the same place of the 15 other blocks' shared memory, 16
// bytes a store spread over the block's threads (a lane a row's store of 4
// bytes to each block, 2 lanes a warp instruction, made the exchange cost
// 0.28 us a row a frame).
__device__ __forceinline__ void send_units(cg::cluster_group& cluster, float* h_next, int rank,
                                           int units, int hp, int nrows) {
  const int chunks = units / 4;
  const int per_peer = nrows * chunks;
  for (int i = threadIdx.x; i < (kCluster - 1) * per_peer; i += blockDim.x) {
    const int q = i / per_peer, rem = i % per_peer;
    const int peer = q < rank ? q : q + 1;
    float* at = h_next + (rem / chunks) * hp + rank * units + 4 * (rem % chunks);
    *reinterpret_cast<float4*>(cluster.map_shared_rank(at, peer)) =
        *reinterpret_cast<const float4*>(at);
  }
}

template <int kHp>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_fwd_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               float* __restrict__ out, float* __restrict__ h_final,
               float* __restrict__ saved, int batch, int frames, int hidden, int rows) {
  constexpr int kUnits = kHp / kCluster;  // units this block owns
  constexpr int kChunks = kHp / (4 * kSlices);  // a lane's float4 chunks of k
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // [2][rows][kHp]: h_{t−1}, h_t
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kCluster) * rows;
  const int nrows = min(rows, batch - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int s = lane & 15;  // k slice; the row this lane finishes
  const int j0 = rank * kUnits + 2 * (2 * (tid >> 5) + (lane >> 4));  // units j0, j0 + 1

  // w[q][g][c][e] = W_hh[g·H + j0 + q, 64c + 4s + e], zero past H
  float w[2][3][kChunks][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 64 * c + 4 * s + e;
          w[q][g][c][e] = (j0 + q < hidden && k < hidden)
                              ? w_hh[static_cast<size_t>(g * hidden + j0 + q) * hidden + k]
                              : 0.0f;
        }
  for (int i = tid; i < 2 * rows * kHp; i += blockDim.x) {
    const int k = i % kHp, r = (i / kHp) % rows, buf = i / (rows * kHp);
    h_s[i] = (buf == 0 && h0 != nullptr && r < nrows && k < hidden)
                 ? h0[static_cast<size_t>(row0 + r) * hidden + k]
                 : 0.0f;
  }
  cluster.sync();  // every block is set up before any peer writes into it

  const bool owner = s < nrows && j0 < hidden;
  const int row = row0 + s;
  const size_t plane = static_cast<size_t>(batch) * frames * hidden;
  const size_t g3 = 3 * static_cast<size_t>(hidden);
  float bias[2][3];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int g = 0; g < 3; ++g) bias[q][g] = j0 + q < hidden ? b_hh[g * hidden + j0 + q] : 0.0f;
  // the previous frame's results (h, r, z, n, hp_n, h_{t−1}) of both units,
  // stored after this frame's barrier
  float p[2][6] = {};

  for (int t = 0; t < frames; ++t) {
    const float* hc = h_s + (t & 1) * rows * kHp;
    float* hn_s = h_s + ((t + 1) & 1) * rows * kHp;
    float x[2][3] = {};
    if (owner) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (j0 + q >= hidden) continue;
        const float* xt = x_proj + (static_cast<size_t>(row) * frames + t) * g3 + j0 + q;
#pragma unroll
        for (int g = 0; g < 3; ++g) x[q][g] = xt[g * hidden];
        if (t > 0) {
          const size_t o = (static_cast<size_t>(row) * frames + t - 1) * hidden + j0 + q;
          out[o] = p[q][0];
          if (saved != nullptr) {
#pragma unroll
            for (int v = 1; v < 6; ++v) saved[(v - 1) * plane + o] = p[q][v];
          }
        }
      }
    }

    float hpr[2][3] = {};
    for (int r = 0; r < nrows; ++r) {
      float a[2][3] = {};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 h = *reinterpret_cast<const float4*>(hc + r * kHp + 64 * c + 4 * s);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            a[q][g] = fmaf(w[q][g][c][0], h.x, a[q][g]);
            a[q][g] = fmaf(w[q][g][c][1], h.y, a[q][g]);
            a[q][g] = fmaf(w[q][g][c][2], h.z, a[q][g]);
            a[q][g] = fmaf(w[q][g][c][3], h.w, a[q][g]);
          }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int m = kSlices / 2; m >= 1; m >>= 1)
            a[q][g] += __shfl_xor_sync(0xffffffffu, a[q][g], m);
          if (r == s) hpr[q][g] = a[q][g];
        }
    }

    if (owner) {
      float h_new[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float hr = __fadd_rn(hpr[q][0], bias[q][0]);
        const float hz = __fadd_rn(hpr[q][1], bias[q][1]);
        const float hn = __fadd_rn(hpr[q][2], bias[q][2]);
        const float r_ = sigmoid(__fadd_rn(x[q][0], hr));
        const float z_ = sigmoid(__fadd_rn(x[q][1], hz));
        const float n_ = tanhf(__fadd_rn(x[q][2], __fmul_rn(r_, hn)));
        const float prev = hc[s * kHp + j0 + q];
        // a padded unit (zero weights, bias and x) stays 0 exactly
        h_new[q] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z_), n_), __fmul_rn(z_, prev));
        p[q][0] = h_new[q], p[q][1] = r_, p[q][2] = z_, p[q][3] = n_, p[q][4] = hn, p[q][5] = prev;
      }
      *reinterpret_cast<float2*>(hn_s + s * kHp + j0) = make_float2(h_new[0], h_new[1]);
    }
    __syncthreads();
    send_units(cluster, hn_s, rank, kUnits, kHp, nrows);
    cluster.sync();
  }

  if (owner) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (j0 + q >= hidden) continue;
      const size_t o = (static_cast<size_t>(row) * frames + frames - 1) * hidden + j0 + q;
      out[o] = p[q][0];
      h_final[static_cast<size_t>(row) * hidden + j0 + q] = p[q][0];
      if (saved != nullptr) {
#pragma unroll
        for (int v = 1; v < 6; ++v) saved[(v - 1) * plane + o] = p[q][v];
      }
    }
  }
}

// The sequential floor: `frames` frames of the forward's exchange and
// barrier alone, on the forward's cluster shape.  Each frame, the
// forward's lanes write their units' h into the block's next buffer, the
// block sends its slice to the 15 others (`send_units`) and the cluster
// waits at one barrier.  `sink` (rows, H) gets the last values, so nothing
// is dead.
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_barrier_probe_kernel(float* __restrict__ sink, int frames, int hidden, int rows) {
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int hp = padded(hidden);
  const int units = hp / kCluster;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * rows * hp; i += blockDim.x) h_s[i] = 0.0f;
  cluster.sync();
  const int lane = tid & 31;
  const int s = lane & 15;
  const int j0 = rank * units + 2 * (2 * (tid >> 5) + (lane >> 4));
  const bool owner = s < rows && j0 < hidden;
  for (int t = 0; t < frames; ++t) {
    const float* hc = h_s + (t & 1) * rows * hp;
    float* hn_s = h_s + ((t + 1) & 1) * rows * hp;
    if (owner) {
      const float2 v = *reinterpret_cast<const float2*>(hc + s * hp + j0);
      *reinterpret_cast<float2*>(hn_s + s * hp + j0) = make_float2(v.x + 1.0f, v.y + 1.0f);
    }
    __syncthreads();
    send_units(cluster, hn_s, rank, units, hp, rows);
    cluster.sync();
  }
  if (owner && blockIdx.x < kCluster) {
    const float* last = h_s + (frames & 1) * rows * hp + s * hp + j0;
    sink[s * hidden + j0] = last[0];
    if (j0 + 1 < hidden) sink[s * hidden + j0 + 1] = last[1];
  }
}

struct Plan {
  int rows, clusters, threads;
  size_t smem;
};

// Rows a cluster and clusters for a batch of `batch` rows: as few rows as
// let every cluster be resident at once, at most kMaxRows.
template <typename Kernel>
cudaError_t plan_launch(Kernel kernel, int batch, int hidden, Plan* plan) {
  // clusters resident at once, by device and padded H (0: not asked yet),
  // one table a kernel signature (the probe's, the forward's instances)
  static int capacities[16][kMaxHidden / 64 + 1];
  const int hp = padded(hidden);
  const size_t row_bytes = sizeof(float) * 2 * hp;
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

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Plan& plan, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster * plan.clusters);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns the launch's
// cudaError_t so the caller can raise.  h0 and saved may be null (a zero
// initial state; no training).  plan_out, if not null, gets the rows a
// cluster carries and the number of clusters.  Shapes are checked by the
// Python wrapper (ops/gru.py::gru_fwd): 1 ≤ hidden ≤ 512, frames ≥ 1.
extern "C" int ddsp_gru_fwd(const float* x_proj, const float* w_hh, const float* b_hh,
                            const float* h0, float* out, float* h_final, float* saved, int batch,
                            int frames, int hidden, int* plan_out, void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || frames < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hp = padded(hidden);
  const auto kernel = hp == 64    ? gru_fwd_kernel<64>
                      : hp == 128 ? gru_fwd_kernel<128>
                      : hp == 256 ? gru_fwd_kernel<256>
                                  : gru_fwd_kernel<512>;
  Plan plan;
  cudaError_t err = plan_launch(kernel, batch, hidden, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan_out != nullptr) plan_out[0] = plan.rows, plan_out[1] = plan.clusters;
  err = launch(kernel, plan, static_cast<cudaStream_t>(stream), x_proj, w_hh, b_hh, h0, out,
               h_final, saved, batch, frames, hidden, plan.rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One cluster of the probe above, as the forward would place it for
// `rows` rows (1 ≤ rows ≤ 8) of width `hidden`.
extern "C" int ddsp_gru_barrier_probe(float* sink, int frames, int hidden, int rows,
                                      void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || frames < 1 || rows < 1 || rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  cudaError_t err = plan_launch(gru_barrier_probe_kernel, rows, hidden, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan.rows = rows;
  plan.clusters = 1;
  plan.smem = sizeof(float) * 2 * rows * padded(hidden);
  err = launch(gru_barrier_probe_kernel, plan, static_cast<cudaStream_t>(stream), sink, frames,
               hidden, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
