// Pairwise Chamfer matrix of point clouds: kernel K4 of the port.
//
// Replaces brepgen_tpu/kernels/chamfer.py:_chamfer_kernel (the Pallas TPU
// kernel behind chamfer_matrix). For sample clouds x [S, P, 3] and reference
// clouds y [R, P, 3], f32, it writes
//
//   out[s, r] = (1/n) sum_{p<n} min_{q<n} |x_sp - y_rq|^2
//             + (1/n) sum_{q<n} min_{p<n} |y_rq - x_sp|^2
//
// where n <= P is the true point count (points at n..P-1 are padding and are
// read by no thread). Distances are direct differences summed over the three
// coordinates in the Pallas body's order ((dx^2 + dy^2) + dz^2), so a cloud
// against itself gives an exact zero; the expansion |x|^2 + |y|^2 - 2 x.y
// cancels badly for near points.
//
// What bounds it: operations. A pair of clouds needs n^2 distances of 8 FLOP
// (3 sub, 3 mul, 2 add); at the protocol's n = 2000 that is 32 MFLOP against
// 48 KB of clouds, so memory traffic is negligible. K = 3 makes tensor cores
// useless and the f32 bar rules out TF32. On the card the limit is the issue
// rate: each distance is 6 instructions (3 FADD, FMUL, 2 FFMA) and feeds two
// running mins (2 FMNMX), 8 instructions a point pair.
//
// Design: each point-pair distance is evaluated once and feeds both
// directions. One launch, one block per (x_i, y_j) pair, each out[i, j]
// written once by that block (no atomics onto the output, so two launches on
// the same inputs give the same bits). The block stages b = y_j in shared
// memory as float4 (one broadcast 16-byte load per point), padded to a
// multiple of kGroup with +inf points that enter no min; the fourth slot of
// each point holds its column min. Each of its kThreads threads keeps
// kPerThread points of a = x_i in registers (+inf past n, so they enter no
// column min) with their row mins, for a pass of kPass points; a larger n
// takes further passes over a. A thread sweeps b in groups of kGroup points:
// kPerThread x kGroup distances update its kPerThread row mins and kGroup
// column mins over its own a-points. A warp butterfly reduce-scatter (one
// SHFL and one FMNMX per value and step, plus two SEL) leaves each lane with
// one column's min over the warp, and an unsigned atomicMin on the point's
// fourth slot combines the warps and the passes: the distances are
// non-negative floats (never -0), whose bits order as unsigned integers, and
// min is exact, so the order of the atomics does not matter. Both sums of
// mins are then taken in a fixed order (per thread, then a shuffle tree,
// then the warps in order). There is no double buffer of b: three more
// blocks of 128 threads share each SM, and their sweeps cover one block's
// staging.
//
// kGroup = 8: the reduce-scatter costs the same share of a group's work at
// 8, 16 or 32 (about 3%), and at 128 registers (four blocks an SM) groups
// of 16 and 32 put the column mins on the stack (64 and 128 bytes of stack
// frame in ptxas's report) and ran slower on an H100 at 256 x 256 x 2000.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks an SM holds: at most 128 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kPass = kThreads * kPerThread;  // a-points per pass of the block
constexpr int kGroup = 8;                     // b-points per register group
constexpr int kLanesPerColumn = 32 / kGroup;  // lanes that end with one column's min
constexpr int kMaxSmem = 232448 - 1024;       // dynamic bytes: a Hopper block's 227 KB
                                              // less room for the static arrays
// points of one cloud, padded to whole groups, that fit the staged b-cloud
constexpr int kMaxPoints = kMaxSmem / static_cast<int>(sizeof(float4)) / 32 * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// v[c] is this lane's min for column c of the group; afterwards v[0] holds
// the warp's min for column lane / kLanesPerColumn.
__device__ __forceinline__ void column_reduce_scatter(float (&v)[kGroup], int lane) {
  int off = 16;
#pragma unroll
  for (int h = kGroup / 2; h >= 1; h >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int c = 0; c < h; ++c) {
      const float keep = upper ? v[c + h] : v[c];
      const float send = upper ? v[c] : v[c + h];
      v[c] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, off));
    }
  }
#pragma unroll
  for (int o = kLanesPerColumn / 2; o >= 1; o >>= 1)
    v[0] = fminf(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
chamfer_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int R, int P, int n) {
  extern __shared__ float4 smem[];
  const int n_pad = (n + kGroup - 1) / kGroup * kGroup;
  float4* cloud = smem;  // [n_pad] b (x, y, z, column min)
  __shared__ float partial[kWarps][2];

  const long long bid = blockIdx.x;
  const int i = static_cast<int>(bid / R), j = static_cast<int>(bid % R);
  const float* a = x + static_cast<size_t>(i) * P * 3;
  const float* b = y + static_cast<size_t>(j) * P * 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int q = threadIdx.x; q < n_pad; q += kThreads) {
    cloud[q] = q < n ? make_float4(b[3 * q], b[3 * q + 1], b[3 * q + 2], CUDART_INF_F)
                     : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
  }
  __syncthreads();

  float row_total = 0.f;
  for (int p0 = 0; p0 < n; p0 += kPass) {
    float ax[kPerThread], ay[kPerThread], az[kPerThread], row_min[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int p = p0 + k * kThreads + threadIdx.x;
      const bool ok = p < n;
      ax[k] = ok ? a[3 * p] : CUDART_INF_F;
      ay[k] = ok ? a[3 * p + 1] : CUDART_INF_F;
      az[k] = ok ? a[3 * p + 2] : CUDART_INF_F;
      row_min[k] = CUDART_INF_F;
    }
#pragma unroll 1
    for (int g0 = 0; g0 < n_pad; g0 += kGroup) {
      float col[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const float4 q = cloud[g0 + c];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const float dx = ax[k] - q.x, dy = ay[k] - q.y, dz = az[k] - q.z;
          float d = dx * dx;
          d = d + dy * dy;
          d = d + dz * dz;
          row_min[k] = fminf(row_min[k], d);
          col[c] = k == 0 ? d : fminf(col[c], d);
        }
      }
      column_reduce_scatter(col, lane);
      if ((lane & (kLanesPerColumn - 1)) == 0)
        atomicMin(reinterpret_cast<unsigned*>(&cloud[g0 + lane / kLanesPerColumn].w),
                  __float_as_uint(col[0]));
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (p0 + k * kThreads + threadIdx.x < n) row_total += row_min[k];
  }
  __syncthreads();  // every column min is final

  float col_total = 0.f;
  for (int q = threadIdx.x; q < n; q += kThreads) col_total += cloud[q].w;
  row_total = warp_sum(row_total);
  col_total = warp_sum(col_total);
  if (lane == 0) {
    partial[warp][0] = row_total;
    partial[warp][1] = col_total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float rows = 0.f, cols = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      rows += partial[w][0];
      cols += partial[w][1];
    }
    const float nf = static_cast<float>(n);
    out[bid] = rows / nf + cols / nf;
  }
}

}  // namespace

// x [S, P, 3], y [R, P, 3] f32 contiguous on the current device; out [S, R]
// f32, every element written once. Returns a cudaError_t (0 on success).
extern "C" int chamfer_matrix_forward(const float* x, const float* y, float* out, int S,
                                      int R, int P, int n, void* stream) {
  if (S <= 0 || R <= 0 || n <= 0 || n > P || n > kMaxPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(S) * R;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n_pad = (n + kGroup - 1) / kGroup * kGroup;
  const size_t smem = sizeof(float4) * n_pad;
  cudaError_t err = cudaFuncSetAttribute(chamfer_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chamfer_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(x, y, out, R, P, n);
  return static_cast<int>(cudaGetLastError());
}

// Largest point count one launch takes (the staged cloud fills shared
// memory).
extern "C" int chamfer_max_points() { return kMaxPoints; }
