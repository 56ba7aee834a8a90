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
// coordinates, as the Pallas body builds them; the expansion form
// |x|^2 + |y|^2 - 2 x.y cancels badly for near points.
//
// What bounds it: operations. Each pair and direction evaluates n^2
// distances of 8 FLOP (3 sub, 3 mul, 2 add) plus a min, in f32 on the FMA
// pipes: at the protocol's n = 2000 one pair is 64 MFLOP against 48 KB of
// clouds, so memory traffic is negligible. K = 3 makes tensor cores useless
// and the f32 bar rules out TF32.
//
// Design (simple first): one direction D(a, b)[i, j] is the mean over a_i's
// points of the min over b_j's points, and the matrix is D(x, y) + D(y, x)^T.
// One launch covers both directions; a block takes one a-cloud and a tile of
// up to kTileB b-clouds. Each thread owns kPerThread points of a_i in
// registers with a running min each; the block stages one b-cloud at a time
// in shared memory as float4 (one broadcast 16-byte load per point) and
// every thread sweeps it. A block reduction gives the sum over a_i's points
// and one thread adds sum / n into out. Every out element receives exactly
// two additions onto the zeros the wrapper allocates, one per direction, so
// the result does not depend on their order (a + b == b + a in IEEE f32).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kPass = kThreads * kPerThread;  // a-points per sweep of the block
constexpr int kTileB = 16;                    // b-clouds per block
constexpr int kMaxSmem = 232448 - 1024;       // dynamic bytes: a Hopper block's 227 KB
                                              // less room for partial[]

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
chamfer_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int S, int R, int P, int n,
               long long blocks_fwd, int tiles_r, int tiles_s) {
  extern __shared__ float4 cloud[];  // [n] staged b-cloud (x, y, z, 0)
  __shared__ float partial[kThreads / 32];

  long long bid = blockIdx.x;
  const bool fwd = bid < blocks_fwd;
  if (!fwd) bid -= blocks_fwd;
  const int tiles = fwd ? tiles_r : tiles_s;
  const int i = static_cast<int>(bid / tiles);
  const int j0 = static_cast<int>(bid % tiles) * kTileB;
  const float* a = (fwd ? x : y) + static_cast<size_t>(i) * P * 3;
  const float* b_all = fwd ? y : x;
  const int nb = fwd ? R : S;
  const int j_end = min(j0 + kTileB, nb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int j = j0; j < j_end; ++j) {
    const float* b = b_all + static_cast<size_t>(j) * P * 3;
    __syncthreads();  // the previous b-cloud and partial[] are consumed
    for (int q = threadIdx.x; q < n; q += kThreads)
      cloud[q] = make_float4(b[3 * q], b[3 * q + 1], b[3 * q + 2], 0.f);
    __syncthreads();

    float total = 0.f;
    for (int p0 = 0; p0 < n; p0 += kPass) {
      float px[kPerThread], py[kPerThread], pz[kPerThread], m[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int p = p0 + k * kThreads + threadIdx.x;
        const bool ok = p < n;
        px[k] = ok ? a[3 * p] : 0.f;
        py[k] = ok ? a[3 * p + 1] : 0.f;
        pz[k] = ok ? a[3 * p + 2] : 0.f;
        m[k] = CUDART_INF_F;
      }
#pragma unroll 4
      for (int q = 0; q < n; ++q) {
        const float4 c = cloud[q];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const float dx = px[k] - c.x, dy = py[k] - c.y, dz = pz[k] - c.z;
          float d = dx * dx;
          d = d + dy * dy;
          d = d + dz * dz;
          m[k] = fminf(m[k], d);
        }
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if (p0 + k * kThreads + threadIdx.x < n) total += m[k];
    }

    total = warp_sum(total);
    if (lane == 0) partial[warp] = total;
    __syncthreads();
    if (warp == 0) {
      float v = lane < kThreads / 32 ? partial[lane] : 0.f;
      v = warp_sum(v);
      if (lane == 0) {
        const size_t idx = fwd ? static_cast<size_t>(i) * R + j : static_cast<size_t>(j) * R + i;
        atomicAdd(out + idx, v / static_cast<float>(n));
      }
    }
  }
}

}  // namespace

// x [S, P, 3], y [R, P, 3] f32 contiguous on the current device; out [S, R]
// f32, zero-filled by the caller. Returns a cudaError_t (0 on success).
extern "C" int chamfer_matrix_forward(const float* x, const float* y, float* out, int S,
                                      int R, int P, int n, void* stream) {
  if (S <= 0 || R <= 0 || n <= 0 || n > P) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float4) * static_cast<size_t>(n);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_r = (R + kTileB - 1) / kTileB;
  const int tiles_s = (S + kTileB - 1) / kTileB;
  const long long blocks_fwd = static_cast<long long>(S) * tiles_r;
  const long long blocks = blocks_fwd + static_cast<long long>(R) * tiles_s;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(chamfer_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chamfer_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(x, y, out, S, R, P, n, blocks_fwd,
                                                        tiles_r, tiles_s);
  return static_cast<int>(cudaGetLastError());
}

// Largest point count one launch takes (the staged cloud fills shared memory).
extern "C" int chamfer_max_points() { return kMaxSmem / static_cast<int>(sizeof(float4)); }
