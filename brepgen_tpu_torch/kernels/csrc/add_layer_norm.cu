// Residual add and LayerNorm in one pass over the token rows: the
// denoisers' pre-LN norms with the residual add in front of them, and the
// MLP embedders' LayerNorm with the SiLU after it (nn/layers.py:LayerNorm).
//
// The JAX package has no TPU kernel here (XLA fuses the add, the casts and
// the norm). For x [rows, W], an optional delta of the same shape and type,
// f32 weight and bias [W], it computes for every row:
//
//   s = round(x + delta)                    (x itself without delta)
//   y = round((s - mean(s)) * rsqrt(var(s) + eps) * weight + bias)
//   y = round(silu(y))                      (with silu)
//
// where round() rounds an f32 value to the input type (f32 or bf16): s is
// the value the separate bf16 add gives, bit for bit, and the statistics are
// taken from it in f32, as F.layer_norm on s.float() takes them. It writes s
// (the new residual stream; skipped where the caller needs no sum) and y.
//
// What bounds it: bytes. A 768-wide row needs a few operations an element
// against reading x and delta and writing s and y once: 4 * rows * W
// * (element bytes), 177 MB in bf16 at 16 x 1800 tokens. The plain path it
// replaces reads and writes the stream four more times: a bf16 add, the
// cast of s to f32, F.layer_norm in f32 and the cast of y back.
//
// Design. One warp owns a row; each lane owns 16-byte chunks of it, lane,
// lane + 32, ..., so a warp's load reads 512 contiguous bytes. Every chunk
// of x and delta is loaded at once (3 + 3 loads of 16 bytes a lane at W 768
// in bf16, 6 + 6 in f32), s stays in registers, and the mean and the
// variance about it are warp sums by shuffles: no shared memory, no atomics,
// each input read once and each output written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxChunks = 8;  // chunks a lane: W <= 8 * 32 * (elements a chunk)

// 16 bytes of a row: the elements a lane owns, unpacked to f32, and the
// rounding of an f32 value to the type
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const float* p, float (&x)[kElems]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
  }
  __device__ static void store(float* p, const float (&x)[kElems]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&x)[kElems]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&x)[kElems]) {
    uint4 r;
    uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                      const float* __restrict__ weight, const float* __restrict__ bias,
                      T* __restrict__ sum_out, T* __restrict__ y_out, long long rows, int W,
                      float eps, int silu) {
  using C = Chunk<T>;
  constexpr int E = C::kElems;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // a warp leaves whole: its lanes share `row`
  const int lane = threadIdx.x & 31;
  const int chunks = W / E;
  const long long base = row * W;

  float s[kChunks][E];
  float d[kChunks][E];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      C::load(x + base + c * E, s[i]);
      if (delta != nullptr) C::load(delta + base + c * E, d[i]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (delta != nullptr) s[i][e] = C::round(s[i][e] + d[i][e]);
        sum += s[i][e];
      }
      if (sum_out != nullptr) C::store(sum_out + base + (lane + 32 * i) * E, s[i]);
    }
  }
  const float mean = warp_sum(sum) / W;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float c = s[i][e] - mean;
        sq = fmaf(c, c, sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / W + eps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      float y[E];
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 g = *reinterpret_cast<const float4*>(weight + c * E + e);
        const float4 b = *reinterpret_cast<const float4*>(bias + c * E + e);
        const float gs[4] = {g.x, g.y, g.z, g.w}, bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = C::round((s[i][e + j] - mean) * rstd * gs[j] + bs[j]);
          if (silu) v = C::round(v / (1.f + expf(-v)));
          y[e + j] = v;
        }
      }
      C::store(y_out + base + c * E, y);
    }
  }
}

template <typename T, int kChunks>
cudaError_t launch(const void* x, const void* delta, const float* weight, const float* bias,
                   void* sum_out, void* y_out, long long rows, int W, float eps, int silu,
                   cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  add_layer_norm_kernel<T, kChunks><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta), weight, bias,
      static_cast<T*>(sum_out), static_cast<T*>(y_out), rows, W, eps, silu);
  return cudaGetLastError();
}

// the instance whose chunks a lane cover W
template <typename T, int kChunks = 1>
cudaError_t dispatch(const void* x, const void* delta, const float* weight, const float* bias,
                     void* sum_out, void* y_out, long long rows, int W, float eps, int silu,
                     cudaStream_t stream) {
  if (W <= kChunks * 32 * Chunk<T>::kElems)
    return launch<T, kChunks>(x, delta, weight, bias, sum_out, y_out, rows, W, eps, silu,
                              stream);
  if constexpr (kChunks < kMaxChunks)
    return dispatch<T, kChunks + 1>(x, delta, weight, bias, sum_out, y_out, rows, W, eps, silu,
                                    stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, delta (or null), sum_out (or null), y_out: [rows, W], contiguous and
// 16-byte aligned; weight, bias: f32 [W], 16-byte aligned. dtype 0 is f32,
// 1 bf16; W a multiple of 8, at most 8 * 32 * (16 / element bytes). Launches
// on `stream` and allocates nothing; rows = 0 launches nothing.
extern "C" int add_layer_norm_forward(const void* x, const void* delta, const void* weight,
                                      const void* bias, void* sum_out, void* y_out,
                                      long long rows, int W, int dtype, float eps, int silu,
                                      void* stream) {
  if (rows < 0 || W <= 0 || W % 8 != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return (int)dispatch<float>(x, delta, g, b, sum_out, y_out, rows, W, eps, silu, st);
    case 1:
      return (int)dispatch<__nv_bfloat16>(x, delta, g, b, sum_out, y_out, rows, W, eps, silu,
                                          st);
    default: return (int)cudaErrorInvalidValue;
  }
}
