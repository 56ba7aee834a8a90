// Multi-head attention over short token sets at head width 32: the edge
// VAE's self-attention core (nn/vae1d.py:SelfAttention1D).
//
// The JAX package has no TPU kernel here (XLA fuses its einsums). For q, k, v
// [N, L, C] as the three linears write them, C = H * 32, it computes for
// every set n, head h and query token i:
//
//   out[n, i, h*32 + d] = sum_j p_ij v[n, j, h*32 + d] / sum_j p_ij,
//   p_ij = exp(l_ij - max_j l_ij),  l_ij = (q[n, i, h] . k[n, j, h]) * scale,
//
// in the same [N, L, C] layout, for the output projection. Logits, softmax
// and the accumulator are f32 for both input types (f32, bf16); the output
// is rounded once to the input type. L is at most kMaxLen = 4: every
// attention of the edge VAE runs after its three downsamplings, on 4 tokens;
// other lengths keep the module's einsums.
//
// What bounds it: bytes. At the edge VAE's mid block (L = 4, H = 16) a
// (set, head) pair needs 2 * L^2 * 32 = 1024 multiply-adds against 4 * L * 32
// elements to move, so the kernel is bound by reading q, k, v and writing
// out once: 4 * N * L * C * (element bytes), 1.26 GB in bf16 at N = 76,800.
// The batched einsums it replaces give each 4 x 32 . 32 x 4 product a GEMM
// tile of its own, and copy the heads apart and back.
//
// Design. A group of kLanes lanes (4 in bf16, 8 in f32; aligned in the warp)
// owns one (set, head) pair; each lane owns 16 bytes of the head's 32
// channels in every token, so one load instruction of a warp reads 512
// contiguous bytes of a token row (whole rows at H = 16 in bf16). Each lane
// loads its part of every Q, K and V row at once, into registers as loaded
// (bf16 pairs unpacked at use): 12 loads of 16 bytes in flight per lane at
// L = 4. The lanes of a group add their partial dot products by shuffles;
// each then holds every logit of a query row and forms the softmax itself.
// The (set, head) pairs of a block are consecutive, so the output is written
// as it is read: 512 contiguous bytes a warp and store. No shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kMaxLen = 4;
constexpr int kThreads = 256;

// 16 bytes of one token row: the elements a lane owns, and how to unpack them
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float at(int e) const {
    return e == 0 ? raw.x : e == 1 ? raw.y : e == 2 ? raw.z : raw.w;
  }
  __device__ static void store(float* p, const float (&x)[kElems]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float at(int e) const {
    const uint32_t w = e < 2 ? raw.x : e < 4 ? raw.y : e < 6 ? raw.z : raw.w;
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
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
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
vae_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, long long pairs, int L,
                     int H, float scale) {
  constexpr int E = Chunk<T>::kElems;
  constexpr int kLanes = kHeadDim / E;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long pair = t / kLanes;
  if (pair >= pairs) return;  // a group leaves whole: its lanes share `pair`
  const int lane = threadIdx.x & 31;
  const unsigned mask = ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));
  const long long set = pair / H;
  const long long C = (long long)H * kHeadDim;
  // this lane's 16 bytes of token 0; token j lies j * C elements further
  const long long base = set * L * C + (pair - set * H) * kHeadDim + (lane & (kLanes - 1)) * E;

  // every row of the pair in flight at once
  Chunk<T> qc[kMaxLen], kc[kMaxLen], vc[kMaxLen];
#pragma unroll
  for (int j = 0; j < kMaxLen; ++j) {
    if (j < L) {
      qc[j].load(q + base + j * C);
      kc[j].load(k + base + j * C);
      vc[j].load(v + base + j * C);
    }
  }
  // then the query rows, each stored as it is done
#pragma unroll
  for (int i = 0; i < kMaxLen; ++i) {
    if (i >= L) break;
    float qv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) qv[e] = qc[i].at(e);
    float s[kMaxLen];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) {
      if (j < L) {  // L is the whole grid's, so a group's lanes shuffle together
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kc[j].at(e), dot);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(mask, dot, off);
        s[j] = dot * scale;
        m = fmaxf(m, s[j]);
      }
    }
    float den = 0.f, acc[E] = {};
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) {
      if (j < L) {
        const float p = expf(s[j] - m);
        den += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vc[j].at(e), acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = acc[e] / den;
    Chunk<T>::store(out + base + i * C, acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, long long N, int L,
                   int H, float scale, cudaStream_t stream) {
  constexpr int kLanes = kHeadDim / Chunk<T>::kElems;
  const long long pairs = N * H;
  const long long blocks = (pairs * kLanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  vae_attention_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), pairs, L, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [N, L, H * 32], contiguous and 16-byte aligned; dtype 0 is
// f32, 1 bf16. Launches on `stream` and allocates nothing; N = 0 launches
// nothing.
extern "C" int vae_attention_forward(const void* q, const void* k, const void* v, void* out,
                                     long long N, int L, int H, int dtype, float scale,
                                     void* stream) {
  if (N < 0 || L <= 0 || L > kMaxLen || H <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(q, k, v, out, N, L, H, scale, st);
    case 1: return (int)launch<__nv_bfloat16>(q, k, v, out, N, L, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
