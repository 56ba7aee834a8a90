// Masked multi-head set attention read straight from the fused QKV projection.
//
// Replaces the TPU kernels brepgen_tpu/kernels/attention.py:_packed_kernel
// (K1, entry fused_set_attention_packed -> _packed_forward) and
// _packed_flash_kernel (K2, entry _packed_flash_forward): K2 is K1's
// function with K/V streamed in chunks under an online softmax, which the
// TPU needed only because full-S K/V no longer fit VMEM. This kernel streams
// K/V that way at every S: its grid ((S+63)/64, H, B), its 64-bit row
// offsets and its shared memory do not depend on S, so the wrappers
// packed_attention (K1) and packed_flash_attention (K2, S > 8192) launch
// it both, each with its own launch count. It computes, for
// every batch b, head h and query row i:
//
//   out[b, i, h*D:(h+1)*D] = sum_j p_ij V_j / sum_j p_ij,
//   p_ij = exp(l_ij - max_j l_ij),  l_ij = (Q_i . K_j) * scale + bias_j,
//
// with Q, K, V the column blocks [0, W), [W, 2W), [2W, 3W) of qkv [B, S, 3W],
// scale = 1/sqrt(D), D = W/H, and bias_j = -1e9 where key j is padding
// (mask True), else 0. Logits, softmax and the accumulator are f32 for both
// input types (f32, bf16). A query row whose keys are all masked gets the
// uniform mean of V over the S real keys, as the plain version gives it.
//
// What bounds it on an H100: at the deepcad edge stages (B=16, S=1800,
// W=768, H=12) one call does 4*B*S^2*W = 159 GFLOP and must move about
// 354 MB in f32 (qkv read once, out written once), so it is bound by
// operations, not bytes: 2.4 ms at the 67 TFLOP/s of f32 outside the tensor
// cores. Logits never reach device memory; that is what the TPU kernel kept
// in VMEM too, and here the online (flash-style) softmax keeps them in
// registers. On K2's long sets (B=2, S=8400, W=768) the same count gives
// 433 GFLOP, 6.5 ms at that rate.
//
// Design, simple first: one block per (64-row query tile, head, batch), one
// query row per thread, its Q row and output accumulator in registers. K and V
// pass through shared memory in 64-key tiles (converted to f32 on load); all
// threads read the same K/V row at a time, so the shared loads broadcast.
// Scores are taken 16 keys at a time into registers with a running max and
// normaliser (initialised to -1e30 and 0). The ragged tail of S is masked
// here: keys past S are skipped, query rows past S are computed but not
// stored. No tensor cores, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block, one per thread
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int KC = 16;  // keys per online-softmax step
constexpr float MASK_BIAS = -1e9f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
packed_attention_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        T* __restrict__ out, int S, int W, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][D]
  float* Vs = Ks + BK * D;                      // [BK][D]
  float* bias = Vs + BK * D;                    // [BK]

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * BQ + tid;
  const long long rs = 3LL * W;  // element stride between token rows
  const T* base = qkv + (long long)b * S * rs + (long long)h * D;
  const uint8_t* mrow = mask + (long long)b * S;

  float q[D];
  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) { q[d] = 0.f; o[d] = 0.f; }
  if (row < S) {
    const T* qp = base + row * rs;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 v = load4(qp + d);
      q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
    }
  }
  float m = -1e30f;  // running max
  float l = 0.f;     // running normaliser

  constexpr int V4 = D / 4;  // float4 per K (or V) row
  for (int k0 = 0; k0 < S; k0 += BK) {
    const int nk = min(BK, S - k0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int it = 0; it < BK * V4 / BQ; ++it) {
      const int i = tid + it * BQ;
      const int r = i / V4;
      const int c = (i % V4) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (r < nk) {
        const T* p = base + (long long)(k0 + r) * rs + c;
        kv = load4(p + W);
        vv = load4(p + 2 * W);
      }
      *reinterpret_cast<float4*>(Ks + r * D + c) = kv;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vv;
    }
    bias[tid] = (tid < nk && mrow[k0 + tid]) ? MASK_BIAS : 0.f;  // BQ == BK
    __syncthreads();

    for (int c0 = 0; c0 < nk; c0 += KC) {
      float s[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) s[j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (c0 + j) * D + d);
          s[j] = fmaf(q[d], kv.x, s[j]);
          s[j] = fmaf(q[d + 1], kv.y, s[j]);
          s[j] = fmaf(q[d + 2], kv.z, s[j]);
          s[j] = fmaf(q[d + 3], kv.w, s[j]);
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        // scale, then bias, rounded apart as the plain version rounds them:
        // a fused multiply-add would move fully masked logits by an ulp of 1e9
        s[j] = (c0 + j < nk) ? __fadd_rn(__fmul_rn(s[j], scale), bias[c0 + j]) : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] *= corr;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (c0 + j) * D + d);
          o[d] = fmaf(p, vv.x, o[d]);
          o[d + 1] = fmaf(p, vv.y, o[d + 1]);
          o[d + 2] = fmaf(p, vv.z, o[d + 2]);
          o[d + 3] = fmaf(p, vv.w, o[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row < S) {
    T* op = out + ((long long)b * S + row) * W + (long long)h * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) store1(op + d, o[d] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* mask, void* out, int B, int S, int W, int H,
                   float scale, cudaStream_t stream) {
  const size_t smem = (2 * BK * D + BK) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  packed_attention_kernel<T, D><<<grid, BQ, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, W,
      scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3W] and out [B, S, W] contiguous, both of type dtype (0 = f32,
// 1 = bf16); mask [B, S] uint8 (1 = padding key). Launches on `stream` and
// does not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or type the kernel does not take.
extern "C" int packed_attention_forward(const void* qkv, const void* mask, void* out, int B,
                                        int S, int W, int H, int dtype, float scale,
                                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || W % H != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = W / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(qkv, mask, out, B, S, W, H, scale, st);
  if (dtype == 0 && D == 32) return (int)launch<float, 32>(qkv, mask, out, B, S, W, H, scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(qkv, mask, out, B, S, W, H, scale, st);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(qkv, mask, out, B, S, W, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
