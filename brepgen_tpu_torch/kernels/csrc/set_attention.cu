// Masked set attention per (batch, head) on split heads.
//
// Replaces the TPU kernel brepgen_tpu/kernels/attention.py:_attn_kernel
// (entry fused_set_attention -> _forward). For q, k, v [B, H, S, D] it
// computes, for every batch b, head h and query row i:
//
//   out[b, h, i] = sum_j p_ij v[b, h, j] / sum_j p_ij,
//   p_ij = exp(l_ij - max_j l_ij),  l_ij = (q[b, h, i] . k[b, h, j]) * scale + bias_j,
//
// with scale = 1/sqrt(D) of the true D and bias_j = -1e9 where key j is
// padding (mask True), else 0. Logits, softmax and the accumulator are f32
// for both input types (f32, bf16). A query row whose keys are all masked
// gets the uniform mean of V over the S real keys, as the plain version
// gives it (the TPU kernel, which pads S to its block, averages over the
// padded length instead).
//
// What bounds it on an H100: at the ABC edge stages in f32 (B=16, S=4000,
// W=H*D=768, H=12) one call does 4*B*S^2*W = 786 GFLOP and must move about
// 0.8 GB (q, k, v read once, out written once), so it is bound by
// operations: 11.7 ms at the 67 TFLOP/s of f32 outside the tensor cores.
//
// Design, simple first. The TPU kernel held a whole [block_q, S] logit row
// in VMEM; at S=4000 such a tile is 1 MB, more than a block's registers and
// shared memory hold, so this kernel uses the online (flash-style) softmax
// of packed_attention.cu instead. One block per (64-row query tile, b*H+h),
// one query row per thread, its q row and output accumulator in registers.
// The per-head layout makes each head's K and V one contiguous [S, D] slab:
// 64-key tiles are staged in shared memory (converted to f32 on load) with
// fully coalesced 16-byte loads; all threads read the same K/V row at a
// time, so the shared loads broadcast. Scores are taken 16 keys at a time
// with a running max and normaliser (initialised to -1e30 and 0). The
// ragged tail of S is masked here: keys past S are skipped, query rows past
// S are computed but not stored. No D padding (that was the TPU's 128-lane
// width), no tensor cores, TMA or wgmma yet.

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
set_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int S,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][D]
  float* Vs = Ks + BK * D;                      // [BK][D]
  float* bias = Vs + BK * D;                    // [BK]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;  // b * H + h
  const int row = blockIdx.x * BQ + tid;
  const long long head = (long long)bh * S * D;  // offset of this head's [S, D] slab
  const T* kh = k + head;
  const T* vh = v + head;
  const uint8_t* mrow = mask + (long long)(bh / H) * S;

  float qr[D];
  float o[D];
#pragma unroll
  for (int d = 0; d < D; ++d) { qr[d] = 0.f; o[d] = 0.f; }
  if (row < S) {
    const T* qp = q + head + (long long)row * D;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 x = load4(qp + d);
      qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    }
  }
  float m = -1e30f;  // running max
  float l = 0.f;     // running normaliser

  constexpr int V4 = D / 4;  // float4 per K (or V) row
  for (int k0 = 0; k0 < S; k0 += BK) {
    const int nk = min(BK, S - k0);
    __syncthreads();  // the previous tile is consumed
    // the tile is nk contiguous rows of D: thread i takes float4 i, i + BQ, ...
#pragma unroll
    for (int it = 0; it < BK * V4 / BQ; ++it) {
      const int i = tid + it * BQ;
      const int r = i / V4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (r < nk) {
        const long long off = (long long)k0 * D + 4LL * i;
        kv = load4(kh + off);
        vv = load4(vh + off);
      }
      *reinterpret_cast<float4*>(Ks + 4 * i) = kv;
      *reinterpret_cast<float4*>(Vs + 4 * i) = vv;
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
          s[j] = fmaf(qr[d], kv.x, s[j]);
          s[j] = fmaf(qr[d + 1], kv.y, s[j]);
          s[j] = fmaf(qr[d + 2], kv.z, s[j]);
          s[j] = fmaf(qr[d + 3], kv.w, s[j]);
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
    T* op = out + head + (long long)row * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) store1(op + d, o[d] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int H, int S, float scale, cudaStream_t stream) {
  const size_t smem = (2 * BK * D + BK) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        set_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  set_attention_kernel<T, D><<<grid, BQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, S, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and out [B, H, S, D] contiguous, all of type dtype (0 = f32,
// 1 = bf16); mask [B, S] uint8 (1 = padding key). Launches on `stream` and
// does not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or type the kernel does not take.
extern "C" int set_attention_forward(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int B, int H, int S, int D,
                                     int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, mask, out, B, H, S, scale, st);
  if (dtype == 0 && D == 32)
    return (int)launch<float, 32>(q, k, v, mask, out, B, H, S, scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, mask, out, B, H, S, scale, st);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(q, k, v, mask, out, B, H, S, scale, st);
  return (int)cudaErrorInvalidValue;
}
