// Backward of the masked multi-head set attention read from the fused QKV
// projection (the gradient of packed_attention.cu).
//
// Replaces the TPU kernel brepgen_tpu/kernels/attention.py:_packed_bwd_kernel
// (K5, entry _packed_backward, reached through the custom VJP _packed_bwd).
// For qkv [B, S, 3W] (Q, K, V the column blocks [0, W), [W, 2W), [2W, 3W)),
// the output gradient dO [B, S, W] and a key-padding mask, it computes per
// batch b and head h (D = W/H, s = 1/sqrt(D), bias_j = -1e9 at padding):
//
//   P  = softmax_j(l_ij),  l_ij = (Q_i . K_j) * s + bias_j
//   dV = P^T dO,  dP = dO V^T,  dL = P o (dP - rowsum(dP o P)),
//   dQ = s dL K,  dK = s dL^T Q,
//
// and writes dqkv [B, S, 3W] = [dQ | dK | dV] in the input type (f32 or
// bf16); all sums are f32. A query row whose keys are all masked has a
// uniform P over the S real keys, as the forward gives it.
//
// What bounds it on an H100: the five products need 10*B*S^2*W operations;
// at the deepcad edgez training shape (B=128, S=600, W=768) that is 354
// GFLOP, 5.3 ms at the 67 TFLOP/s of f32 outside the tensor cores, against
// about 0.7 GB to move in f32 (0.2 ms). So it is bound by operations.
//
// Design, simple first. The TPU kernel held full-S K and V and a [bq, S]
// probability block in VMEM and accumulated full-S dK/dV output blocks
// across a sequential grid of q-blocks; none of that fits a Hopper SM at
// S = 600-1500, W = 768, and the card's blocks run in no order. So two
// launches, with no atomics (deterministic):
//   (a) one block per (64-row query tile, head, batch): pass 1 streams the
//       key tiles and keeps each row's running max m, normaliser l and
//       t = sum_j exp(l_ij - m) dP_ij, so that Delta_i = rowsum(dP o P) =
//       t / l; it writes (m, 1/l, Delta) to a small f32 [B, H, S, 3]
//       buffer. Pass 2 streams the key tiles again and accumulates dQ.
//   (b) one block per (64-row key tile, head, batch): streams the query
//       tiles with their row statistics and accumulates dK and dV of its
//       key rows in f32 registers; each is written once.
// Each row belongs to two neighbouring threads that hold alternate 16-byte
// chunks of its D columns in registers (q, dO and the dQ accumulator in (a);
// k, v and the dK, dV accumulators in (b)), and add their partial dot
// products with one shuffle. The streamed tiles pass through shared memory
// as f32; one streamed row at a time is copied to registers (broadcast
// reads) and used for both of its dot products and its update, and the
// loop over streamed rows is not unrolled: unrolled over 8 rows, ptxas
// hoisted the shared loads into all 255 registers and spilled (544 ms at
// the training shape). Both launches form the logits in the same order, so
// they see the same P. No tensor cores, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;           // rows per block, two threads each
constexpr int THREADS = 2 * BR;  // threads per block
constexpr int BT = 64;           // rows per streamed shared-memory tile
constexpr float MASK_BIAS = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

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

// Column of element e of a thread's chunk i: chunks alternate between the
// two threads of a row (half 0 takes 0, 2, 4, ...; half 1 takes 1, 3, ...).
__device__ __forceinline__ int col(int i, int half) { return (2 * i + half) * 4; }

// This thread's half of row `r` of a [*, stride] matrix into registers.
template <typename T, int D>
__device__ __forceinline__ void load_half(float* dst, const T* p, int half) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const float4 v = load4(p + col(i, half));
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

// The first n rows of two matrices (row strides sa, sb) into shared
// [BT][D] f32 tiles; rows past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tiles(float* As, float* Bs, const T* a, long long sa,
                                           const T* b, long long sb, int n) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int it = 0; it < BT * V4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / V4;
    const int c = (idx % V4) * 4;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv = av;
    if (r < n) {
      av = load4(a + r * sa + c);
      bv = load4(b + r * sb + c);
    }
    *reinterpret_cast<float4*>(As + r * D + c) = av;
    *reinterpret_cast<float4*>(Bs + r * D + c) = bv;
  }
}

// This thread's chunks of shared row r of [BT][D] tile As into registers.
template <int D>
__device__ __forceinline__ void row_half(float* dst, const float* As, int r, int half) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(As + r * D + col(i, half));
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

// x . y over all D columns: each thread sums its D/2 columns in column
// order, then adds its partner's sum (the same value in both threads).
template <int D>
__device__ __forceinline__ float dot(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D / 2; ++d) s = fmaf(x[d], y[d], s);
  return s + __shfl_xor_sync(FULL, s, 1);
}

// acc += a * x over this thread's D/2 columns.
template <int D>
__device__ __forceinline__ void axpy(float* acc, float a, const float* x) {
#pragma unroll
  for (int d = 0; d < D / 2; ++d) acc[d] = fmaf(a, x[d], acc[d]);
}

// scale, then bias, rounded apart as the forward and the plain version round
// them: a fused multiply-add would move fully masked logits by an ulp of 1e9
__device__ __forceinline__ float logit(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// (a): row statistics and dQ for one 64-row query tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
          const uint8_t* __restrict__ mask, float* __restrict__ stats, T* __restrict__ dqkv,
          int S, int W, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BT][D]
  float* Vs = Ks + BT * D;                      // [BT][D]
  float* bias = Vs + BT * D;                    // [BT]

  constexpr int NH = D / 2;  // columns per thread
  const int half = threadIdx.x & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * BR + (threadIdx.x >> 1);
  const long long rs = 3LL * W;
  const T* base = qkv + (long long)b * S * rs + (long long)h * D;
  const T* gbase = dout + (long long)b * S * W + (long long)h * D;
  const uint8_t* mrow = mask + (long long)b * S;

  float q[NH], g[NH], acc[NH];
#pragma unroll
  for (int d = 0; d < NH; ++d) { q[d] = 0.f; g[d] = 0.f; acc[d] = 0.f; }
  if (row < S) {
    load_half<T, D>(q, base + row * rs, half);
    load_half<T, D>(g, gbase + (long long)row * W, half);
  }

  float m = -1e30f;  // running max
  float l = 0.f;     // running normaliser
  float t = 0.f;     // running sum_j exp(l_ij - m) dP_ij
  for (int pass = 0; pass < 2; ++pass) {
    const float inv_l = 1.f / l;
    const float delta = t * inv_l;
    for (int k0 = 0; k0 < S; k0 += BT) {
      const int nk = min(BT, S - k0);
      __syncthreads();  // the previous tile is consumed
      load_tiles<T, D>(Ks, Vs, base + k0 * rs + W, rs, base + k0 * rs + 2 * W, rs, nk);
      if (threadIdx.x < BT) {
        bias[threadIdx.x] = (threadIdx.x < nk && mrow[k0 + threadIdx.x]) ? MASK_BIAS : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < nk; ++j) {
        float kr[NH], vr[NH];
        row_half<D>(kr, Ks, j, half);
        row_half<D>(vr, Vs, j, half);
        const float lj = logit(dot<D>(q, kr), scale, bias[j]);
        const float dp = dot<D>(g, vr);
        if (pass == 0) {
          const float m_new = fmaxf(m, lj);
          const float corr = expf(m - m_new);
          const float p = expf(lj - m_new);
          l = fmaf(l, corr, p);
          t = fmaf(t, corr, p * dp);
          m = m_new;
        } else {
          const float p = expf(lj - m) * inv_l;
          axpy<D>(acc, p * (dp - delta), kr);
        }
      }
    }
    if (pass == 0 && row < S && half == 0) {
      float* st = stats + (((long long)b * H + h) * S + row) * 3;
      st[0] = m;
      st[1] = 1.f / l;
      st[2] = t * (1.f / l);
    }
  }

  if (row < S) {
    T* op = dqkv + ((long long)b * S + row) * rs + (long long)h * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) store1(op + col(i, half) + e, acc[4 * i + e] * scale);
    }
  }
}

// (b): dK and dV for one 64-row key tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
           const uint8_t* __restrict__ mask, const float* __restrict__ stats,
           T* __restrict__ dqkv, int S, int W, int H, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BT][D]
  float* Gs = Qs + BT * D;                      // [BT][D]
  float* st = Gs + BT * D;                      // [BT][3]: m, 1/l, Delta

  constexpr int NH = D / 2;
  const int half = threadIdx.x & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * BR + (threadIdx.x >> 1);  // key row
  const long long rs = 3LL * W;
  const T* base = qkv + (long long)b * S * rs + (long long)h * D;
  const T* gbase = dout + (long long)b * S * W + (long long)h * D;
  const float* sbase = stats + ((long long)b * H + h) * S * 3;

  float k[NH], v[NH], dk[NH], dv[NH];
#pragma unroll
  for (int d = 0; d < NH; ++d) { k[d] = 0.f; v[d] = 0.f; dk[d] = 0.f; dv[d] = 0.f; }
  float bias = 0.f;
  if (row < S) {
    load_half<T, D>(k, base + row * rs + W, half);
    load_half<T, D>(v, base + row * rs + 2 * W, half);
    bias = mask[(long long)b * S + row] ? MASK_BIAS : 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += BT) {
    const int nq = min(BT, S - q0);
    __syncthreads();  // the previous tile is consumed
    load_tiles<T, D>(Qs, Gs, base + q0 * rs, rs, gbase + (long long)q0 * W, W, nq);
    for (int i = threadIdx.x; i < 3 * nq; i += THREADS) st[i] = sbase[(long long)q0 * 3 + i];
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < nq; ++i) {
      float qr[NH], gr[NH];
      row_half<D>(qr, Qs, i, half);
      row_half<D>(gr, Gs, i, half);
      const float p = expf(logit(dot<D>(k, qr), scale, bias) - st[3 * i]) * st[3 * i + 1];
      const float dl = p * (dot<D>(v, gr) - st[3 * i + 2]);
      axpy<D>(dv, p, gr);
      axpy<D>(dk, dl, qr);
    }
  }

  if (row < S) {
    T* op = dqkv + ((long long)b * S + row) * rs + (long long)h * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store1(op + W + col(c, half) + e, dk[4 * c + e] * scale);
        store1(op + 2 * W + col(c, half) + e, dv[4 * c + e]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* dout, const void* mask, void* stats, void* dqkv,
                   int B, int S, int W, int H, float scale, cudaStream_t stream) {
  const size_t smem_a = (2 * BT * D + BT) * sizeof(float);
  const size_t smem_b = (2 * BT * D + 3 * BT) * sizeof(float);
  if (smem_b > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BR - 1) / BR, H, B);
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* st = static_cast<float*>(stats);
  T* out = static_cast<T*>(dqkv);
  dq_kernel<T, D><<<grid, THREADS, smem_a, stream>>>(x, g, m, st, out, S, W, H, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<T, D><<<grid, THREADS, smem_b, stream>>>(x, g, m, st, out, S, W, H, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3W], dout [B, S, W] and dqkv [B, S, 3W] contiguous, all of type
// dtype (0 = f32, 1 = bf16); mask [B, S] uint8 (1 = padding key); stats a
// scratch f32 [B, H, S, 3]. Launches (a) then (b) on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or type the kernels do not take.
extern "C" int packed_attention_backward(const void* qkv, const void* dout, const void* mask,
                                         void* stats, void* dqkv, int B, int S, int W, int H,
                                         int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || W % H != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = W / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(qkv, dout, mask, stats, dqkv, B, S, W, H, scale, st);
  if (dtype == 0 && D == 32)
    return (int)launch<float, 32>(qkv, dout, mask, stats, dqkv, B, S, W, H, scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(qkv, dout, mask, stats, dqkv, B, S, W, H, scale, st);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(qkv, dout, mask, stats, dqkv, B, S, W, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
