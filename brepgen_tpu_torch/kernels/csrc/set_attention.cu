// Masked set attention per (batch, head) on split heads, on the tensor cores.
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
// What bounds it on an H100: at the ABC edge stages (B=16, S=4000, W=H*D=768,
// H=12) one call needs 4*B*S^2*W = 786 GFLOP against about 0.8 GB to move in
// f32, so it is bound by operations: 4.77 ms at the 3xTF32 rate (495/3
// TFLOP/s), 0.79 ms in bf16 (989 TFLOP/s).
//
// Design (FlashAttention-2's shape, by hand; mma_tile.cuh has the pieces).
// One block of 4 warps per (64-row query tile, b*H + h); each warp owns 16
// query rows. Each head's K and V are one contiguous [S, D] slab, so 64-key
// tiles come straight from global memory by 16-byte cp.async, double-
// buffered in padded shared tiles (the next tile's copy overlaps this tile's
// products). Per key tile a warp forms its 16 x 64 logits with mma.sync into
// f32 accumulators, rounds scale and bias apart, runs the online softmax in
// registers (row max and sum across the quad of lanes that shares a row),
// and feeds P from the accumulators as the A operand of P V. The tile's
// P V goes into fresh accumulators and then o = o * corr + P V with one
// rounding to nearest (the tensor cores truncate as they accumulate). Keys
// past S get a bias of -inf (excluded, not masked); query rows past S are
// computed on zero-filled rows and not stored.
// Operations executed: f32 takes the two products in 3xTF32 (3 tf32 mma
// each); bf16 takes Q K^T once and P V twice (P split into a bf16 hi + lo
// pair, see mma_tile.cuh), 1.5x the bound's bf16 operations.
// Shared memory: Q, and K, V twice: 5 tiles of 64 x (D + 16 bytes), 85 KB in
// f32 (two blocks an SM) and 45 KB in bf16 at D = 64. Registers: 32 logit,
// D/2 output and D/2 tile accumulators a thread, 166 (f32) and 133 (bf16) at
// D = 64 with no spills; chip_smoke.py prints ptxas's counts.

#include <math.h>

#include "mma_tile.cuh"

namespace {

constexpr int BQ = tc::TILE;  // query rows per block
constexpr int BK = tc::TILE;  // keys per shared tile
constexpr int NT = BK / 8;    // n8 tiles of logits per key tile
constexpr float MASK_BIAS = -1e9f;

template <typename T, int D>
constexpr size_t smem_bytes() {
  return 5 * (size_t)BQ * tc::ld<T, D>() * sizeof(T) + 2 * BK * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
set_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int S,
                     float scale) {
  using Op = tc::Op<T>;
  constexpr int L = tc::ld<T, D>();
  constexpr int KS = Op::KS;
  extern __shared__ uint4 smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BQ][L]
  T* Ks = Qs + BQ * L;                 // [2][BK][L]
  T* Vs = Ks + 2 * BK * L;             // [2][BK][L]
  float* bias = reinterpret_cast<float*>(Vs + 2 * BK * L);  // [2][BK]

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q0 = blockIdx.x * BQ;
  const long long head = (long long)blockIdx.y * S * D;  // this head's [S, D] slab
  const T* kh = k + head;
  const T* vh = v + head;
  const uint8_t* mrow = mask + (long long)(blockIdx.y / H) * S;

  auto load_kv = [&](int k0, int buf) {
    tc::load_tile<T, D>(Ks + buf * BK * L, kh + (long long)k0 * D, D, S - k0);
    tc::load_tile<T, D>(Vs + buf * BK * L, vh + (long long)k0 * D, D, S - k0);
    if (threadIdx.x < BK) {
      const int key = k0 + threadIdx.x;
      bias[buf * BK + threadIdx.x] = key < S ? (mrow[key] ? MASK_BIAS : 0.f) : -INFINITY;
    }
  };
  tc::load_tile<T, D>(Qs, q + head + (long long)q0 * D, D, S - q0);
  load_kv(0, 0);
  tc::cp_commit();

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};        // this lane's part of their running sums

  const int tiles = (S + BK - 1) / BK;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {
      load_kv((it + 1) * BK, buf ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * BK * L;
    const T* Vt = Vs + buf * BK * L;
    const float* bt = bias + buf * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += KS) {
      const typename Op::A a = Op::template load_a<L>(Qs, warp * 16, k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) Op::mma(s[j], a, Op::template load_b_nk<L>(Kt, j * 8, k0));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = tc::logit(s[j][e], scale, bt[j * 8 + 2 * t + (e & 1)]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], tc::quad_max(mx[r]));
      corr[r] = tc::exp_(m[r] - m_new);
      l[r] *= corr[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = tc::exp_(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }

    // this tile's P V into fresh accumulators, then o = o * corr + P V with
    // one rounding to nearest: the tensor cores truncate as they accumulate,
    // which over the 4000 keys of a row would drift past the f32 bar
    float pv[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) pv[d][0] = pv[d][1] = pv[d][2] = pv[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / KS; ++kk) {
      const typename Op::AP p = Op::a_from_c(s, kk);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        Op::mma(pv[d], p, Op::template load_b_kn<L>(Vt, kk * KS, d * 8));
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], corr[e >> 1], pv[d][e]);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const float inv = 1.f / tc::quad_sum(l[r]);
    if (row < S) {
      T* op = out + head + (long long)row * D + 2 * t;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) tc::store2(op + d * 8, o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int H, int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        set_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  set_attention_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
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

// Dynamic shared memory of one block for head width D and dtype, in bytes
// (0 for a combination the kernel does not take).
extern "C" int set_attention_smem_bytes(int D, int dtype) {
  if (dtype == 0 && D == 64) return (int)smem_bytes<float, 64>();
  if (dtype == 0 && D == 32) return (int)smem_bytes<float, 32>();
  if (dtype == 1 && D == 64) return (int)smem_bytes<__nv_bfloat16, 64>();
  if (dtype == 1 && D == 32) return (int)smem_bytes<__nv_bfloat16, 32>();
  return 0;
}
