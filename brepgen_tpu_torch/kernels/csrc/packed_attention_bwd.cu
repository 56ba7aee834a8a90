// Backward of the masked multi-head set attention read from the fused QKV
// projection (the gradient of packed_attention.cu), on the tensor cores.
//
// Replaces the TPU kernel brepgen_tpu/kernels/attention.py:_packed_bwd_kernel
// (K5, entry _packed_backward, reached through the custom VJP _packed_bwd).
// For qkv [B, S, 3W] (Q, K, V the column blocks [0, W), [W, 2W), [2W, 3W)),
// the output gradient dO [B, S, W] and a key-padding mask, it computes per
// batch b and head h (D = W/H, s = 1/sqrt(D), bias_j = -1e9 at padding):
//
//   P  = softmax_j(l_ij),  l_ij = (Q_i . K_j) * s + bias_j
//   dV = P^T dO,  dP = dO V^T,  dL = P o (dP - Delta),  Delta_i = rowsum(dP o P)_i,
//   dQ = s dL K,  dK = s dL^T Q,
//
// and writes dqkv [B, S, 3W] = [dQ | dK | dV] in the input type (f32 or
// bf16); all sums are f32. A query row whose keys are all masked has a
// uniform P over the S real keys, as the forward gives it.
//
// What bounds it on an H100: the five products need 10*B*S^2*W operations;
// at the deepcad edgez training shape (B=128, S=600, W=768) that is 354
// GFLOP: 2.15 ms at the 3xTF32 rate (495/3 TFLOP/s) in f32, 0.36 ms in bf16
// (989 TFLOP/s), against about 0.7 GB to move in f32 (0.2 ms). So it is
// bound by operations.
//
// Design (FlashAttention-2's backward, by hand; mma_tile.cuh has the tiles,
// the fragment loads and the precision scheme). Two launches, no atomics,
// so it is deterministic. Blocks of 4 warps, 16 rows per warp, 64-row tiles
// streamed through two shared buffers by 16-byte cp.async.
//   (a) one block per (64-row query tile, head, batch). In f32, Delta_i =
//       rowsum(dO_i o O_i) from the forward's output O (it equals
//       rowsum(dP o P)), and pass 1 streams the key tiles for the logits
//       alone, keeping each row's running max m and sum l; in bf16 (a bf16
//       O would move Delta too far) pass 1 also forms dP and takes Delta =
//       sum_j exp(l_ij - m) dP_ij / l online. Then it writes (m, 1/l, Delta)
//       to a small f32 [B, H, S, 3] buffer. Pass 2 streams K and V again:
//       logits and dP = dO V^T by mma, dS = P o (dP - Delta) in registers,
//       and dQ += dS K with dS as the A operand straight from the
//       accumulators.
//   (b) one block per (64-row key tile, head, batch), its K and V rows in
//       shared memory: streams the query tiles with their row statistics,
//       32 queries at a time (fewer registers); the warp forms S^T = K Q^T
//       and dP^T = V dO^T with the 3xTF32 cross terms in the other order, so
//       that they equal (a)'s S and dP bit for bit (P matches the row
//       statistics; dS of a row that attends to one key is exactly 0), then
//       P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q.
// The sums over S rows (dQ, dK, dV) take each k step into fresh registers
// and add it with one rounding to nearest (the tensor cores truncate as they
// accumulate), and f32 dK, dV are flushed into dqkv every 8 query tiles, so
// that a sum of 1500 rows near 150 stays within the f32 bar.
// What bounds it: operations, as above. Operations executed, in units of
// 2*B*S^2*W (one product; the bound counts 5): in f32, 4 in (a) (the
// logits twice, dP, dS K) and 4 in (b), so 8, or 16*B*S^2*W; in bf16, with
// dP in pass 1 too, 9 (18*B*S^2*W). In f32 each product is 3 tf32 mma; in bf16 the
// products whose A operand is P or dS (dS K, P^T dO, dS^T Q) take two (the
// hi + lo pair), 12 bf16 products in all. Keys past S get a logit of -inf
// (excluded, not masked); rows past S are computed on zero-filled tiles and
// not stored.
// Shared memory: 6 tiles of 64 x (D + 16 bytes) per kernel, 103 KB in f32
// (two blocks an SM) and 55 KB in bf16 at D = 64. Registers: the
// accumulators of a 16 x 64 (a) or two 16 x 32 (b) products and of the
// D-wide outputs; at D = 64 f32 both kernels reach 255 with small spills,
// bf16 168 (a) and 251 (b); chip_smoke.py prints ptxas's counts.

#include <math.h>

#include "mma_tile.cuh"

namespace {

constexpr int BT = tc::TILE;  // rows per tile, streamed or owned
constexpr int NT = BT / 8;    // n8 tiles of a 16 x 64 product
constexpr float MASK_BIAS = -1e9f;

template <typename T, int D>
constexpr size_t smem_a() {
  return 6 * (size_t)BT * tc::ld<T, D>() * sizeof(T) + 3 * BT * sizeof(float);
}
template <typename T, int D>
constexpr size_t smem_b() {
  return 6 * (size_t)BT * tc::ld<T, D>() * sizeof(T) + 2 * 3 * BT * sizeof(float);
}


// c[j] = X Y^T over D for the warp's 16 rows r0.. of X (shared [*][L])
// against the N rows of Y (shared [N][L]).
template <typename T, int D, int N, bool SWAP = false>
__device__ __forceinline__ void product_nt(float (*c)[4], const T* X, int r0, const T* Y) {
  using Op = tc::Op<T>;
  constexpr int L = tc::ld<T, D>();
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += Op::KS) {
    const typename Op::A a = Op::template load_a<L>(X, r0, k0);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (SWAP)
        Op::mma_swapped(c[j], a, Op::template load_b_nk<L>(Y, j * 8, k0));
      else
        Op::mma(c[j], a, Op::template load_b_nk<L>(Y, j * 8, k0));
    }
  }
}

// acc[d] += C Y over the N rows of Y (shared [N][L]), C the warp's
// 16 x N accumulators (P or dS). These are the sums over S rows (dQ, dK,
// dV), so they are taken in levels, each add rounded to nearest: each k
// step into fresh accumulators, those into acc (and f32 dK, dV flush acc
// into dqkv every few tiles, in dkv_kernel).
template <typename T, int D, int N>
__device__ __forceinline__ void product_cn(float (*acc)[4], const float (*c)[4], const T* Y) {
  using Op = tc::Op<T>;
  constexpr int L = tc::ld<T, D>();
  float part[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) part[d][0] = part[d][1] = part[d][2] = part[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N / Op::KS; ++kk) {
    const typename Op::AP a = Op::a_from_c(c, kk);
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      Op::mma_rn(part[d], a, Op::template load_b_kn<L>(Y, kk * Op::KS, d * 8));
  }
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] += part[d][e];
  }
}

// (a): row statistics and dQ for one 64-row query tile of one head. fwd is
// the forward's output in f32 and null in bf16 (Delta online). It is tested
// at run time: with the test folded at compile time nvcc allocates the f32
// kernel's registers otherwise, and it ran slower on the card.
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const T* __restrict__ fwd,
          const uint8_t* __restrict__ mask, float* __restrict__ stats, T* __restrict__ dqkv,
          int S, int W, int H, float scale) {
  constexpr int L = tc::ld<T, D>();
  extern __shared__ uint4 smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [BT][L]
  T* Gs = Qs + BT * L;                 // [BT][L] dO
  T* Ks = Gs + BT * L;                 // [2][BT][L]
  T* Vs = Ks + 2 * BT * L;             // [2][BT][L]
  float* bias = reinterpret_cast<float*>(Vs + 2 * BT * L);  // [2][BT]
  float* delta = bias + 2 * BT;                             // [BT]

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BT;
  const long long rs = 3LL * W;
  const T* base = qkv + (long long)b * S * rs + (long long)h * D;
  const long long gofs = (long long)b * S * W + (long long)h * D;
  const uint8_t* mrow = mask + (long long)b * S;

  // Delta from the forward's output: O rows staged in K's first buffer
  tc::load_tile<T, D>(Qs, base + q0 * rs, rs, S - q0);
  tc::load_tile<T, D>(Gs, dout + gofs + (long long)q0 * W, W, S - q0);
  if (fwd) tc::load_tile<T, D>(Ks, fwd + gofs + (long long)q0 * W, W, S - q0);
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();
  if (fwd) {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;  // two threads per row
    float sum = 0.f;
#pragma unroll
    for (int d = half * D / 2; d < (half + 1) * D / 2; ++d)
      sum = fmaf(tc::to_float(Gs[r * L + d]), tc::to_float(Ks[r * L + d]), sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) delta[r] = sum;
    __syncthreads();
  }

  auto load_kv = [&](int k0, int buf, bool with_v) {
    tc::load_tile<T, D>(Ks + buf * BT * L, base + k0 * rs + W, rs, S - k0);
    if (with_v) tc::load_tile<T, D>(Vs + buf * BT * L, base + k0 * rs + 2 * W, rs, S - k0);
    if (threadIdx.x < BT) {
      const int key = k0 + threadIdx.x;
      bias[buf * BT + threadIdx.x] = key < S ? (mrow[key] ? MASK_BIAS : 0.f) : -INFINITY;
    }
  };

  float m[2] = {-1e30f, -1e30f};  // rows g, g + 8: running max
  float l[2] = {0.f, 0.f};        // this lane's part of the running sum
  float tsum[2] = {0.f, 0.f};     // bf16: sum_j exp(l_ij - m) dP_ij
  float inv_l[2], dl[2];
  float dq[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  const int tiles = (S + BT - 1) / BT;
  for (int pass = 0; pass < 2; ++pass) {
    const bool with_v = pass == 1 || !fwd;
    load_kv(0, 0, with_v);
    tc::cp_commit();
    for (int it = 0; it < tiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < tiles) {
        load_kv((it + 1) * BT, buf ^ 1, with_v);
        tc::cp_commit();
        tc::cp_wait<1>();
      } else {
        tc::cp_wait<0>();
      }
      __syncthreads();
      const T* Kt = Ks + buf * BT * L;
      const T* Vt = Vs + buf * BT * L;
      const float* bt = bias + buf * BT;

      float s[NT][4], dp[NT][4];
      product_nt<T, D, BT>(s, Qs, warp * 16, Kt);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = tc::logit(s[j][e], scale, bt[j * 8 + 2 * t + (e & 1)]);
      }
      if (with_v) product_nt<T, D, BT>(dp, Gs, warp * 16, Vt);
      if (pass == 0) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], tc::quad_max(mx[r]));
          corr[r] = tc::exp_(m[r] - m_new);
          l[r] *= corr[r];
          tsum[r] *= corr[r];
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = tc::exp_(s[j][e] - m[e >> 1]);
            l[e >> 1] += p;
            if (!fwd) tsum[e >> 1] = fmaf(p, dp[j][e], tsum[e >> 1]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = tc::exp_(s[j][e] - m[e >> 1]) * inv_l[e >> 1];
            dp[j][e] = p * (dp[j][e] - dl[e >> 1]);  // dS
          }
        }
        product_cn<T, D, BT>(dq, dp, Kt);
      }
      __syncthreads();  // this buffer is refilled two tiles on
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = warp * 16 + g + 8 * r;
        inv_l[r] = 1.f / tc::quad_sum(l[r]);
        dl[r] = fwd ? delta[i] : tc::quad_sum(tsum[r]) * inv_l[r];
        if (t == 0 && q0 + i < S) {
          float* st = stats + (((long long)b * H + h) * S + q0 + i) * 3;
          st[0] = m[r];
          st[1] = inv_l[r];
          st[2] = dl[r];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < S) {
      T* op = dqkv + ((long long)b * S + row) * rs + (long long)h * D + 2 * t;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        tc::store2(op + d * 8, dq[d][2 * r] * scale, dq[d][2 * r + 1] * scale);
    }
  }
}

// dK (times scale) and dV of a warp's 16 key rows from row0 into dqkv, or
// added to what is there (f32 only).
template <typename T, int D>
__device__ __forceinline__ void store_dkv(T* dqkv, const float (*dk)[4], const float (*dv)[4],
                                          int b, int S, int W, int h, int row0, float scale,
                                          bool add) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    T* op = dqkv + ((long long)b * S + row) * 3 * W + (long long)h * D + 2 * t;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      float k0 = dk[d][2 * r] * scale, k1 = dk[d][2 * r + 1] * scale;
      float v0 = dv[d][2 * r], v1 = dv[d][2 * r + 1];
      if (add) {
        k0 += tc::to_float(op[W + d * 8]);
        k1 += tc::to_float(op[W + d * 8 + 1]);
        v0 += tc::to_float(op[2 * W + d * 8]);
        v1 += tc::to_float(op[2 * W + d * 8 + 1]);
      }
      tc::store2(op + W + d * 8, k0, k1);
      tc::store2(op + 2 * W + d * 8, v0, v1);
    }
  }
}

// (b): dK and dV for one 64-row key tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
           const uint8_t* __restrict__ mask, const float* __restrict__ stats,
           T* __restrict__ dqkv, int S, int W, int H, float scale) {
  constexpr int L = tc::ld<T, D>();
  extern __shared__ uint4 smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [BT][L] this block's keys
  T* Vs = Ks + BT * L;                 // [BT][L]
  T* Qs = Vs + BT * L;                 // [2][BT][L]
  T* Gs = Qs + 2 * BT * L;             // [2][BT][L] dO
  float* st = reinterpret_cast<float*>(Gs + 2 * BT * L);  // [2][3][BT]: m, 1/l, Delta

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BT;
  const long long rs = 3LL * W;
  const T* base = qkv + (long long)b * S * rs + (long long)h * D;
  const T* gbase = dout + (long long)b * S * W + (long long)h * D;
  const float* sbase = stats + ((long long)b * H + h) * S * 3;
  constexpr int QN = BT / 2;  // query rows per step: fewer registers

  float kb[2];  // bias of the warp's key rows g, g + 8; -inf past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    kb[r] = key < S ? (mask[(long long)b * S + key] ? MASK_BIAS : 0.f) : -INFINITY;
  }

  auto load_q = [&](int q0, int buf) {
    tc::load_tile<T, D>(Qs + buf * BT * L, base + q0 * rs, rs, S - q0);
    tc::load_tile<T, D>(Gs + buf * BT * L, gbase + (long long)q0 * W, W, S - q0);
    if (threadIdx.x < BT) {  // query rows past S: P = 0 (1/l = 0)
      const int i = threadIdx.x;
      const bool ok = q0 + i < S;
      float* sb = st + buf * 3 * BT;
      sb[i] = ok ? sbase[(long long)(q0 + i) * 3] : 0.f;
      sb[BT + i] = ok ? sbase[(long long)(q0 + i) * 3 + 1] : 0.f;
      sb[2 * BT + i] = ok ? sbase[(long long)(q0 + i) * 3 + 2] : 0.f;
    }
  };
  tc::load_tile<T, D>(Ks, base + k0 * rs + W, rs, S - k0);
  tc::load_tile<T, D>(Vs, base + k0 * rs + 2 * W, rs, S - k0);
  load_q(0, 0);
  tc::cp_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }

  // f32 flushes its sums into dqkv every FLUSH query tiles and adds them up
  // there (the block owns these rows), so a sum over S rows takes few adds
  // at its full size: dV of a key that all 1500 queries attend is about 150,
  // where one f32 add rounds by up to 8e-6. bf16 stores once.
  constexpr int FLUSH = sizeof(T) == 4 ? 8 : 1 << 30;

  const int tiles = (S + BT - 1) / BT;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {
      load_q((it + 1) * BT, buf ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + buf * BT * L;
    const T* Gt = Gs + buf * BT * L;
    const float* sm = st + buf * 3 * BT;

#pragma unroll
    for (int q0 = 0; q0 < BT; q0 += QN) {
      float p[QN / 8][4], ds[QN / 8][4];
      // the cross terms in the other order: S^T and dP^T equal (a)'s S and
      // dP bit for bit, so P matches (a)'s statistics and dS its Delta
      product_nt<T, D, QN, true>(p, Ks, warp * 16, Qt + q0 * L);   // S^T
      product_nt<T, D, QN, true>(ds, Vs, warp * 16, Gt + q0 * L);  // dP^T
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + j * 8 + 2 * t + (e & 1);  // query row of the tile
          p[j][e] = tc::exp_(tc::logit(p[j][e], scale, kb[e >> 1]) - sm[i]) * sm[BT + i];
          ds[j][e] = p[j][e] * (ds[j][e] - sm[2 * BT + i]);
        }
      }
      product_cn<T, D, QN>(dv, p, Gt + q0 * L);
      product_cn<T, D, QN>(dk, ds, Qt + q0 * L);
    }
    __syncthreads();  // this buffer is refilled two tiles on
    if ((it + 1) % FLUSH == 0 && it + 1 < tiles) {
      store_dkv<T, D>(dqkv, dk, dv, b, S, W, h, k0 + warp * 16, scale, it + 1 > FLUSH);
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
        dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
      }
    }
  }
  store_dkv<T, D>(dqkv, dk, dv, b, S, W, h, k0 + warp * 16, scale, tiles > FLUSH);
}

template <typename T, int D>
cudaError_t launch(const void* qkv, const void* dout, const void* fwd, const void* mask,
                   void* stats, void* dqkv, int B, int S, int W, int H, float scale,
                   cudaStream_t stream) {
  // A bf16 O rounds each element by up to 2^-9; through Delta that moves dQ
  // and dK past the per-element bar (tests/test_torch_port_tc_numerics.py),
  // so bf16 takes Delta online from dP, one product more, and f32 alone
  // reads O.
  if (sizeof(T) == 4 && fwd == nullptr) return cudaErrorInvalidValue;
  if (sizeof(T) == 2) fwd = nullptr;
  constexpr size_t sa = smem_a<T, D>(), sb = smem_b<T, D>();
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sb);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BT - 1) / BT, H, B);
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* st = static_cast<float*>(stats);
  T* out = static_cast<T*>(dqkv);
  dq_kernel<T, D><<<grid, tc::THREADS, sa, stream>>>(x, g, static_cast<const T*>(fwd), m, st,
                                                     out, S, W, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<T, D><<<grid, tc::THREADS, sb, stream>>>(x, g, m, st, out, S, W, H, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3W], dout [B, S, W], fwd [B, S, W] (the forward's output; read
// in f32, may be null in bf16) and dqkv [B, S, 3W] contiguous, all of type dtype (0 = f32,
// 1 = bf16); mask [B, S] uint8 (1 = padding key); stats a scratch f32
// [B, H, S, 3]. Launches (a) then (b) on `stream` and does not synchronise.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// a shape or type the kernels do not take.
extern "C" int packed_attention_backward(const void* qkv, const void* dout, const void* fwd,
                                         const void* mask, void* stats, void* dqkv, int B,
                                         int S, int W, int H, int dtype, float scale,
                                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || W % H != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = W / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(qkv, dout, fwd, mask, stats, dqkv, B, S, W, H, scale, st);
  if (dtype == 0 && D == 32)
    return (int)launch<float, 32>(qkv, dout, fwd, mask, stats, dqkv, B, S, W, H, scale, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(qkv, dout, fwd, mask, stats, dqkv, B, S, W, H,
                                          scale, st);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(qkv, dout, fwd, mask, stats, dqkv, B, S, W, H,
                                          scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of kernel (a) (which = 0) or (b)
// (which = 1) for head width D and dtype, in bytes (0 where not taken).
extern "C" int packed_attention_backward_smem_bytes(int D, int dtype, int which) {
  if (dtype == 0 && D == 64) return (int)(which ? smem_b<float, 64>() : smem_a<float, 64>());
  if (dtype == 0 && D == 32) return (int)(which ? smem_b<float, 32>() : smem_a<float, 32>());
  if (dtype == 1 && D == 64)
    return (int)(which ? smem_b<__nv_bfloat16, 64>() : smem_a<__nv_bfloat16, 64>());
  if (dtype == 1 && D == 32)
    return (int)(which ? smem_b<__nv_bfloat16, 32>() : smem_a<__nv_bfloat16, 32>());
  return 0;
}
