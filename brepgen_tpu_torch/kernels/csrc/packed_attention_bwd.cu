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
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta_i = rowsum(dP o P)_i,
//   dQ = s dS K,  dK = s dS^T Q,
//
// and writes dqkv [B, S, 3W] = [dQ | dK | dV] in the input type (f32 or
// bf16); all sums are f32. A query row whose keys are all masked has a
// uniform P over the S real keys, as the forward gives it.
//
// From the forward (K1 under autograd) it takes each row's max m and 1/l,
// [B, H, S, 2], and the output O in f32 (in bf16 the unrounded f32 copy K1
// writes beside its bf16 output): P_ij = exp(l_ij - m_i) * (1/l_i), and
// Delta_i = rowsum(dO_i o O_i), which equals rowsum(dP o P) (one bf16
// rounding of O would move Delta past the bar: tests/
// test_torch_port_tc_numerics.py). So no pass recomputes the softmax. The
// f32 copy of O costs B*S*W*4 bytes a layer under autograd (236 MB at the
// training shape, 2.8 GB over the 12 layers of a step without --remat).
//
// What bounds it on an H100: the five products need 10*B*S^2*W operations;
// at the deepcad edgez training shape (B=128, S=600, W=768) that is 354
// GFLOP: 2.15 ms at the 3xTF32 rate (495/3 TFLOP/s) in f32, 0.36 ms in bf16
// (989 TFLOP/s), against about 0.7 GB to move in f32 (0.2 ms). So it is
// bound by operations.
//
// Design (FlashAttention-2's backward split in two launches, no atomics, so
// it is deterministic: two launches give the same bits).
//   (a) one block per (64-row query tile, head, batch): Delta of its rows
//       from dO and O, written with (m, 1/l) to a scratch f32 [B, H, S, 4]
//       for (b); then the key tiles stream by: logits and dP = dO V^T,
//       dS = P o (dP - Delta) in registers, dQ += dS K.
//   (b) one block per (64-row key tile, head, batch), its K and V rows
//       resident: the query tiles stream by with their rows of the scratch;
//       S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers,
//       dV += P^T dO and dK += dS^T Q.
// - bf16: wgmma and TMA, as K1's bf16 forward (wgmma_tile.cuh). One
//   warpgroup a block and an elected producer thread: the resident tiles
//   (Q, dO in (a); K, V in (b)) come by TMA once, the streamed ones (K, V in
//   (a); Q, dO and 64 rows of the scratch in (b)) into a ring of 2 stages
//   under mbarriers, from 3-D tensor maps over qkv [B][S][3W], dO [B][S][W]
//   and the scratch [B*H][S][4] with boxes of (D, 64, 1) and (4, 64, 1):
//   rows past S zero-fill within each batch (zero m, 1/l and Delta: P = 0),
//   so no tile reads the next batch's rows. The products X Y^T (S, dP and
//   their transposes) take both operands K-major from shared memory
//   (wgmma.m64n64k16); the products C Y (dS K, P^T dO, dS^T Q) take C from
//   the accumulators as a bf16 hi + lo pair in registers and Y MN-major
//   through the transpose bit (wgmma.m64nDk16). exp is ex2.approx.
// - f32: mma.sync through 3xTF32 (mma_tile.cuh; wgmma's tf32 takes only
//   K-major operands, and the products C Y and the transposed X Y^T read
//   their operands across rows), 16-byte cp.async into two padded buffers;
//   (b) forms S^T and dP^T with the 3xTF32 cross terms in the other order,
//   so that they equal (a)'s S and dP bit for bit, 32 queries at a time
//   (fewer registers).
// The sums over S rows (dQ, dK, dV) take each tile's product into fresh
// accumulators and add it with one rounding to nearest (the tensor cores
// truncate as they accumulate), and f32 dK, dV are flushed into dqkv every
// 8 query tiles, so that a sum of 1500 rows near 150 stays within the f32
// bar. Keys past S get a logit of -inf (excluded, not masked); rows past S
// are computed on zero-filled tiles and not stored.
// Operations executed, in units of 2*B*S^2*W (one product; the bound counts
// 5): 3 in (a) (logits, dP, dS K) and 4 in (b) (S^T, dP^T, P^T dO, dS^T Q),
// 7 in all. f32 runs each as 3 tf32 mma; bf16 runs the three products whose
// A operand is P or dS twice (the hi + lo pair), 10 bf16 products in all.
// Head widths 16, 32 and 64, each its own instantiation: at D = 16 every
// X Y^T is one k-step and every C Y a wgmma.m64n16k16 (f32: two k8 steps and
// two n8 blocks), on the same 64-row tiles.
// Shared memory at D = 64: bf16 (a) Q, dO and two stages of K, V, 48 KB,
// (b) K, V and two stages of Q, dO and 64 scratch rows, 50 KB; f32 6 padded
// tiles of 64 x (D + 16 bytes), 103 KB (two blocks an SM). chip_smoke.py
// prints each function's registers and spills.

#include <math.h>

#include "wgmma_tile.cuh"

namespace {

constexpr int BT = tc::TILE;  // rows per tile, streamed or owned
constexpr int NT = BT / 8;    // n8 tiles of a 16 x 64 product
using bf16 = __nv_bfloat16;

// ---- f32: mma.sync through 3xTF32 ----------------------------------------------

// 6 padded tiles, and (a) 2 x 64 key biases and 64 Deltas, (b) 2 x 3 x 64
// row statistics
template <int D>
constexpr size_t smem_f32() {
  return 6 * (size_t)BT * tc::ld<float, D>() * sizeof(float) + 6 * BT * sizeof(float);
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
// step into fresh accumulators, those into acc (and dK, dV flush acc into
// dqkv every few tiles, in dkv_kernel).
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

// Delta = rowsum(dO o O) of the 64 query rows from row0, from dO and O
// [*, W] in global memory at this head's columns (ofs), two threads a row,
// into delta[] in shared memory and, with the row's (m, 1/l) from stats
// [S][2], into rows_out [S][4] as (m, 1/l, Delta, 0); rows past S get 0 and
// are not written. All threads; ends in __syncthreads().
template <typename T, int D>
__device__ __forceinline__ void row_deltas(const T* dout, const float* o32, const float* stats,
                                           float* rows_out, float* delta, long long ofs, int W,
                                           int row0, int S) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = row0 + r;
  float sum = 0.f;
  if (row < S) {
    const long long at = ofs + (long long)row * W + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; d += 4) {
      const float4 o = *reinterpret_cast<const float4*>(o32 + at + d);
      sum = fmaf(tc::to_float(dout[at + d]), o.x, sum);
      sum = fmaf(tc::to_float(dout[at + d + 1]), o.y, sum);
      sum = fmaf(tc::to_float(dout[at + d + 2]), o.z, sum);
      sum = fmaf(tc::to_float(dout[at + d + 3]), o.w, sum);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (half == 0) {
    delta[r] = sum;
    if (row < S) {
      const float2 ml = *reinterpret_cast<const float2*>(stats + 2LL * row);
      *reinterpret_cast<float4*>(rows_out + 4LL * row) = make_float4(ml.x, ml.y, sum, 0.f);
    }
  }
  __syncthreads();
}

// (a), f32 (T = float): dQ for one 64-row query tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ o32,
          const float* __restrict__ stats, const uint8_t* __restrict__ mask,
          float* __restrict__ rows, T* __restrict__ dqkv, int S, int W, int H, float scale) {
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
  const long long hs = ((long long)b * H + h) * S;  // this head's first row of the statistics

  auto load_kv = [&](int k0, int buf) {
    tc::load_tile<T, D>(Ks + buf * BT * L, base + k0 * rs + W, rs, S - k0);
    tc::load_tile<T, D>(Vs + buf * BT * L, base + k0 * rs + 2 * W, rs, S - k0);
    if (threadIdx.x < BT) {
      const int key = k0 + threadIdx.x;
      bias[buf * BT + threadIdx.x] = key < S ? (mrow[key] ? tc::MASK_BIAS : 0.f) : -INFINITY;
    }
  };
  tc::load_tile<T, D>(Qs, base + q0 * rs, rs, S - q0);
  tc::load_tile<T, D>(Gs, dout + gofs + (long long)q0 * W, W, S - q0);
  load_kv(0, 0);
  tc::cp_commit();
  row_deltas<T, D>(dout, o32, stats + 2 * hs, rows + 4 * hs, delta, gofs, W, q0, S);

  float m[2], inv_l[2], dl[2];  // rows g, g + 8; rows past S: P = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + g + 8 * r;
    const bool ok = q0 + i < S;
    m[r] = ok ? stats[2 * (hs + q0 + i)] : 0.f;
    inv_l[r] = ok ? stats[2 * (hs + q0 + i) + 1] : 0.f;
    dl[r] = delta[i];
  }
  float dq[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  const int tiles = (S + BT - 1) / BT;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {
      load_kv((it + 1) * BT, buf ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * BT * L;
    const float* bt = bias + buf * BT;

    float s[NT][4], dp[NT][4];
    product_nt<T, D, BT>(s, Qs, warp * 16, Kt);
    product_nt<T, D, BT>(dp, Gs, warp * 16, Vs + buf * BT * L);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = tc::logit(s[j][e], scale, bt[j * 8 + 2 * t + (e & 1)]);
        const float p = tc::exp_(l - m[e >> 1]) * inv_l[e >> 1];
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]);  // dS
      }
    }
    product_cn<T, D, BT>(dq, dp, Kt);
    __syncthreads();  // this buffer is refilled two tiles on
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

// (b), f32 (T = float): dK and dV for one 64-row key tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
           const uint8_t* __restrict__ mask, const float* __restrict__ rows,
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
  const float* sbase = rows + ((long long)b * H + h) * S * 4;
  constexpr int QN = BT / 2;  // query rows per step: fewer registers

  float kb[2];  // bias of the warp's key rows g, g + 8; -inf past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    kb[r] = key < S ? (mask[(long long)b * S + key] ? tc::MASK_BIAS : 0.f) : -INFINITY;
  }

  auto load_q = [&](int q0, int buf) {
    tc::load_tile<T, D>(Qs + buf * BT * L, base + q0 * rs, rs, S - q0);
    tc::load_tile<T, D>(Gs + buf * BT * L, gbase + (long long)q0 * W, W, S - q0);
    if (threadIdx.x < BT) {  // query rows past S: P = 0 (1/l = 0)
      const int i = threadIdx.x;
      const bool ok = q0 + i < S;
      float* sb = st + buf * 3 * BT;
      const float4 r = ok ? *reinterpret_cast<const float4*>(sbase + 4LL * (q0 + i))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      sb[i] = r.x;
      sb[BT + i] = r.y;
      sb[2 * BT + i] = r.z;
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

  // flushes its sums into dqkv every FLUSH query tiles and adds them up
  // there (the block owns these rows), so a sum over S rows takes few adds
  // at its full size: dV of a key that all 1500 queries attend is about 150,
  // where one f32 add rounds by up to 8e-6
  constexpr int FLUSH = 8;

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
      // dP bit for bit
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

// ---- bf16: wgmma and TMA ----------------------------------------------------------

constexpr int STAGES = wg::STAGES;
constexpr uint32_t ROWS_TILE = BT * 4 * sizeof(float);  // 64 rows of the scratch

template <int D>
constexpr size_t smem_dq_wgmma() {
  // Q, dO, STAGES x (K, V), alignment
  return (2 + 2 * STAGES) * (size_t)wg::tile_bytes<D>() + 1024;
}
template <int D>
constexpr size_t smem_dkv_wgmma() {
  // K, V, STAGES x (Q, dO), STAGES scratch tiles, alignment
  return (2 + 2 * STAGES) * (size_t)wg::tile_bytes<D>() + STAGES * ROWS_TILE + 1024;
}

// (a), bf16: dQ for one 64-row query tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                const __grid_constant__ CUtensorMap do_map, const T* __restrict__ dout,
                const float* __restrict__ o32, const float* __restrict__ stats,
                const uint8_t* __restrict__ mask, float* __restrict__ rows,
                T* __restrict__ dqkv, int S, int W, int H, float scale) {
  constexpr uint32_t TB = wg::tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * STAGES];
  __shared__ float delta[BT];
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  uint8_t* tiles = wg::aligned_tiles(smem_raw);  // Q, dO, then K, V per stage
  auto k_tile = [&](int s) { return tiles + (2 + 2 * s) * TB; };
  auto v_tile = [&](int s) { return tiles + (3 + 2 * s) * TB; };

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BT;
  const int n_tiles = (S + BT - 1) / BT;
  const uint8_t* mrow = mask + (long long)b * S;
  const long long hs = ((long long)b * H + h) * S;  // this head's first row of the statistics

  auto load_kv = [&](int it) {
    const int s = it % STAGES;
    wg::bar_expect(&full[s], 2 * TB);
    wg::tma_load(k_tile(s), qkv_map, &full[s], W + h * D, it * BT, b);
    wg::tma_load(v_tile(s), qkv_map, &full[s], 2 * W + h * D, it * BT, b);
  };
  if (threadIdx.x == 0) {
    wg::bar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], tc::THREADS);
    }
    wg::bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect(qbar, 2 * TB);
    wg::tma_load(tiles, qkv_map, qbar, h * D, q0, b);
    wg::tma_load(tiles + TB, do_map, qbar, h * D, q0, b);
    for (int it = 0; it < STAGES && it < n_tiles; ++it) load_kv(it);
  }
  __syncwarp();
  // while the tiles come: Delta of the block's rows, and the scratch rows
  row_deltas<T, D>(dout, o32, stats + 2 * hs, rows + 4 * hs, delta,
                   (long long)b * S * W + (long long)h * D, W, q0, S);

  float m[2], inv_l[2], dl[2];  // rows g, g + 8; rows past S: P = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + g + 8 * r;
    const bool ok = q0 + i < S;
    m[r] = ok ? stats[2 * (hs + q0 + i)] : 0.f;
    inv_l[r] = ok ? stats[2 * (hs + q0 + i) + 1] : 0.f;
    dl[r] = delta[i];
  }
  float dq[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  const uint64_t dsc_q = wg::desc<D>(tiles), dsc_do = wg::desc<D>(tiles + TB);
  wg::bar_wait(qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    float bias[NT][2];  // of this lane's 16 key columns
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = it * BT + j * 8 + 2 * t + e;
        bias[j][e] = key < S ? (mrow[key] ? tc::MASK_BIAS : 0.f) : -INFINITY;
      }
    }
    const uint64_t dk = wg::desc<D>(k_tile(s)), dv = wg::desc<D>(v_tile(s));
    wg::bar_wait(&full[s], parity);

    float sc[NT][4], dp[NT][4];
    wg::product_xyt<D>(sc, dsc_q, dk);   // S = Q K^T
    wg::product_xyt<D>(dp, dsc_do, dv);  // dP = dO V^T
    wg::wait_all();
    wg::fence_acc(sc);
    wg::fence_acc(dp);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = tc::logit(sc[j][e], scale, bias[j][e & 1]);
        const float p = tc::exp_fast(l - m[e >> 1]) * inv_l[e >> 1];
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]);  // dS
      }
    }
    float part[D / 8][4];
    wg::product_cy<D>(part, dp, dk);  // dS K
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[d][e] += part[d][e];
    }

    // the stage is consumed: the elected thread refills it, STAGES tiles on
    wg::bar_arrive(&empty[s]);
    if (threadIdx.x == 0 && it + STAGES < n_tiles) {
      wg::bar_wait(&empty[s], parity);
      load_kv(it + STAGES);
    }
    __syncwarp();  // warp 0 converged again for the next tile's wgmma
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < S) {
      T* op = dqkv + ((long long)b * S + row) * 3 * W + (long long)h * D + 2 * t;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        tc::store2(op + d * 8, dq[d][2 * r] * scale, dq[d][2 * r + 1] * scale);
    }
  }
}

// (b), bf16: dK and dV for one 64-row key tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap rows_map, const uint8_t* __restrict__ mask,
                 T* __restrict__ dqkv, int S, int W, int H, float scale) {
  constexpr uint32_t TB = wg::tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * STAGES];
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  // K, V, then Q, dO per stage, then the stages' scratch rows
  uint8_t* tiles = wg::aligned_tiles(smem_raw);
  auto q_tile = [&](int s) { return tiles + (2 + 2 * s) * TB; };
  auto do_tile = [&](int s) { return tiles + (3 + 2 * s) * TB; };
  auto rows_tile = [&](int s) {
    return reinterpret_cast<const float4*>(tiles + (2 + 2 * STAGES) * TB + s * ROWS_TILE);
  };

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BT;
  const int n_tiles = (S + BT - 1) / BT;
  const int zh = b * H + h;

  auto load_q = [&](int it) {
    const int s = it % STAGES;
    wg::bar_expect(&full[s], 2 * TB + ROWS_TILE);
    wg::tma_load(q_tile(s), qkv_map, &full[s], h * D, it * BT, b);
    wg::tma_load(do_tile(s), do_map, &full[s], h * D, it * BT, b);
    wg::tma_load(const_cast<float4*>(rows_tile(s)), rows_map, &full[s], 0, it * BT, zh);
  };
  if (threadIdx.x == 0) {
    wg::bar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], tc::THREADS);
    }
    wg::bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect(kvbar, 2 * TB);
    wg::tma_load(tiles, qkv_map, kvbar, W + h * D, k0, b);
    wg::tma_load(tiles + TB, qkv_map, kvbar, 2 * W + h * D, k0, b);
    for (int it = 0; it < STAGES && it < n_tiles; ++it) load_q(it);
  }
  __syncwarp();

  float kb[2];  // bias of the warp's key rows g, g + 8; -inf past S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    kb[r] = key < S ? (mask[(long long)b * S + key] ? tc::MASK_BIAS : 0.f) : -INFINITY;
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }
  const uint64_t dsc_k = wg::desc<D>(tiles), dsc_v = wg::desc<D>(tiles + TB);
  wg::bar_wait(kvbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const uint64_t dq = wg::desc<D>(q_tile(s)), ddo = wg::desc<D>(do_tile(s));
    wg::bar_wait(&full[s], parity);

    float pt[NT][4], dst[NT][4];
    wg::product_xyt<D>(pt, dsc_k, dq);    // S^T = K Q^T
    wg::product_xyt<D>(dst, dsc_v, ddo);  // dP^T = V dO^T
    wg::wait_all();
    wg::fence_acc(pt);
    wg::fence_acc(dst);
    const float4* sr = rows_tile(s);  // (m, 1/l, Delta) of the tile's queries
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 q = sr[j * 8 + 2 * t + c];  // query column j*8 + 2t + c
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p = tc::exp_fast(tc::logit(pt[j][e], scale, kb[r]) - q.x) * q.y;
          pt[j][e] = p;
          dst[j][e] = p * (dst[j][e] - q.z);  // dS^T
        }
      }
    }
    float part[D / 8][4];
    wg::product_cy<D>(part, pt, ddo);  // P^T dO
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[d][e] += part[d][e];
    }
    wg::product_cy<D>(part, dst, dq);  // dS^T Q
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[d][e] += part[d][e];
    }

    wg::bar_arrive(&empty[s]);
    if (threadIdx.x == 0 && it + STAGES < n_tiles) {
      wg::bar_wait(&empty[s], parity);
      load_q(it + STAGES);
    }
    __syncwarp();
  }
  store_dkv<T, D>(dqkv, dk, dv, b, S, W, h, k0 + warp * 16, scale, false);
}

// ---- launchers -----------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* qkv, const void* dout, const void* o32, const void* stats,
                       const void* mask, void* rows, void* dqkv, int B, int S, int W, int H,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<D>();
  using T = float;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BT - 1) / BT, H, B);
  const float* x = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* r = static_cast<float*>(rows);
  float* out = static_cast<float*>(dqkv);
  dq_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(x, g, static_cast<const float*>(o32),
                                                       static_cast<const float*>(stats), m, r,
                                                       out, S, W, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(x, g, m, r, out, S, W, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* qkv, const void* dout, const void* o32, const void* stats,
                         const void* mask, void* rows, void* dqkv, int B, int S, int W, int H,
                         float scale, cudaStream_t stream) {
  using T = bf16;
  CUtensorMap qkv_map, do_map, rows_map;
  if (!tmap::tiles<D>(&qkv_map, qkv, 3ull * W, 3ull * W, S, B) ||
      !tmap::tiles<D>(&do_map, dout, W, W, S, B) ||
      !tmap::rows4(&rows_map, rows, S, (uint64_t)B * H)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t sa = smem_dq_wgmma<D>(), sb = smem_dkv_wgmma<D>();
  cudaError_t e = cudaFuncSetAttribute(dq_wgmma_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sb);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + BT - 1) / BT, H, B);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  T* out = static_cast<T*>(dqkv);
  dq_wgmma_kernel<T, D><<<grid, tc::THREADS, sa, stream>>>(
      qkv_map, do_map, static_cast<const T*>(dout), static_cast<const float*>(o32),
      static_cast<const float*>(stats), m, static_cast<float*>(rows), out, S, W, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkv_wgmma_kernel<T, D><<<grid, tc::THREADS, sb, stream>>>(qkv_map, do_map, rows_map, m, out, S,
                                                             W, H, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3W], dout [B, S, W] and dqkv [B, S, 3W] contiguous, of type
// dtype (0 = f32, 1 = bf16), 16-byte aligned; from the forward (K1): o32
// f32 [B, S, W] (its output before rounding) and stats f32 [B, H, S, 2]
// (each row's max and 1/sum); mask [B, S] uint8 (1 = padding key); rows a
// scratch f32 [B, H, S, 4]. Launches (a) then (b) on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or type the kernels do not take.
extern "C" int packed_attention_backward(const void* qkv, const void* dout, const void* o32,
                                         const void* stats, const void* mask, void* rows,
                                         void* dqkv, int B, int S, int W, int H, int dtype,
                                         float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || W % H != 0 || B > 65535 || H > 65535 || o32 == nullptr ||
      stats == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = W / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K5_ARGS qkv, dout, o32, stats, mask, rows, dqkv, B, S, W, H, scale, st
  switch (tc::dispatch_key(dtype, D)) {
    case 64: return (int)launch_f32<64>(K5_ARGS);
    case 32: return (int)launch_f32<32>(K5_ARGS);
    case 16: return (int)launch_f32<16>(K5_ARGS);
    case 164: return (int)launch_wgmma<64>(K5_ARGS);
    case 132: return (int)launch_wgmma<32>(K5_ARGS);
    case 116: return (int)launch_wgmma<16>(K5_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K5_ARGS
}

// Dynamic shared memory of one block of kernel (a) (which = 0) or (b)
// (which = 1) for head width D and dtype, in bytes (0 where not taken).
extern "C" int packed_attention_backward_smem_bytes(int D, int dtype, int which) {
  switch (tc::dispatch_key(dtype, D)) {
    case 64: return (int)smem_f32<64>();
    case 32: return (int)smem_f32<32>();
    case 16: return (int)smem_f32<16>();
    case 164: return (int)(which ? smem_dkv_wgmma<64>() : smem_dq_wgmma<64>());
    case 132: return (int)(which ? smem_dkv_wgmma<32>() : smem_dq_wgmma<32>());
    case 116: return (int)(which ? smem_dkv_wgmma<16>() : smem_dq_wgmma<16>());
    default: return 0;
  }
}
