// Warp-level tensor-core tiles shared by set_attention.cu (K3),
// packed_attention.cu (K1, K2) and packed_attention_bwd.cu (K5): 16-byte
// cp.async copies into padded shared tiles, mma.sync fragment loads and
// products (f32), the bf16 split of P and dS, the online softmax of a warp's
// logit tile, and the whole forward of one 64-row query tile (K1/K2/K3 in
// f32). The f32 kernels run on mma.sync through 3xTF32; the bf16 kernels
// run on wgmma (wgmma_tile.cuh), whose accumulators have the layout below,
// and share the softmax, the epilogue and the bf16 split of P and dS.
//
// Tiles are [64 rows][D] of the input type in shared memory with a row stride
// of D + 16 bytes, so that every fragment load below is free of bank
// conflicts. A warp owns 16 rows of an m16n8 product; g = lane / 4 and
// t = lane % 4 index the fragments as the PTX ISA lays them out.
//
// Precision. bf16 (the products on wgmma, wgmma_tile.cuh): f32 accumulators;
// the bf16 inputs are exact and their products exact in f32. An operand
// formed in the kernel (the probabilities P and the logit gradient dS, f32
// in the accumulators) is split into a bf16 pair hi + lo (hi = bf16(x),
// lo = bf16(x - hi), 16 mantissa bits together; Op<bf16>::a_from_c) and
// multiplied twice: one bf16 rounding of P would cost 2^-9 relative per
// term, as large as the per-element bar allows. f32 (mma.sync): 3xTF32. Each operand x is split into hi = cvt.rna.tf32(x) and
// lo = x - hi, left unrounded for the tensor cores, which read its top 19
// bits (the low 13 truncated: about as accurate as rounding it first, one
// instruction fewer); mma.m16n8k8 tf32 accumulates lo*hi + hi*lo + hi*hi in
// f32 (lo*lo, about 2^-22 relative, is dropped). TF32 alone keeps 11 bits:
// a logit of 30 would move by about 0.015.
//
// Accumulators (C, m16n8, f32): c[0] = (g, 2t), c[1] = (g, 2t + 1),
// c[2] = (g + 8, 2t), c[3] = (g + 8, 2t + 1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tc {

constexpr int WARPS = 4;           // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * WARPS;   // rows of a block tile: 16 per warp

// The key the launchers switch on: 100 * dtype + D for a pair the kernels
// take (dtype 0 = f32, 1 = bf16; head width D 16, 32 or 64), else -1.
__host__ __device__ constexpr int dispatch_key(int dtype, int D) {
  return (dtype == 0 || dtype == 1) && (D == 16 || D == 32 || D == 64) ? 100 * dtype + D : -1;
}

// Row stride of a shared [TILE][D] tile of T, in elements: D plus 16 bytes.
template <typename T, int D>
__host__ __device__ constexpr int ld() { return D + 16 / (int)sizeof(T); }

// ---- asynchronous copies -------------------------------------------------

// 16 bytes from global to shared; zeros when !valid (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a [*, D] matrix with row stride `stride` (elements) into the
// shared tile `dst`; rows n .. TILE - 1 are zero. All threads of the block.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int n) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
#pragma unroll
  for (int i = threadIdx.x; i < TILE * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * EPC;
    const bool ok = r < n;
    cp_async16(dst + r * ld<T, D>() + c, ok ? src + r * stride + c : src, ok);
  }
}

// ---- mma.sync --------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero: the low 13 bits), on the integer pipe: the conversion
// instruction runs at a quarter of the rate, and f32 is limited by its
// instruction count here
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x); lo = x - hi is exact in f32, and the tensor
// cores read only its top 19 bits (lo truncated to tf32, 2^-21 of x at most)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// (a, b) = hi + lo as two bf16 pairs
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- the product interface ---------------------------------------------------
//
// Op<T>::KS is the depth of one mma. Fragments, for a shared tile M (row
// stride L):
//   load_a(M, r0, k0):     A[i][k] = M[r0 + i][k0 + k]          (16 x KS, row)
//   load_b_nk(M, n0, k0):  B[k][n] = M[n0 + n][k0 + k]          (products X Y^T)
//   load_b_kn(M, k0, n0):  B[k][n] = M[k0 + perm(k)][n0 + n]    (products X Y)
//   a_from_c(c, kk):       A[i][k] = C[i][kk * KS + perm(k)] from the f32
//                          accumulators of a 16 x 64 product (P or dS)
// perm is the identity for bf16 (which keeps only a_from_c: its products
// run on wgmma). For tf32 the accumulator holds columns 2t,
// 2t + 1 where the A fragment wants t, t + 4, so position t stands for column
// 2t and t + 4 for 2t + 1; load_b_kn reads its rows in the same order, and
// the sum over k is unchanged.

template <typename T> struct Op;

template <> struct Op<float> {
  static constexpr int KS = 8;
  struct A { uint32_t hi[4], lo[4]; };
  using AP = A;  // operand formed in the kernel: the same 3xTF32 split
  struct B { uint32_t hi[2], lo[2]; };

  template <int L>
  static __device__ __forceinline__ A load_a(const float* M, int r0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = M + (r0 + g) * L + k0 + t;
    A a;
    split_tf32(p[0], a.hi[0], a.lo[0]);
    split_tf32(p[8 * L], a.hi[1], a.lo[1]);
    split_tf32(p[4], a.hi[2], a.lo[2]);
    split_tf32(p[8 * L + 4], a.hi[3], a.lo[3]);
    return a;
  }
  template <int L>
  static __device__ __forceinline__ B load_b_nk(const float* M, int n0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = M + (n0 + g) * L + k0 + t;
    B b;
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[4], b.hi[1], b.lo[1]);
    return b;
  }
  template <int L>
  static __device__ __forceinline__ B load_b_kn(const float* M, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const float* p = M + (k0 + 2 * t) * L + n0 + g;
    B b;
    split_tf32(p[0], b.hi[0], b.lo[0]);
    split_tf32(p[L], b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ AP a_from_c(const float (*c)[4], int kk) {
    A a;
    split_tf32(c[kk][0], a.hi[0], a.lo[0]);
    split_tf32(c[kk][2], a.hi[1], a.lo[1]);
    split_tf32(c[kk][1], a.hi[2], a.lo[2]);
    split_tf32(c[kk][3], a.hi[3], a.lo[3]);
    return a;
  }
  // c += a b, the small terms first
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  // c += a b with the cross terms taken in the other order: c[i][j] of
  // X Y^T with X as a and Y as b is then the same sum, bit for bit, as
  // c[j][i] of Y X^T through mma (the same products in the same order)
  static __device__ __forceinline__ void mma_swapped(float* c, const A& a, const B& b) {
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.hi);
  }
  // c += a b with the one add into c rounded to nearest. The tensor cores
  // truncate as they accumulate; over the hundreds of steps of a sum over S
  // rows into a large c (dV of a key that all 600 queries attend is about
  // 60) that drifts past the f32 bar, so a long sum takes each step apart.
  static __device__ __forceinline__ void mma_rn(float* c, const A& a, const B& b) {
    float d[4];
    mma_tf32_zero(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
    c[0] += d[0];
    c[1] += d[1];
    c[2] += d[2];
    c[3] += d[3];
  }
};

// bf16: only the operand formed in the kernel, as wgmma's register A
// operand (the m16n8k16 A fragments of each warp's 16 rows): a bf16 pair
template <> struct Op<__nv_bfloat16> {
  static constexpr int KS = 16;
  struct AP { uint32_t hi[4], lo[4]; };

  static __device__ __forceinline__ AP a_from_c(const float (*c)[4], int kk) {
    AP a;
    split_bf16(c[2 * kk][0], c[2 * kk][1], a.hi[0], a.lo[0]);
    split_bf16(c[2 * kk][2], c[2 * kk][3], a.hi[1], a.lo[1]);
    split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], a.hi[2], a.lo[2]);
    split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], a.hi[3], a.lo[3]);
    return a;
  }
};

// ---- epilogue ----------------------------------------------------------------

// Two neighbouring columns of one output row.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Max and sum over the four lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// e^x as 2^(x log2 e). x is a difference of logits, exact 0 for the equal
// logits of a fully masked row, -inf for keys past S.
__device__ __forceinline__ float exp_(float x) { return exp2f(x * 1.4426950408889634f); }

// The same through the bare ex2.approx.ftz instruction (2^-22 relative, exact
// 1 at 0, results below 2^-126 flushed to 0), one instruction where exp2f
// spends four on its range fix-up: for bf16, whose bar is 2^-8 relative
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// scale, then bias, rounded apart as the plain versions round them: a fused
// multiply-add would move fully masked logits by an ulp of 1e9
__device__ __forceinline__ float logit(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

// ---- the forward of one query tile ------------------------------------------
//
// softmax_tile, store_rows and attention_forward are the forward of K3 and,
// on the packed layout, of K1/K2 in f32; the bf16 forward
// (wg::forward_tile) shares softmax_tile, store_rows and store_stats (its
// products run on wgmma instead).

constexpr int NT = TILE / 8;  // n8 tiles of logits per 64-key tile
constexpr float MASK_BIAS = -1e9f;

// The online softmax of a warp's 16 x 64 logit tile s (m16n8 accumulators:
// rows g and g + 8, columns j * 8 + 2t + (e & 1)), in place: s becomes
// p = exp(l - m_new) with l = logit(s, scale, bias[j][e & 1]); m and l (this
// lane's part of the row sums) are updated and corr = exp(m_old - m_new)
// is returned per row for the output accumulators. FAST takes exp_fast.
template <bool FAST = false>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], const float (&bias)[NT][2],
                                             float scale, float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  const auto ex = [](float x) { return FAST ? exp_fast(x) : exp_(x); };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = logit(s[j][e], scale, bias[j][e & 1]);
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = ex(m[r] - m_new);
    l[r] *= corr[r];
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  }
}

// o / sum(l) of a warp's 16 rows, row0 the first, into out (rows out_stride
// elements apart); rows at or past S are not stored.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], const float (&l)[2],
                                           T* out, long long out_stride, int row0, int S) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float inv = 1.f / quad_sum(l[r]);
    if (row < S) {
      T* op = out + (long long)row * out_stride + 2 * t;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) store2(op + d * 8, o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
  }
}

// The max m and 1/sum(l) of a warp's 16 rows, row0 the first, into
// stats[row][0..1] (K5's row statistics); rows at or past S are not stored.
__device__ __forceinline__ void store_stats(const float (&m)[2], const float (&l)[2],
                                            float* stats, int row0, int S) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float inv = 1.f / quad_sum(l[r]);
    if (t == 0 && row < S) *reinterpret_cast<float2*>(stats + 2LL * row) = make_float2(m[r], inv);
  }
}

// Dynamic shared memory of attention_forward: Q, and K, V twice, as padded
// tiles, and two tiles of key biases.
template <typename T, int D>
__host__ __device__ constexpr size_t forward_smem_bytes() {
  return 5 * (size_t)TILE * ld<T, D>() * sizeof(T) + 2 * TILE * sizeof(float);
}

// Query rows [q0, q0 + TILE) of one (batch, head) by one block of THREADS
// threads: q, k, v point at key row 0 of the head's [S, D] column blocks,
// rows `stride` elements apart (D for split heads, 3W for a packed qkv);
// out at row 0 of its [S, D] block, rows `out_stride` apart; mrow at the
// batch's key-padding mask. 64-key tiles of K and V are double-buffered by
// cp.async (the next tile's copy overlaps this tile's products). Per key
// tile a warp forms its 16 x 64 logits with mma.sync, runs softmax_tile,
// and takes P from the accumulators as the A operand of P V. The tile's
// P V goes into fresh accumulators and then o = o * corr + P V with one
// rounding to nearest: the tensor cores truncate as they accumulate, which
// over thousands of keys would drift past the f32 bar. Keys past S get a
// bias of -inf (excluded, not masked); query rows past S are computed on
// zero-filled rows and not stored. Where stats is not null, each row's max
// and 1/sum go to stats[row][0..1] (store_stats: K1's training residuals).
template <typename T, int D>
__device__ __forceinline__ void attention_forward(void* smem, const T* q, const T* k,
                                                  const T* v, long long stride,
                                                  const uint8_t* mrow, T* out,
                                                  long long out_stride, int S, int q0,
                                                  float scale, float* stats = nullptr) {
  using O = Op<T>;
  constexpr int L = ld<T, D>();
  constexpr int KS = O::KS;
  T* Qs = reinterpret_cast<T*>(smem);  // [TILE][L]
  T* Ks = Qs + TILE * L;               // [2][TILE][L]
  T* Vs = Ks + 2 * TILE * L;           // [2][TILE][L]
  float* bias = reinterpret_cast<float*>(Vs + 2 * TILE * L);  // [2][TILE]

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 3;

  auto load_kv = [&](int k0, int buf) {
    load_tile<T, D>(Ks + buf * TILE * L, k + (long long)k0 * stride, stride, S - k0);
    load_tile<T, D>(Vs + buf * TILE * L, v + (long long)k0 * stride, stride, S - k0);
    if (threadIdx.x < TILE) {
      const int key = k0 + threadIdx.x;
      bias[buf * TILE + threadIdx.x] = key < S ? (mrow[key] ? MASK_BIAS : 0.f) : -INFINITY;
    }
  };
  load_tile<T, D>(Qs, q + (long long)q0 * stride, stride, S - q0);
  load_kv(0, 0);
  cp_commit();

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};        // this lane's part of their running sums

  const int tiles = (S + TILE - 1) / TILE;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {
      load_kv((it + 1) * TILE, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * TILE * L;
    const T* Vt = Vs + buf * TILE * L;
    const float* bt = bias + buf * TILE;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += KS) {
      const typename O::A a = O::template load_a<L>(Qs, warp * 16, k0);
#pragma unroll
      for (int j = 0; j < NT; ++j) O::mma(s[j], a, O::template load_b_nk<L>(Kt, j * 8, k0));
    }
    float bj[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bj[j][0] = bt[j * 8 + 2 * t];
      bj[j][1] = bt[j * 8 + 2 * t + 1];
    }
    float corr[2];
    softmax_tile(s, bj, scale, m, l, corr);

    float pv[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) pv[d][0] = pv[d][1] = pv[d][2] = pv[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TILE / KS; ++kk) {
      const typename O::AP p = O::a_from_c(s, kk);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        O::mma(pv[d], p, O::template load_b_kn<L>(Vt, kk * KS, d * 8));
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], corr[e >> 1], pv[d][e]);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  store_rows<T, D>(o, l, out, out_stride, q0 + warp * 16, S);
  if (stats) store_stats(m, l, stats, q0 + warp * 16, S);
}

}  // namespace tc
