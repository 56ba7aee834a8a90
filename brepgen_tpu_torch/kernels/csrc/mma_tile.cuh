// Warp-level tensor-core tiles shared by set_attention.cu (K3) and
// packed_attention_bwd.cu (K5): 16-byte cp.async copies into padded shared
// tiles, mma.sync fragment loads, and one product interface for both input
// types.
//
// Tiles are [64 rows][D] of the input type in shared memory with a row stride
// of D + 16 bytes, so that every fragment load below is free of bank
// conflicts. A warp owns 16 rows of an m16n8 product; g = lane / 4 and
// t = lane % 4 index the fragments as the PTX ISA lays them out.
//
// Precision. bf16: mma.m16n8k16 with f32 accumulators; the bf16 inputs are
// exact and their products exact in f32. An operand formed in the kernel
// (the probabilities P and the logit gradient dS, f32 in the accumulators)
// is split into a bf16 pair hi + lo (hi = bf16(x), lo = bf16(x - hi), 16
// mantissa bits together) and multiplied twice: one bf16 rounding of P would
// cost 2^-9 relative per term, as large as the per-element bar allows.
// f32: 3xTF32. Each operand x is split into hi = cvt.rna.tf32(x) and
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
#include <stdint.h>

namespace tc {

constexpr int WARPS = 4;           // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * WARPS;   // rows of a block tile: 16 per warp

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
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

// ---- one product interface for both input types -----------------------------
//
// Op<T>::KS is the depth of one mma. Fragments, for a shared tile M (row
// stride L):
//   load_a(M, r0, k0):     A[i][k] = M[r0 + i][k0 + k]          (16 x KS, row)
//   load_b_nk(M, n0, k0):  B[k][n] = M[n0 + n][k0 + k]          (products X Y^T)
//   load_b_kn(M, k0, n0):  B[k][n] = M[k0 + perm(k)][n0 + n]    (products X Y)
//   a_from_c(c, kk):       A[i][k] = C[i][kk * KS + perm(k)] from the f32
//                          accumulators of a 16 x 64 product (P or dS)
// perm is the identity for bf16. For tf32 the accumulator holds columns 2t,
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

template <> struct Op<__nv_bfloat16> {
  static constexpr int KS = 16;
  struct A { uint32_t x[4]; };
  struct AP { uint32_t hi[4], lo[4]; };
  struct B { uint32_t x[2]; };

  template <int L>
  static __device__ __forceinline__ A load_a(const __nv_bfloat16* M, int r0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const __nv_bfloat16* p = M + (r0 + g) * L + k0 + 2 * t;
    A a;
    a.x[0] = *reinterpret_cast<const uint32_t*>(p);
    a.x[1] = *reinterpret_cast<const uint32_t*>(p + 8 * L);
    a.x[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a.x[3] = *reinterpret_cast<const uint32_t*>(p + 8 * L + 8);
    return a;
  }
  template <int L>
  static __device__ __forceinline__ B load_b_nk(const __nv_bfloat16* M, int n0, int k0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const __nv_bfloat16* p = M + (n0 + g) * L + k0 + 2 * t;
    B b;
    b.x[0] = *reinterpret_cast<const uint32_t*>(p);
    b.x[1] = *reinterpret_cast<const uint32_t*>(p + 8);
    return b;
  }
  template <int L>
  static __device__ __forceinline__ B load_b_kn(const __nv_bfloat16* M, int k0, int n0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(M + (k0 + 2 * t) * L + n0 + g);
    B b;
    b.x[0] = (uint32_t)p[0] | ((uint32_t)p[L] << 16);
    b.x[1] = (uint32_t)p[8 * L] | ((uint32_t)p[9 * L] << 16);
    return b;
  }
  static __device__ __forceinline__ AP a_from_c(const float (*c)[4], int kk) {
    AP a;
    split_bf16(c[2 * kk][0], c[2 * kk][1], a.hi[0], a.lo[0]);
    split_bf16(c[2 * kk][2], c[2 * kk][3], a.hi[1], a.lo[1]);
    split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], a.hi[2], a.lo[2]);
    split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    mma_bf16(c, a.x, b.x);
  }
  static __device__ __forceinline__ void mma_swapped(float* c, const A& a, const B& b) {
    mma_bf16(c, a.x, b.x);
  }
  static __device__ __forceinline__ void mma(float* c, const AP& a, const B& b) {
    mma_bf16(c, a.lo, b.x);
    mma_bf16(c, a.hi, b.x);
  }
  // the truncation drift of a long sum stays far inside the bf16 bar
  template <typename Frag>
  static __device__ __forceinline__ void mma_rn(float* c, const Frag& a, const B& b) {
    mma(c, a, b);
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

// scale, then bias, rounded apart as the plain versions round them: a fused
// multiply-add would move fully masked logits by an ulp of 1e9
__device__ __forceinline__ float logit(float dot, float scale, float bias) {
  return __fadd_rn(__fmul_rn(dot, scale), bias);
}

}  // namespace tc
