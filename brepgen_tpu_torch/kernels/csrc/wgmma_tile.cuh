// Hopper building blocks shared by the bf16 kernels of packed_attention.cu
// (K1, K2), set_attention.cu (K3) and packed_attention_bwd.cu (K5): TMA tile
// loads into a ring of shared stages under mbarriers, wgmma matrix
// descriptors of the swizzled tiles TMA writes, the two wgmma shapes every
// product of those kernels takes, the tensor maps that feed them, and the
// whole forward of one 64-row query tile (K1/K2/K3 in bf16).
//
// Tiles are [64 rows][D] bf16 in shared memory as TMA writes them from a
// 3-D tensor map with a box of (D, 64, 1): rows 2D bytes long, swizzled over
// 2D bytes (128 at D = 64, 64 at D = 32, 32 at D = 16), each tile 1024-byte
// aligned. One
// tile serves both ways: K-major (the contraction along D) for products
// X Y^T, MN-major through the transpose bit (the contraction along the 64
// rows) for products C Y.
//
// The accumulators of wgmma.m64nN (f32) give each warp w of the warpgroup
// rows 16w + g and 16w + g + 8 in the m16n8 layout of mma_tile.cuh, so
// tc::softmax_tile, tc::store_rows and tc::Op<bf16>::a_from_c work on them,
// and a_from_c gives the register A operand of the next product.

#pragma once

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time, no -lcuda

#include "mma_tile.cuh"

namespace wg {

constexpr int STAGES = 2;  // ring of streamed tiles

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of TMA transfers
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the box at (c0, c1, c2) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma matrix descriptor of a [64][D] bf16 tile as TMA wrote it: rows of
// 2D bytes swizzled over 2D bytes (128B at D = 64: layout 1; 64B at D = 32:
// layout 2; 32B at D = 16: layout 3), 8-row atoms 16D bytes apart. At each D
// an atom is 8 rows by the whole row, so a K-major k-step of 16 columns stays
// inside one atom (at D = 16 the one k-step is the whole row) and an
// MN-major tile holds one atom across its D columns. The atom stride is
// given as both offsets: for a K-major operand it is the stride byte offset
// and the leading one is unused; for an MN-major operand the 8-row atoms
// step along K (one atom spans all D columns), which the hardware reads
// from the leading offset. The tile starts 1024-byte aligned (base offset
// 0); a k-step of 16 columns of a K-major tile adds 32 bytes to the start
// (2 in the descriptor's 16-byte units), one of 16 rows of an MN-major tile
// 32D bytes (2D units).
template <int D>
__device__ __forceinline__ uint64_t desc(const void* tile) {
  constexpr uint64_t atom = 16 * D >> 4;
  static_assert(D == 16 || D == 32 || D == 64, "head width 16, 32 or 64");
  constexpr uint64_t layout = D == 64 ? 1 : D == 32 ? 2 : 3;
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | atom << 16 | atom << 32 | layout << 62;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of accumulators across a wgmma
// or its wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}

// d (64 x 64) = X Y^T (+ d if scale_d), one k-step of 16 columns: X and Y
// [64][D] tiles in shared memory, both K-major (S = Q K^T, dP = dO V^T and
// their transposes K Q^T, V dO^T)
__device__ __forceinline__ void mma_ss(float (&d)[tc::NT][4], uint64_t da, uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x D) = C Y (+ d if scale_d) at D = 64, one k-step of 16 rows of Y:
// C from registers (the m16n8k16 A fragments of each warp's 16 rows, from
// tc::Op<bf16>::a_from_c), Y a [64][D] tile read MN-major through the
// transpose bit, which 16-bit types allow (P V, dS K, P^T dO, dS^T Q)
__device__ __forceinline__ void mma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the same at D = 32
__device__ __forceinline__ void mma_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the same at D = 16: m64n16k16, 8 accumulators a thread (two n8 column
// blocks in the m16n8 layout); the register A fragments do not depend on N
__device__ __forceinline__ void mma_rs(float (&d)[2][4], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d = X Y^T over D for a 64 x 64 tile: D/16 k-steps, the first into fresh
// accumulators. Issues and commits; the caller waits.
template <int D>
__device__ __forceinline__ void product_xyt(float (&d)[tc::NT][4], uint64_t dx, uint64_t dy) {
  fence_acc(d);
  fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_ss(d, dx + 2 * kk, dy + 2 * kk, kk);
  commit();
}

// d = C Y over 64 rows of Y, C given as bf16 hi + lo pairs of the f32
// accumulators c (P or dS, one bf16 rounding of which misses the bar): into
// fresh accumulators (scale-d = 0 on the first product), lo then hi per 16
// rows. Waits for it.
template <int D>
__device__ __forceinline__ void product_cy(float (&d)[D / 8][4], const float (&c)[tc::NT][4],
                                           uint64_t dy) {
  using Op = tc::Op<__nv_bfloat16>;
  Op::AP a[tc::TILE / 16];
#pragma unroll
  for (int kk = 0; kk < tc::TILE / 16; ++kk) a[kk] = Op::a_from_c(c, kk);
  fence_acc(d);
  fence();
#pragma unroll
  for (int kk = 0; kk < tc::TILE / 16; ++kk) {
    mma_rs(d, a[kk].lo, dy + kk * (2 * D), kk);
    mma_rs(d, a[kk].hi, dy + kk * (2 * D), 1);
  }
  commit();
  wait_all();
  fence_acc(d);
}

// Bytes of a [64][D] bf16 tile.
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (uint32_t)tc::TILE * D * sizeof(__nv_bfloat16);
}

// The first 1024-byte aligned address in dynamic shared memory.
__device__ __forceinline__ uint8_t* aligned_tiles(uint8_t* smem_raw) {
  return smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
}

// ---- the forward of one query tile (K1, K2, K3 in bf16) -------------------------

// Dynamic shared memory of forward_tile: Q and STAGES x (K, V) tiles, and up
// to 1023 bytes to align them to 1024.
template <int D>
__host__ __device__ constexpr size_t forward_smem_bytes() {
  return (1 + 2 * STAGES) * (size_t)tile_bytes<D>() + 1024;
}

// Query rows [q0, q0 + 64) of one (batch, head) by one warpgroup: Q, K and V
// are the boxes at columns qc, kc, vc of the 3-D maps qmap, kmap, vmap, at
// depth z (K1/K2: one map over qkv [B][S][3W], columns h*D, W + h*D,
// 2W + h*D, z = b; K3: three maps over [B*H][S][D], column 0, z = b*H + h).
// One elected thread brings the Q tile by TMA once and K, V tiles into a
// ring of STAGES stages ("full": the copy's bytes have landed; "empty": all
// 128 threads are done with the stage, so it may be refilled); rows past S
// zero-fill within z. S = Q K^T by wgmma.m64n64k16 with both operands
// K-major; the online softmax in registers (tc::softmax_tile, exp through
// ex2.approx); P split into a bf16 hi + lo pair and multiplied twice by V,
// read MN-major, into fresh accumulators; then o = o * corr + P V. Keys past
// S are excluded (-inf). Stores o / l into out (rows out_stride apart) and,
// where the pointers are not null, the same in f32 into o32 (rows o32_stride
// apart) and the rows' max m and 1/l into stats ([S][2] of this (batch,
// head)): the training residuals of K5. Query rows past S are not stored.
template <int D>
__device__ __forceinline__ void forward_tile(uint8_t* smem_raw, uint64_t* bars,
                                             const CUtensorMap& qmap, const CUtensorMap& kmap,
                                             const CUtensorMap& vmap, int qc, int kc, int vc,
                                             int z, const uint8_t* mrow, __nv_bfloat16* out,
                                             long long out_stride, float* o32,
                                             long long o32_stride, float* stats, int S,
                                             float scale) {
  constexpr int NT = tc::NT;
  constexpr uint32_t TB = tile_bytes<D>();
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  uint8_t* tiles = aligned_tiles(smem_raw);
  auto k_tile = [&](int s) { return tiles + (1 + 2 * s) * TB; };
  auto v_tile = [&](int s) { return tiles + (2 + 2 * s) * TB; };

  const int q0 = blockIdx.x * tc::TILE;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int n_tiles = (S + tc::TILE - 1) / tc::TILE;

  auto load_kv = [&](int it) {
    const int s = it % STAGES;
    bar_expect(&full[s], 2 * TB);
    tma_load(k_tile(s), kmap, &full[s], kc, it * tc::TILE, z);
    tma_load(v_tile(s), vmap, &full[s], vc, it * tc::TILE, z);
  };
  if (threadIdx.x == 0) {
    bar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], tc::THREADS);
    }
    bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(qbar, TB);
    tma_load(tiles, qmap, qbar, qc, q0, z);
    for (int it = 0; it < STAGES && it < n_tiles; ++it) load_kv(it);
  }
  __syncwarp();

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};        // this lane's part of their running sums
  const uint64_t dq = desc<D>(tiles);
  bar_wait(qbar, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    float bias[NT][2];  // of this lane's 16 key columns
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = it * tc::TILE + j * 8 + 2 * t + e;
        bias[j][e] = key < S ? (mrow[key] ? tc::MASK_BIAS : 0.f) : -INFINITY;
      }
    }
    const uint64_t dk = desc<D>(k_tile(s)), dv = desc<D>(v_tile(s));
    bar_wait(&full[s], parity);

    float sc[NT][4];
    product_xyt<D>(sc, dq, dk);
    wait_all();
    fence_acc(sc);

    // exp through ex2.approx, far below the bf16 bar in precision
    float corr[2];
    tc::softmax_tile<true>(sc, bias, scale, m, l, corr);
    float pv[D / 8][4];
    product_cy<D>(pv, sc, dv);
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], corr[e >> 1], pv[d][e]);
    }

    // the stage is consumed: the elected thread refills it, STAGES tiles on
    bar_arrive(&empty[s]);
    if (threadIdx.x == 0 && it + STAGES < n_tiles) {
      bar_wait(&empty[s], parity);
      load_kv(it + STAGES);
    }
    __syncwarp();  // warp 0 converged again for the next tile's wgmma
  }
  const int row0 = q0 + warp * 16;
  tc::store_rows<__nv_bfloat16, D>(o, l, out, out_stride, row0, S);
  if (o32) tc::store_rows<float, D>(o, l, o32, o32_stride, row0, S);
  if (stats) tc::store_stats(m, l, stats, row0, S);
}

}  // namespace wg

// ---- tensor maps (host) ----------------------------------------------------------

namespace tmap {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (the library is built by plain nvcc and not linked to libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A map over a row-major [n2][n1][n0] bf16 array whose rows are `row` elements
// apart (row >= n0; a multiple of 8, as TMA wants 16-byte strides) and whose
// n1-row slabs are row * n1 apart, with a box of (D, 64, 1), swizzled as the
// wgmma descriptors of wgmma_tile.cuh name it; rows past n1 zero-fill within
// each slab. Returns false where the driver refuses it.
template <int D>
bool tiles(CUtensorMap* map, const void* base, uint64_t n0, uint64_t row, uint64_t n1,
           uint64_t n2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {row * 2, row * 2 * n1};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)tc::TILE, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a row-major f32 [n2][n1][4] array with a box of (4, 64, 1),
// unswizzled (one 16-byte row per query: K5's row statistics); rows past n1
// zero-fill within each slab.
inline bool rows4(CUtensorMap* map, const void* base, uint64_t n1, uint64_t n2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {4, n1, n2};
  const cuuint64_t strides[2] = {16, 16 * n1};
  const cuuint32_t box[3] = {4, (cuuint32_t)tc::TILE, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tmap
