// Masked multi-head set attention read straight from the fused QKV projection,
// on the H100's tensor cores.
//
// Replaces the TPU kernels brepgen_tpu/kernels/attention.py:_packed_kernel
// (K1, entry fused_set_attention_packed -> _packed_forward) and
// _packed_flash_kernel (K2, entry _packed_flash_forward): K2 is K1's
// function with K/V streamed in chunks under an online softmax, which the
// TPU needed only because full-S K/V no longer fit VMEM. This kernel streams
// K/V that way at every S: its grid ((S+63)/64, H, B), its 64-bit row
// offsets and its shared memory do not depend on S, so the wrappers
// packed_attention (K1) and packed_flash_attention (K2, S > 8192) launch
// it both, each with its own launch count. It computes, for every batch b,
// head h and query row i:
//
//   out[b, i, h*D:(h+1)*D] = sum_j p_ij V_j / sum_j p_ij,
//   p_ij = exp(l_ij - max_j l_ij),  l_ij = (Q_i . K_j) * scale + bias_j,
//
// with Q, K, V the column blocks [0, W), [W, 2W), [2W, 3W) of qkv [B, S, 3W],
// scale = 1/sqrt(D), D = W/H, and bias_j = -1e9 where key j is padding
// (mask True), else 0, added after the scale with the two operations rounded
// apart (tc::logit). Keys past S are excluded (-inf). Logits, softmax and
// the accumulator are f32 for both input types (f32, bf16). A query row
// whose keys are all masked gets the uniform mean of V over the S real keys,
// as the plain version gives it.
//
// What bounds it on an H100: at the deepcad edge stages (B=16, S=1800,
// W=768, H=12) one call does 4*B*S^2*W = 159 GFLOP against about 354 MB to
// move in f32 (qkv read once, out written once), so it is bound by
// operations: 0.97 ms at the 3xTF32 rate (495/3 TFLOP/s), 0.16 ms in bf16
// (989 TFLOP/s). On K2's long sets (B=2, S=8400, W=768) 433 GFLOP, 2.63 ms
// and 0.44 ms.
//
// Design. One block of 4 warps (one warpgroup) per (64-row query tile, head,
// batch), grid ((S+63)/64, H, B): B*H can pass 65535 at long sets with
// large batches, so b and h stay apart. Logits never reach device memory:
// per 64-key tile a warp holds its 16 x 64 logits in registers and runs the
// online softmax there (tc::softmax_tile), then takes P from the
// accumulators as the A operand of P V. Each tile's P V goes into fresh
// accumulators, then o = o * corr + P V with one rounding (the tensor cores
// truncate as they accumulate). Query rows past S are computed on zero rows
// and not stored.
// - f32: K3's kernel (tc::attention_forward, mma.sync through 3xTF32) on the
//   packed layout: Q, K and V tiles come by cp.async straight from qkv with
//   row stride 3W at columns h*D, W + h*D and 2W + h*D, K and V double-
//   buffered. 3xTF32 runs three tf32 products for one f32 product.
// - bf16: wgmma and TMA. One elected thread brings the Q tile by TMA once and
//   K, V tiles into a ring of STAGES stages under mbarriers ("full": the
//   copy's bytes have landed; "empty": all 128 threads are done with the
//   stage, so it may be refilled), from a 3-D tensor map over qkv
//   [B][S][3W] with a box of (D, 64, 1): rows past S zero-fill within each
//   batch (a 2-D map over B*S rows would read the next batch's rows, and
//   0 * NaN is NaN). The tiles land swizzled (128 bytes at D = 64, 64 at
//   D = 32), the layout the wgmma matrix descriptors name. S = Q K^T by
//   wgmma.m64n64k16 with both operands K-major in shared memory; P is split
//   into a bf16 hi + lo pair in registers (one bf16 rounding of P misses the
//   bf16 bar) and multiplied twice by V, read MN-major through the transpose
//   bit, by wgmma.m64nDk16; scale-d = 0 on a tile's first product gives the
//   fresh accumulators. One consumer warpgroup with an elected producer
//   thread, not two consumer warpgroups beside a producer warp: four blocks
//   of 128 registers a thread share an SM and hide each other's softmax.
//   On an H100, two consumer warpgroups sharing each K/V tile, a ring of 3
//   or 4 stages, and FlashAttention-3's overlap of one tile's softmax with
//   the previous tile's P V (168 registers) were no faster: the kernel is
//   bound by instruction throughput, hundreds of instructions a thread per
//   64-key tile against 12 wgmma, so exp takes ex2.approx (exp2f's range
//   fix-up cost about a tenth of the time).
//   bf16 executes 1.5x the bound's operations (P V twice).

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is fetched at run time, no -lcuda

#include "mma_tile.cuh"

namespace {

constexpr int STAGES = 2;  // K/V ring of the bf16 kernel

// f32: the forward of K3 on the packed layout
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
packed_attention_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        T* __restrict__ out, int S, int W, float scale) {
  extern __shared__ uint4 smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * W;  // element stride between token rows
  const T* q = qkv + (long long)b * S * rs + (long long)h * D;
  tc::attention_forward<T, D>(smem, q, q + W, q + 2 * W, rs, mask + (long long)b * S,
                              out + (long long)b * S * W + (long long)h * D, W, S,
                              blockIdx.x * tc::TILE, scale);
}

// ---- bf16: wgmma and TMA ------------------------------------------------------

namespace wg {

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
// layout 2), 8-row atoms 16D bytes apart. The atom stride is given as both
// offsets: for the K-major Q and K tiles it is the stride byte offset and
// the leading one is unused; for the MN-major V tile the 8-row atoms step
// along K (one atom spans all D columns), which the hardware reads from the
// leading offset. The tile starts 1024-byte aligned (base offset 0); a
// k-step of 16 columns of a K-major tile adds 32 bytes to the start, one of
// 16 rows of the MN-major tile 32D bytes.
template <int D>
__device__ __forceinline__ uint64_t desc(const void* tile) {
  constexpr uint64_t atom = 16 * D >> 4;
  constexpr uint64_t layout = D == 64 ? 1 : 2;
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

// S = Q K^T (+ S if scale_d): A and B from shared memory, both K-major
__device__ __forceinline__ void mma_qk(float (&d)[tc::NT][4], uint64_t da, uint64_t db,
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

// O = P V (+ O if scale_d) at D = 64: P from registers (the m16n8k16 A
// fragments of the warp's 16 rows), V from shared memory MN-major (the
// transpose bit, which 16-bit types allow)
__device__ __forceinline__ void mma_pv(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
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
__device__ __forceinline__ void mma_pv(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db,
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

}  // namespace wg

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // Q and STAGES x (K, V) tiles, and up to 1023 bytes to align them to 1024
  return (1 + 2 * STAGES) * (size_t)tc::TILE * D * sizeof(__nv_bfloat16) + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
packed_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                              const uint8_t* __restrict__ mask, T* __restrict__ out, int S,
                              int W, float scale) {
  constexpr int NT = tc::NT;
  constexpr uint32_t TB = tc::TILE * D * sizeof(T);  // bytes of one tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * STAGES];
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  uint8_t* tiles = smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);
  auto k_tile = [&](int s) { return tiles + (1 + 2 * s) * TB; };
  auto v_tile = [&](int s) { return tiles + (2 + 2 * s) * TB; };

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * tc::TILE;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
  const int n_tiles = (S + tc::TILE - 1) / tc::TILE;
  const uint8_t* mrow = mask + (long long)b * S;

  auto load_kv = [&](int it) {
    const int s = it % STAGES;
    wg::bar_expect(&full[s], 2 * TB);
    wg::tma_load(k_tile(s), map, &full[s], W + h * D, it * tc::TILE, b);
    wg::tma_load(v_tile(s), map, &full[s], 2 * W + h * D, it * tc::TILE, b);
  };
  if (threadIdx.x == 0) {
    wg::bar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], tc::THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect(qbar, TB);
    wg::tma_load(tiles, map, qbar, h * D, q0, b);
    for (int it = 0; it < STAGES && it < n_tiles; ++it) load_kv(it);
  }
  __syncwarp();

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};        // this lane's part of their running sums
  const uint64_t dq = wg::desc<D>(tiles);
  wg::bar_wait(qbar, 0);

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
    const uint64_t dk = wg::desc<D>(k_tile(s)), dv = wg::desc<D>(v_tile(s));
    wg::bar_wait(&full[s], parity);

    float sc[NT][4];
    wg::fence_acc(sc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wg::mma_qk(sc, dq + 2 * kk, dk + 2 * kk, kk);
    wg::commit();
    wg::wait_all();
    wg::fence_acc(sc);

    // exp through ex2.approx (see the note above), far below the bf16 bar
    // in precision
    float corr[2];
    tc::softmax_tile<true>(sc, bias, scale, m, l, corr);
    typename tc::Op<T>::AP p[tc::TILE / 16];
#pragma unroll
    for (int kk = 0; kk < tc::TILE / 16; ++kk) p[kk] = tc::Op<T>::a_from_c(sc, kk);

    // this tile's P V into fresh accumulators (scale-d = 0 on its first
    // product), lo then hi per 16 keys, then o = o * corr + P V
    float pv[D / 8][4];
    wg::fence_acc(pv);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < tc::TILE / 16; ++kk) {
      wg::mma_pv(pv, p[kk].lo, dv + kk * (2 * D), kk);
      wg::mma_pv(pv, p[kk].hi, dv + kk * (2 * D), 1);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_acc(pv);
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], corr[e >> 1], pv[d][e]);
    }

    // the stage is consumed: the elected thread refills it, two tiles on
    wg::bar_arrive(&empty[s]);
    if (threadIdx.x == 0 && it + STAGES < n_tiles) {
      wg::bar_wait(&empty[s], parity);
      load_kv(it + STAGES);
    }
    __syncwarp();  // warp 0 converged again for the next tile's wgmma
  }
  tc::store_rows<T, D>(o, l, out + (long long)b * S * W + (long long)h * D, W,
                       q0 + warp * 16, S);
}

// ---- launchers ------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* qkv, const void* mask, void* out, int B, int S, int W, int H,
                       float scale, cudaStream_t stream) {
  using T = float;
  constexpr size_t smem = tc::forward_smem_bytes<T, D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + tc::TILE - 1) / tc::TILE, H, B);
  packed_attention_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, W,
      scale);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point
// query (the library is built by plain nvcc and not linked to libcuda)
EncodeTiled encode_tiled() {
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

template <int D>
cudaError_t launch_wgmma(const void* qkv, const void* mask, void* out, int B, int S, int W, int H,
                         float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // qkv as [B][S][3W], innermost first; rows 6W bytes apart (a multiple of
  // 16, as TMA needs, since D is 32 or 64)
  CUtensorMap map;
  const cuuint64_t dims[3] = {3ull * W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {3ull * W * sizeof(T), 3ull * W * sizeof(T) * S};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)tc::TILE, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  constexpr size_t smem = wgmma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(packed_attention_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + tc::TILE - 1) / tc::TILE, H, B);
  packed_attention_wgmma_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
      map, static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, W, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3W] and out [B, S, W] contiguous, both of type dtype (0 = f32,
// 1 = bf16), qkv 16-byte aligned; mask [B, S] uint8 (1 = padding key).
// Launches on `stream` and does not synchronise. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or type the kernel
// does not take.
extern "C" int packed_attention_forward(const void* qkv, const void* mask, void* out, int B,
                                        int S, int W, int H, int dtype, float scale,
                                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || W % H != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = W / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(qkv, mask, out, B, S, W, H, scale, st);
  if (dtype == 0 && D == 32) return (int)launch_f32<32>(qkv, mask, out, B, S, W, H, scale, st);
  if (dtype == 1 && D == 64) return (int)launch_wgmma<64>(qkv, mask, out, B, S, W, H, scale, st);
  if (dtype == 1 && D == 32) return (int)launch_wgmma<32>(qkv, mask, out, B, S, W, H, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block for head width D and dtype, in bytes
// (0 for a combination the kernel does not take).
extern "C" int packed_attention_smem_bytes(int D, int dtype) {
  if (dtype == 0 && D == 64) return (int)tc::forward_smem_bytes<float, 64>();
  if (dtype == 0 && D == 32) return (int)tc::forward_smem_bytes<float, 32>();
  if (dtype == 1 && D == 64) return (int)wgmma_smem_bytes<64>();
  if (dtype == 1 && D == 32) return (int)wgmma_smem_bytes<32>();
  return 0;
}
