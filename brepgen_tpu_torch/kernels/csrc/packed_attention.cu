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
// - bf16: wgmma and TMA (wg::forward_tile in wgmma_tile.cuh, which K3's
//   bf16 launch shares on its split heads). One elected thread brings the Q tile by TMA once and
//   K, V tiles into a ring of STAGES stages under mbarriers ("full": the
//   copy's bytes have landed; "empty": all 128 threads are done with the
//   stage, so it may be refilled), from a 3-D tensor map over qkv
//   [B][S][3W] with a box of (D, 64, 1): rows past S zero-fill within each
//   batch (a 2-D map over B*S rows would read the next batch's rows, and
//   0 * NaN is NaN). The tiles land swizzled (128 bytes at D = 64, 64 at
//   D = 32, 32 at D = 16), the layout the wgmma matrix descriptors name. S = Q K^T by
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
// Head widths 16, 32 and 64, each its own instantiation. D = 16 is the head
// width of the entry check's flagship (width 64, 4 heads) and of the CLIs'
// --small (width 32, 2 heads): the same 64-row tiles and online softmax,
// Q K^T in one k-step (bf16: one wgmma.m64n64k16 on 32-byte swizzled rows;
// f32: two k8 steps of mma.sync) and P V on wgmma.m64n16k16 (f32: two n8
// blocks). A tile then does half the products per byte it stages, and the
// softmax of its 64 x 64 logits, which does not shrink with D, weighs twice
// as much against them.
//
// Training residuals. Where the caller passes `stats` (the training forward
// under autograd), each (batch, head, row) gets its max m and 1/l in f32,
// [B, H, S, 2], and in bf16 the output unrounded in f32 (`o32`, [B, S, W]):
// K5 takes P = exp(l_ij - m) / l from them instead of recomputing the
// softmax, and Delta = rowsum(dO o O) from the f32 output (a bf16 O moves
// Delta past the bar). m and 1/l stay apart: a fully masked row has every
// logit at -1e9, where -1e9 + log S rounds back to -1e9, so a folded
// log-sum-exp would give P = 1 for every key, not 1/S. Sampling passes null
// pointers and writes nothing more; its output does not change.

#include "wgmma_tile.cuh"

namespace {

// f32: the forward of K3 on the packed layout
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
packed_attention_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ mask,
                        T* __restrict__ out, float* __restrict__ stats, int S, int W,
                        float scale) {
  extern __shared__ uint4 smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = 3LL * W;  // element stride between token rows
  const T* q = qkv + (long long)b * S * rs + (long long)h * D;
  tc::attention_forward<T, D>(smem, q, q + W, q + 2 * W, rs, mask + (long long)b * S,
                              out + (long long)b * S * W + (long long)h * D, W, S,
                              blockIdx.x * tc::TILE, scale,
                              stats ? stats + ((long long)b * gridDim.y + h) * S * 2 : nullptr);
}

// bf16: wgmma and TMA (wg::forward_tile) from one map over qkv [B][S][3W]
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
packed_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                              const uint8_t* __restrict__ mask, T* __restrict__ out,
                              float* __restrict__ o32, float* __restrict__ stats, int S, int W,
                              float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * wg::STAGES];
  const int h = blockIdx.y, b = blockIdx.z;
  const long long ofs = (long long)b * S * W + (long long)h * D;
  wg::forward_tile<D>(smem_raw, bars, map, map, map, h * D, W + h * D, 2 * W + h * D, b,
                      mask + (long long)b * S, out + ofs, W, o32 ? o32 + ofs : nullptr, W,
                      stats ? stats + ((long long)b * gridDim.y + h) * S * 2 : nullptr, S,
                      scale);
}

// ---- launchers ------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* qkv, const void* mask, void* out, void* stats, int B, int S,
                       int W, int H, float scale, cudaStream_t stream) {
  using T = float;
  constexpr size_t smem = tc::forward_smem_bytes<T, D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + tc::TILE - 1) / tc::TILE, H, B);
  packed_attention_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(mask), static_cast<T*>(out),
      static_cast<float*>(stats), S, W, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const void* qkv, const void* mask, void* out, void* o32, void* stats,
                         int B, int S, int W, int H, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  // qkv as [B][S][3W]; rows 6W bytes apart (a multiple of 16, as TMA needs,
  // since D is 16, 32 or 64)
  CUtensorMap map;
  if (!tmap::tiles<D>(&map, qkv, 3ull * W, 3ull * W, S, B)) return cudaErrorInvalidValue;
  constexpr size_t smem = wg::forward_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(packed_attention_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + tc::TILE - 1) / tc::TILE, H, B);
  packed_attention_wgmma_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
      map, static_cast<const uint8_t*>(mask), static_cast<T*>(out), static_cast<float*>(o32),
      static_cast<float*>(stats), S, W, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv [B, S, 3W] and out [B, S, W] contiguous, both of type dtype (0 = f32,
// 1 = bf16), qkv 16-byte aligned; mask [B, S] uint8 (1 = padding key). The
// training residuals, both null for sampling: stats f32 [B, H, S, 2] (each
// row's max and 1/sum) and, in bf16 only, o32 f32 [B, S, W] (the output
// before its rounding; must be null in f32, where out is that already).
// Launches on `stream` and does not synchronise. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or type the kernel
// does not take.
extern "C" int packed_attention_forward(const void* qkv, const void* mask, void* out, void* o32,
                                        void* stats, int B, int S, int W, int H, int dtype,
                                        float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || W % H != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if ((dtype == 0 && o32 != nullptr) || (o32 != nullptr && stats == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int D = W / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::dispatch_key(dtype, D)) {
    case 64: return (int)launch_f32<64>(qkv, mask, out, stats, B, S, W, H, scale, st);
    case 32: return (int)launch_f32<32>(qkv, mask, out, stats, B, S, W, H, scale, st);
    case 16: return (int)launch_f32<16>(qkv, mask, out, stats, B, S, W, H, scale, st);
    case 164: return (int)launch_wgmma<64>(qkv, mask, out, o32, stats, B, S, W, H, scale, st);
    case 132: return (int)launch_wgmma<32>(qkv, mask, out, o32, stats, B, S, W, H, scale, st);
    case 116: return (int)launch_wgmma<16>(qkv, mask, out, o32, stats, B, S, W, H, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block for head width D and dtype, in bytes
// (0 for a combination the kernel does not take).
extern "C" int packed_attention_smem_bytes(int D, int dtype) {
  switch (tc::dispatch_key(dtype, D)) {
    case 64: return (int)tc::forward_smem_bytes<float, 64>();
    case 32: return (int)tc::forward_smem_bytes<float, 32>();
    case 16: return (int)tc::forward_smem_bytes<float, 16>();
    case 164: return (int)wg::forward_smem_bytes<64>();
    case 132: return (int)wg::forward_smem_bytes<32>();
    case 116: return (int)wg::forward_smem_bytes<16>();
    default: return 0;
  }
}
