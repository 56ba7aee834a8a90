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
// Design. One block of 4 warps (one warpgroup) per (64-row query tile,
// b*H + h); each warp owns 16 query rows.
// - f32: FlashAttention-2's shape by hand, tc::attention_forward in
//   mma_tile.cuh, which K1/K2 share in f32 on their packed layout. Each
//   head's K and V are one contiguous [S, D] slab, so 64-key tiles come
//   straight from global memory by 16-byte cp.async, double-buffered in
//   padded shared tiles. Per key tile a warp forms its 16 x 64 logits with
//   mma.sync (3xTF32) into f32 accumulators, rounds scale and bias apart,
//   runs the online softmax in registers, and feeds P from the accumulators
//   as the A operand of P V, into fresh accumulators added with one rounding
//   (see there). 3 tf32 mma for each of the two products.
// - bf16: K1's wgmma + TMA kernel body (wg::forward_tile in wgmma_tile.cuh),
//   fed by three 3-D tensor maps over q, k, v as [B*H][S][D] with a box of
//   (D, 64, 1): rows past S zero-fill within each (b, h), so no tile reads
//   the next head's rows. S = Q K^T by wgmma.m64n64k16 from shared memory,
//   P split into a bf16 hi + lo pair (see mma_tile.cuh) and multiplied twice
//   by V read MN-major: 1.5x the bound's bf16 operations.
// Head widths 16, 32 and 64, each its own instantiation (D = 16 as in
// packed_attention.cu).
// Shared memory at D = 64: f32 5 padded tiles of 64 x (D + 16 bytes), 85 KB
// (two blocks an SM); bf16 Q and two stages of K, V, 41 KB. chip_smoke.py
// prints each function's registers and spills.

#include <math.h>

#include "wgmma_tile.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
set_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int S,
                     float scale) {
  extern __shared__ uint4 smem[];
  const long long head = (long long)blockIdx.y * S * D;  // this head's [S, D] slab
  tc::attention_forward<T, D>(smem, q + head, k + head, v + head, D,
                              mask + (long long)(blockIdx.y / H) * S, out + head, D, S,
                              blockIdx.x * tc::TILE, scale);
}

// bf16: K1's wgmma + TMA body on three maps over [B*H][S][D]
template <typename T, int D>
__global__ void __launch_bounds__(tc::THREADS)
set_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int S,
                           float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * wg::STAGES];
  const int z = blockIdx.y;  // b*H + h
  wg::forward_tile<D>(smem_raw, bars, qmap, kmap, vmap, 0, 0, 0, z,
                      mask + (long long)(z / H) * S, out + (long long)z * S * D, D, nullptr, 0,
                      nullptr, S, scale);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* mask,
                         void* out, int B, int H, int S, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (!tmap::tiles<D>(&maps[i], src[i], D, D, S, (uint64_t)B * H)) return cudaErrorInvalidValue;
  }
  constexpr size_t smem = wg::forward_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(set_attention_wgmma_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + tc::TILE - 1) / tc::TILE, B * H);
  set_attention_wgmma_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, S,
      scale);
  return cudaGetLastError();
}

// f32: tc::attention_forward, mma.sync through 3xTF32
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int H, int S, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc::forward_smem_bytes<T, D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        set_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + tc::TILE - 1) / tc::TILE, B * H);
  set_attention_kernel<T, D><<<grid, tc::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, S, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and out [B, H, S, D] contiguous, all of type dtype (0 = f32,
// 1 = bf16), 16-byte aligned; mask [B, S] uint8 (1 = padding key). Launches on `stream` and
// does not synchronise. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or type the kernel does not take.
extern "C" int set_attention_forward(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, int B, int H, int S, int D,
                                     int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::dispatch_key(dtype, D)) {
    case 64: return (int)launch<float, 64>(q, k, v, mask, out, B, H, S, scale, st);
    case 32: return (int)launch<float, 32>(q, k, v, mask, out, B, H, S, scale, st);
    case 16: return (int)launch<float, 16>(q, k, v, mask, out, B, H, S, scale, st);
    case 164: return (int)launch_wgmma<64>(q, k, v, mask, out, B, H, S, scale, st);
    case 132: return (int)launch_wgmma<32>(q, k, v, mask, out, B, H, S, scale, st);
    case 116: return (int)launch_wgmma<16>(q, k, v, mask, out, B, H, S, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block for head width D and dtype, in bytes
// (0 for a combination the kernel does not take).
extern "C" int set_attention_smem_bytes(int D, int dtype) {
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
