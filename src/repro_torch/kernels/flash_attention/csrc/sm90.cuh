// Hopper (sm_90a) building blocks for hand-written tensor-core kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// m64n64k16 bf16 wgmma (both operands in shared memory, or A in registers),
// all as raw PTX. Header-only; the host side encodes TMA tensor maps through
// the driver entry point that the CUDA runtime hands out, so nothing links
// against libcuda.
//
// Shared-memory tiles are the 128-byte-swizzled layout that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: a bf16 tile of R rows by 64 columns is R rows
// of 128 bytes, 8-row atoms of 1024 bytes, and must start on a 1024-byte
// boundary. A 128-column (hd = 128) tile is two such halves, 64 columns each.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// one plain arrival (a consumer releasing a stage)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase with this parity has completed; a phase
// that has not completed after ~10^10 cycles (seconds) is a fault, and the
// kernel traps (the launch then reports an error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 10000000000ll) __trap();
  }
}

// ---- TMA --------------------------------------------------------------------

// 4-d tile load into shared memory, completion counted on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands (the
// reduction dim contiguous) ignore `lbo`; stepping k by 16 bf16 adds 32
// bytes to `addr` inside a 128-byte row. MN-major operands (trans = 1) read
// 8-row groups of k `sbo` bytes apart and 64-column atoms `lbo` apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin an accumulator's registers in program order around wgmma issue and
// wait: the compiler sees the asm as synchronous and would otherwise be free
// to move reads of the registers above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define SM90_D32_LIST                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both
// K-major (as q and k for s = q k^T); accumulate when `acc`. Thread t of
// the warpgroup holds d[4i + e] at row 16 (t / 32) + (t % 32) / 4 +
// 8 (e / 2), column 8 i + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : SM90_D32
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers and B read
// MN-major (as k for ds k, with k's tile stored [kv rows][hd]): a[0..3] hold A's bf16 pairs in the
// accumulator's row / column order (a[0] / a[1] columns 2 (t % 4) + {0, 1}
// of rows r / r + 8, a[2] / a[3] the same 8 columns on).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_D32
#undef SM90_D32_LIST

// two floats as one register of bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of k-step kk (columns 16 kk .. 16 kk + 15) of a product whose
// A is a 64 x 64 accumulator `d` (the accumulator's layout is the register
// operand's, so no data moves between threads), split in two bf16 parts:
// hi = bf16(d), lo = bf16(d - hi). The product taken as hi B + lo B carries
// d to ~2^-16 of its value, where hi B alone would carry it to 2^-8.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int kk,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x = d[8 * kk + 2 * r], y = d[8 * kk + 2 * r + 1];
    const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
    hi[r] = *reinterpret_cast<const uint32_t*>(&b);
    lo[r] = pack_bf16(x - __low2float(b), y - __high2float(b));
  }
}

// The same operand rounded once, hi = bf16(d) alone: the rounding of p that
// the plain attention (and FlashAttention) applies before p v.
__device__ __forceinline__ void acc_to_a_hi(const float (&d)[32], int kk,
                                            uint32_t (&hi)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    hi[r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous bf16 [B, S, Hn, 128] array whose box is one
// 64-column half of 64 consecutive s at one (b, head): coordinates
// {d0, head, s0, b}. Rows past S read as zeros. Returns false on failure.
inline bool bshd_map(CUtensorMap* map, const void* ptr, int B, int S, int Hn) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t row = 128 * sizeof(__nv_bfloat16);
  cuuint64_t dims[4] = {128, (cuuint64_t)Hn, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[3] = {row, row * Hn, row * Hn * S};
  cuuint32_t box[4] = {64, 1, 64, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
