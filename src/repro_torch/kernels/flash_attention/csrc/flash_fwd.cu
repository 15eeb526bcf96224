// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` built by
// `flash_pallas_call` (src/repro/kernels/flash_attention/kernel.py): the
// online-softmax forward with padding, causal (with the `skv - sq` offset)
// and sliding-window masks, float32 m / l / acc state, and outputs `o` and
// the per-row float32 log-sum-exp `lse = m + log(l)`.
//
// What bounds it on the card: at prefill lengths it does O(S^2 * hd)
// multiply-adds per head on O(S * hd) bytes, so it is bound by arithmetic,
// and the scores never leave the chip (the point of the TPU kernel too).
// This first version runs the products on the CUDA cores in float32, not
// on the tensor cores (wgmma/TMA are later work), so it sits well under the
// bf16 tensor-core bound; what it does about the arithmetic is keep it out
// of shared-memory stalls: each thread owns a 4x4 tile of scores and a 4x8
// tile of the output, the Q / K / V tiles sit in shared memory as float32
// with an odd row pitch (conflict-free column reads), and K and V share one
// buffer so two blocks fit on an SM.
//
// Work split: one block of 256 threads per (64-row q tile, row of B*H); a
// loop over 64-row kv tiles inside the block takes the place of the TPU
// grid's sequential kv axis. kv tiles that no row of the q tile can see
// (past the causal edge, before the window) are skipped: for every row with
// a visible key this gives the same result as the TPU kernel, which runs
// them and lets the exp(NEG - m) = 0 correction wipe their contribution.
// Rows never mix, so a row's result does not depend on how many rows share
// the launch. GQA: q head h reads kv head h / (H / kvH) in place (no
// repeated copy of k / v).
//
// Layout: q, o [B, Sq, H, 128]; k, v [B, Skv, kvH, 128], contiguous, float32
// or bfloat16; lse [B, H, Sq] float32. Each launch reports
// cudaGetLastError() to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 128;        // head dim
constexpr int BM = 64;         // q rows per block
constexpr int BN = 64;         // kv rows per tile
constexpr int NT = 256;        // threads per block, as 16 x 16
constexpr int LD = HD + 1;     // row pitch of the Q and K/V tiles (floats)
constexpr int LDP = BN + 1;    // row pitch of the P tile
constexpr float NEG = -1e30f;
constexpr size_t SMEM_BYTES = sizeof(float) * (BM * LD + BN * LD + BM * LDP);
static_assert(BM == BN, "load_tile stages BM rows for Q, K and V alike");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// dst[r][d] = src[(r0 + r) * row_stride + d] * mul as float32, zero for rows
// at or past n_rows (the ragged edge; uninitialised shared memory could
// hold NaN, and 0 * NaN would reach the output).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long row_stride, int r0, int n_rows,
                                          float mul) {
  for (int idx = threadIdx.x; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float val = 0.f;
    if (r0 + r < n_rows) val = to_f(src[(long)(r0 + r) * row_stride + d]) * mul;
    dst[r * LD + d] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int kvH, int Sq, int Skv,
                 float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* Qs = smem;              // [BM][LD], pre-scaled
  float* KVs = Qs + BM * LD;     // [BN][LD], K then V of the current tile
  float* Ps = KVs + BN * LD;     // [BM][LDP], probabilities

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / kvH);
  const int q0 = qt * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = Skv - Sq;

  const T* qb = q + ((long)b * Sq * H + h) * HD;
  const T* kb = k + ((long)b * Skv * kvH + kh) * HD;
  const T* vb = v + ((long)b * Skv * kvH + kh) * HD;
  const long q_stride = (long)H * HD, kv_stride = (long)kvH * HD;

  load_tile(Qs, qb, q_stride, q0, Sq, scale);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  // the kv range any row of this q tile can see
  const int q_last = min(q0 + BM, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, q_last + off + 1);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }

  for (int k0 = (kv_lo / BN) * BN; k0 < kv_hi; k0 += BN) {
    __syncthreads();  // Q is loaded / the last tile's V reads are done
    load_tile(KVs, kb, kv_stride, k0, Skv, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Skv && qpos < Sq;
        if (causal) {
          ok = ok && kpos <= qpos + off;
          if (window > 0) ok = ok && kpos > qpos + off - window;
        }
        if (!ok) s[i][j] = NEG;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // the 16 threads of a row are lanes of one half-warp
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, w));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int w = 8; w >= 1; w >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, w);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    }

    __syncthreads();  // K reads done, P written
    load_tile(KVs, vb, kv_stride, k0, Skv, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float vv = KVs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) put(orow + tx + 16 * j, acc[i][j] / denom);
    if (tx == 0) lse[(long)bh * Sq + qpos] = m[i] + logf(denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int kvH, int Sq, int Skv, float scale, int causal,
           int window, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in, per device
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_kernel<T><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, kvH, Sq, Skv,
      scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (0 = ok).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int dtype, int B, int H, int kvH, int Sq,
                         int Skv, float scale, int causal, int window,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, kvH, Sq, Skv, scale,
                                 causal, window, s);
  return launch<float>(q, k, v, o, lse, B, H, kvH, Sq, Skv, scale, causal,
                       window, s);
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
