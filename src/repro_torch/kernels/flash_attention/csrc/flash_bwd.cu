// Flash-attention backward for Hopper (sm_90a), CUDA C++: dq, and dk / dv.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` (built by
// `flash_bwd_dq_call`) and `_flash_bwd_dkv_kernel` (built by
// `flash_bwd_dkv_call`) in src/repro/kernels/flash_attention/kernel.py. Both
// recompute the probability tile p = exp(s - lse) from the forward's saved
// per-row log-sum-exp with the forward's masks (padding, causal with the
// `skv - sq` offset, sliding window; `_bwd_mask_and_p`), and take
// delta = rowsum(do * o), which the wrapper computes in plain PyTorch as the
// JAX wrapper does outside Pallas. With ds = p * (dp - delta), dp = do v^T:
//   dq = scale * ds k           (flash_bwd_dq: kv loop inside the block)
//   dk = scale * ds^T q, dv = p^T do   (flash_bwd_dkv: q loop inside)
//
// What bounds it on the card: like the forward, arithmetic — 7 products of
// O(S^2 * hd) per head (3 in the dq kernel: s, dp, dq; 4 in the dkv kernel:
// s, dv, dp, dk) on O(S * hd) bytes. This first version runs them on the
// CUDA cores in float32 (wgmma/TMA are later work), so it sits well under
// the bf16 tensor-core bound. What it does about the arithmetic: each thread
// owns a 4x4 tile of a 64x64 score block and a 4x8 tile of its 64x128
// accumulators, the tiles sit in shared memory in the input's type with an
// odd row pitch in 32-bit words (conflict-free column reads), and bf16
// inputs keep the tiles at half the size so two or three blocks fit an SM.
//
// Work split. dq: one block of 256 threads per (64-row q tile, row of B*H),
// looping over the kv tiles its rows can see (the TPU grid's sequential kv
// axis). dk / dv: one block per (64-row kv tile, batch row, kv head), looping
// over the rep = H / kvH query heads that share the kv head and, for each,
// over the q tiles that can see the kv tile: the GQA sum over the shared
// heads happens in float32 registers, not in a repeated copy summed after.
// No atomics anywhere: every output element is written once by one thread
// after a fixed-order sum, so two launches give bit-equal dq, dk and dv (the
// MDA selection over sums of these gradients must repeat).
//
// Layout: q, o, do, dq [B, Sq, H, 128]; k, v, dk, dv [B, Skv, kvH, 128],
// contiguous, float32 or bfloat16 (the wrapper zero-pads hd up to 128);
// lse, delta [B, H, Sq] float32. Each launch reports cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 128;        // head dim (padded)
constexpr int BM = 64;         // q rows per tile
constexpr int BN = 64;         // kv rows per tile
constexpr int NT = 256;        // threads per block, as 16 x 16
constexpr int LDP = BN + 1;    // row pitch of the float32 p / ds tile

// row pitch (elements) of a [64][128] tile: an odd number of 32-bit words
template <typename T> struct Pitch;
template <> struct Pitch<float> { static constexpr int v = HD + 1; };
template <> struct Pitch<__nv_bfloat16> { static constexpr int v = HD + 2; };

template <typename T>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(T) * BM * Pitch<T>::v;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// dst[r][d] = src[(r0 + r) * row_stride + d], zero for rows at or past
// n_rows (the ragged edge: uninitialised shared memory could hold NaN).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long row_stride, int r0,
                                          int n_rows) {
  constexpr int LD = Pitch<T>::v;
  for (int idx = threadIdx.x; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    T val = zero<T>();
    if (r0 + r < n_rows) val = src[(long)(r0 + r) * row_stride + d];
    dst[r * LD + d] = val;
  }
}

// the forward's mask: key kpos is visible to query qpos
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Skv,
                                        int off, int causal, int window) {
  bool ok = kpos < Skv && qpos < Sq;
  if (causal) {
    ok = ok && kpos <= qpos + off;
    if (window > 0) ok = ok && kpos > qpos + off - window;
  }
  return ok;
}

// acc[i][j] (+)= sum_d A[ra + i][d] * B[rb + 16 j][d]: 4 rows of A against
// 4 rows of B, both [64][128] tiles of type T
template <typename T>
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const T* A,
                                         int ra, const T* Bt, int rb) {
  constexpr int LD = Pitch<T>::v;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = to_f(A[(ra + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = to_f(Bt[(rb + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
}

// out[i][j] += sum_c P[r0 + i][c] * X[c][tx + 16 j]: a float32 [64][64]
// tile times a [64][128] tile of type T
template <typename T>
__device__ __forceinline__ void mul_tile(float (&out)[4][8], const float* P,
                                         int r0, const T* X, int tx) {
  constexpr int LD = Pitch<T>::v;
#pragma unroll 4
  for (int c = 0; c < BN; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(r0 + i) * LDP + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = to_f(X[c * LD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][j] = fmaf(p[i], x, out[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int kvH, int Sq, int Skv, float scale, int causal,
                    int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);                       // [BM][LD]
  T* dOs = reinterpret_cast<T*>(smem + tile_bytes<T>());    // [BM][LD]
  T* KVs = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());  // K, V, K
  float* dSs = reinterpret_cast<float*>(smem + 3 * tile_bytes<T>());

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / kvH);
  const int q0 = qt * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = Skv - Sq;
  const long q_stride = (long)H * HD, kv_stride = (long)kvH * HD;
  const T* kb = k + ((long)b * Skv * kvH + kh) * HD;
  const T* vb = v + ((long)b * Skv * kvH + kh) * HD;

  load_tile(Qs, q + ((long)b * Sq * H + h) * HD, q_stride, q0, Sq);
  load_tile(dOs, dout + ((long)b * Sq * H + h) * HD, q_stride, q0, Sq);
  float lse_r[4], dlt_r[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    lse_r[i] = qpos < Sq ? lse[(long)bh * Sq + qpos] : 0.f;
    dlt_r[i] = qpos < Sq ? delta[(long)bh * Sq + qpos] : 0.f;
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
    __syncthreads();  // Q / dO loaded; the last tile's K reads are done
    load_tile(KVs, kb, kv_stride, k0, Skv);
    __syncthreads();
    float s[4][4] = {};
    dot_rows(s, Qs, ty * 4, KVs, tx);
    __syncthreads();
    load_tile(KVs, vb, kv_stride, k0, Skv);
    __syncthreads();
    float dp[4][4] = {};
    dot_rows(dp, dOs, ty * 4, KVs, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = visible(qpos, kpos, Sq, Skv, off, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * LDP + tx + 16 * j] = p * (dp[i][j] - dlt_r[i]);
      }
    }
    __syncthreads();  // V reads done, ds written
    load_tile(KVs, kb, kv_stride, k0, Skv);
    __syncthreads();
    mul_tile(acc, dSs, ty * 4, KVs, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Sq) continue;
    T* row = dq + (((long)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) put(row + tx + 16 * j, acc[i][j] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int kvH, int Sq, int Skv,
                     float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);                       // [BN][LD]
  T* Vs = reinterpret_cast<T*>(smem + tile_bytes<T>());
  T* Qs = reinterpret_cast<T*>(smem + 2 * tile_bytes<T>());  // [BM][LD]
  T* dOs = reinterpret_cast<T*>(smem + 3 * tile_bytes<T>());
  float* Ps = reinterpret_cast<float*>(smem + 4 * tile_bytes<T>());  // p^T, ds^T

  // causal: the first kv tiles are seen by the most q rows, so go first
  const int kt = blockIdx.x;
  const int bk = blockIdx.y;
  const int b = bk / kvH, kh = bk % kvH;
  const int rep = H / kvH;
  const int k0 = kt * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = Skv - Sq;
  const long q_stride = (long)H * HD, kv_stride = (long)kvH * HD;

  load_tile(Ks, k + ((long)b * Skv * kvH + kh) * HD, kv_stride, k0, Skv);
  load_tile(Vs, v + ((long)b * Skv * kvH + kh) * HD, kv_stride, k0, Skv);

  // the q range that can see any key of this kv tile
  const int k_last = min(k0 + BN, Skv) - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) {
    q_lo = max(0, k0 - off);
    if (window > 0) q_hi = min(Sq, k_last - off + window);
  }

  float dka[4][8], dva[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = kh * rep + r;
    const long bh = (long)b * H + h;
    const T* qb = q + ((long)b * Sq * H + h) * HD;
    const T* dob = dout + ((long)b * Sq * H + h) * HD;
    for (int q0 = (q_lo / BM) * BM; q0 < q_hi; q0 += BM) {
      __syncthreads();  // the last tile's Q / dO / Ps reads are done
      load_tile(Qs, qb, q_stride, q0, Sq);
      load_tile(dOs, dob, q_stride, q0, Sq);
      __syncthreads();
      float lse_c[4], dlt_c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        lse_c[j] = qpos < Sq ? lse[bh * Sq + qpos] : 0.f;
        dlt_c[j] = qpos < Sq ? delta[bh * Sq + qpos] : 0.f;
      }
      // s^T [kv rows x q cols] and p^T
      float st[4][4] = {};
      dot_rows(st, Ks, ty * 4, Qs, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qpos = q0 + tx + 16 * j;
          st[i][j] = visible(qpos, kpos, Sq, Skv, off, causal, window)
                         ? expf(st[i][j] * scale - lse_c[j]) : 0.f;
          Ps[(ty * 4 + i) * LDP + tx + 16 * j] = st[i][j];
        }
      }
      // dp^T = v do^T, then ds^T = p^T * (dp^T - delta), kept in registers
      float ds[4][4] = {};
      dot_rows(ds, Vs, ty * 4, dOs, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ds[i][j] = st[i][j] * (ds[i][j] - dlt_c[j]);
      __syncthreads();  // p^T written
      mul_tile(dva, Ps, ty * 4, dOs, tx);
      __syncthreads();  // p^T reads done
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDP + tx + 16 * j] = ds[i][j];
      __syncthreads();
      mul_tile(dka, Ps, ty * 4, Qs, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= Skv) continue;
    const long o = (((long)b * Skv + kpos) * kvH + kh) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      put(dk + o + tx + 16 * j, dka[i][j] * scale);
      put(dv + o + tx + 16 * j, dva[i][j]);
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int kvH, int Sq, int Skv, float scale, int causal, int window,
              cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes<T>() + sizeof(float) * BM * LDP;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, kvH, Sq, Skv, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int kvH, int Sq, int Skv, float scale,
               int causal, int window, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes<T>() + sizeof(float) * BM * LDP;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + BN - 1) / BN, B * kvH);
  flash_bwd_dkv_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, kvH, Sq, Skv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (0 = ok).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int dtype, int B,
                            int H, int kvH, int Sq, int Skv, float scale,
                            int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H, kvH,
                                    Sq, Skv, scale, causal, window, s);
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, B, H, kvH, Sq, Skv,
                          scale, causal, window, s);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             int dtype, int B, int H, int kvH, int Sq,
                             int Skv, float scale, int causal, int window,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                     kvH, Sq, Skv, scale, causal, window, s);
  return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, H, kvH, Sq,
                           Skv, scale, causal, window, s);
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
