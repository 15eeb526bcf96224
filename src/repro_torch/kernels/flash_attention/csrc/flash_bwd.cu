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
// What bounds it on the card: arithmetic. Per visible (q, k) pair the dq
// kernel does 3 products of 2 hd operations (s, dp, dq) and the dkv kernel 4
// (s, dp, dv, dk), on O(S * hd) bytes, so both sit far above the card's
// operations-per-byte ridge and the bound is the bf16 tensor cores' rate.
//
// bfloat16 (the training path): the tensor-core kernels in namespace `tc`.
// - All products are m64n64k16 `wgmma`s, bf16 operands, float32 sums. The
//   first two of each kernel (s and dp) read both operands from shared
//   memory; the others (dq += ds k; dv += p^T do, dk += ds^T q) take p or ds
//   from the accumulator registers as the A operand: the accumulator's
//   layout is the register operand's, so p and ds never touch shared
//   memory. Their B (k; do, q) is the same shared tile the first products
//   read K-major, now read MN-major.
// - p and ds go in as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi),
//   each its own wgmma. With hi alone (FlashAttention's rounding) the
//   rounding of p / ds puts ~1e-3 of absolute error on the grads' smallest
//   values, past the gate of one bf16 step of the output plus 1e-3 that the
//   CUDA-core version met; the split keeps ~2^-16 of each term, at the cost
//   of 4 products instead of 3 in dq and 6 instead of 4 in dkv (about a
//   fifth and a quarter more time).
// - Tiles arrive by TMA, 128-byte swizzled to match the wgmma descriptors,
//   completion counted on mbarriers. The streamed tiles go through a ring of
//   two stages (K and V in dq, Q and dO in dkv, each in its own buffer):
//   while the block computes on one stage, the next is in flight, and one
//   thread refills a stage once the whole warpgroup is done with it. Rows
//   past the sequence read as zeros (TMA's out-of-bounds fill), and the mask
//   zeroes their p.
// - One warpgroup (128 threads) per 64-row tile, ~98 KB of shared memory and
//   at most 255 registers a thread, so two blocks share an SM and one's
//   exp / mask work overlaps the other's products. The dq block keeps Q and
//   dO resident, the dkv block K and V and its two 64 x 128 f32
//   accumulators (dk, dv) in registers; lse and delta of the streamed q
//   tile are staged per stage in shared memory (they are per column there).
//   64-row kv tiles give dkv B * kvH * Skv / 64 = 512 blocks at the protocol
//   shape, about two waves of the 264 that fit; 128-row tiles would give
//   256 blocks in one uneven wave and need twice the accumulator registers.
// - Blocks are numbered heaviest causal tile first over the whole grid (the
//   last q tiles for dq, the first kv tiles for dkv).
// float32 (the card-against-CPU reference runs, whose gate TF32 would not
// hold): the CUDA-core kernels below, each thread owning a 4 x 4 tile of a
// 64 x 64 score block and a 4 x 8 tile of its 64 x 128 accumulators.
//
// Work split. dq: one block per (64-row q tile, row of B*H), looping over
// the kv tiles its rows can see (the TPU grid's sequential kv axis). dk /
// dv: one block per (64-row kv tile, batch row, kv head), looping over the
// rep = H / kvH query heads that share the kv head and, for each, over the
// q tiles that can see the kv tile: the GQA sum over the shared heads
// happens in float32 registers, not in a repeated copy summed after. No
// atomics anywhere: every output element is written once by one thread
// after a fixed-order sum, so two launches give bit-equal dq, dk and dv (the
// MDA selection over sums of these gradients must repeat).
//
// Layout: q, o, do, dq [B, Sq, H, 128]; k, v, dk, dv [B, Skv, kvH, 128],
// contiguous, float32 or bfloat16 (the wrapper zero-pads hd up to 128);
// lse, delta [B, H, Sq] float32. Each launch reports cudaGetLastError().

#include "tiles.cuh"

namespace {

constexpr int HD = 128;        // head dim (padded)
constexpr int BM = 64;         // q rows per tile
constexpr int BN = 64;         // kv rows per tile
constexpr int NT = 256;        // threads per block, as 16 x 16
constexpr int LDP = BN + 1;    // row pitch of the float32 p / ds tile

// float32 CUDA-core kernels. Row pitch of a [64][128] tile: an odd
// number of 32-bit words (conflict-free column reads).
constexpr int LD = HD + 1;
constexpr size_t TILE_BYTES = sizeof(float) * BM * LD;

// dst[r][d] = src[(r0 + r) * row_stride + d], zero for rows at or past
// n_rows (the ragged edge: uninitialised shared memory could hold NaN).
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long row_stride, int r0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float val = 0.f;
    if (r0 + r < n_rows) val = src[(long)(r0 + r) * row_stride + d];
    dst[r * LD + d] = val;
  }
}

using tiles::visible;

// acc[i][j] (+)= sum_d A[ra + i][d] * B[rb + 16 j][d]: 4 rows of A against
// 4 rows of B, both [64][128] tiles
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* A,
                                         int ra, const float* Bt, int rb) {
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = Bt[(rb + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
}

// out[i][j] += sum_c P[r0 + i][c] * X[c][tx + 16 j]: a float32 [64][64]
// tile times a [64][128] tile
__device__ __forceinline__ void mul_tile(float (&out)[4][8], const float* P,
                                         int r0, const float* X, int tx) {
#pragma unroll 4
  for (int c = 0; c < BN; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(r0 + i) * LDP + c];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = X[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][j] = fmaf(p[i], x, out[i][j]);
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int kvH, int Sq, int Skv, float scale, int causal,
                    int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                   // [BM][LD]
  float* dOs = reinterpret_cast<float*>(smem + TILE_BYTES);     // [BM][LD]
  float* KVs = reinterpret_cast<float*>(smem + 2 * TILE_BYTES);  // K, V, K
  float* dSs = reinterpret_cast<float*>(smem + 3 * TILE_BYTES);

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / kvH);
  const int q0 = qt * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int off = Skv - Sq;
  const long q_stride = (long)H * HD, kv_stride = (long)kvH * HD;
  const float* kb = k + ((long)b * Skv * kvH + kh) * HD;
  const float* vb = v + ((long)b * Skv * kvH + kh) * HD;

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
    float* row = dq + (((long)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) row[tx + 16 * j] = acc[i][j] * scale;
  }
}

__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int kvH, int Sq, int Skv,
                     float scale, int causal, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);                   // [BN][LD]
  float* Vs = reinterpret_cast<float*>(smem + TILE_BYTES);
  float* Qs = reinterpret_cast<float*>(smem + 2 * TILE_BYTES);  // [BM][LD]
  float* dOs = reinterpret_cast<float*>(smem + 3 * TILE_BYTES);
  float* Ps = reinterpret_cast<float*>(smem + 4 * TILE_BYTES);  // p^T, ds^T

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
    const float* qb = q + ((long)b * Sq * H + h) * HD;
    const float* dob = dout + ((long)b * Sq * H + h) * HD;
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
      dk[o + tx + 16 * j] = dka[i][j] * scale;
      dv[o + tx + 16 * j] = dva[i][j];
    }
  }
}

int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int B, int H, int kvH, int Sq, int Skv,
                  float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = 3 * TILE_BYTES + sizeof(float) * BM * LDP;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), H, kvH, Sq, Skv, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int kvH, int Sq, int Skv,
                   float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = 4 * TILE_BYTES + sizeof(float) * BM * LDP;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + BN - 1) / BN, B * kvH);
  flash_bwd_dkv_kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), H, kvH, Sq, Skv,
      scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA ring
// ---------------------------------------------------------------------------
namespace tc {

using tiles::edge_tile;
using tiles::keep;
using tiles::kmajor;
using tiles::load_tile;
using tiles::LOG2E;
using tiles::mnmajor;
using tiles::TILE;

constexpr int NT = 128;                 // one warpgroup
constexpr int STAGES = 2;               // ring depth of the streamed tiles
// dynamic shared memory: six tiles, lse / delta slices, barriers, and the
// slack that aligns the tiles to 1024 bytes
constexpr int SMEM = 1024 + 6 * TILE + 2 * STAGES * 64 * 4 + 64;

__global__ void __launch_bounds__(NT, 2)
dq_kernel(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __grid_constant__ CUtensorMap mdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int BH, int H, int kvH, int Sq,
          int Skv, float scale, int causal, int window) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + TILE;
  const uint32_t ring = base + 2 * TILE;         // stage s: K, then V
  const uint32_t bar = ring + STAGES * 2 * TILE;  // Q / dO, then stage s

  // heaviest causal tiles (the last q rows) first, over the whole grid
  const int qt = gridDim.x / BH - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kh = h / (H / kvH);
  const int q0 = qt * 64, off = Skv - Sq;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (tid % 4);                     // columns 8 i + c0 + {0, 1}

  // the kv tiles any row of this q tile can see
  const int q_last = min(q0 + 64, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) {
    kv_hi = min(Skv, q_last + off + 1);
    if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  }
  const int t0 = kv_lo / 64;
  const int n = max(0, (kv_hi + 63) / 64 - t0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) sm90::mbar_init(bar + 8 * s, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar, 2 * TILE);
    load_tile(sQ, &mq, bar, h, q0, b);
    load_tile(sdO, &mdo, bar, h, q0, b);
    for (int s = 0; s < STAGES && s < n; ++s) {
      const uint32_t bs = bar + 8 * (1 + s), st = ring + s * 2 * TILE;
      sm90::mbar_expect_tx(bs, 2 * TILE);
      load_tile(st, &mk, bs, kh, (t0 + s) * 64, b);
      load_tile(st + TILE, &mv, bs, kh, (t0 + s) * 64, b);
    }
  }
  float lse2[2], dlt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = q0 + r0 + 8 * e;
    lse2[e] = qpos < Sq ? lse[(long)bh * Sq + qpos] * LOG2E : 0.f;
    dlt[e] = qpos < Sq ? delta[(long)bh * Sq + qpos] : 0.f;
  }
  const float scale2 = scale * LOG2E;
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
  sm90::mbar_wait(bar, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    const uint32_t sK = ring + s * 2 * TILE, sV = sK + TILE;
    const int k0 = (t0 + j) * 64;
    sm90::mbar_wait(bar + 8 * (1 + s), (j / STAGES) & 1);

    float st[32], dp[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_ss(st, kmajor(sQ, kk), kmajor(sK, kk), kk);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_ss(dp, kmajor(sdO, kk), kmajor(sV, kk), kk);
    sm90::wgmma_commit();

    // p = exp(s * scale - lse), masked, while dp finishes
    sm90::wgmma_wait<1>();
    sm90::fence_regs(st);
    const bool edge = edge_tile(q0, k0, Sq, Skv, off, causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + 8 * ((i % 4) / 2), col = 8 * (i / 4) + c0 + i % 2;
      float p = exp2f(st[i] * scale2 - lse2[(i % 4) / 2]);
      if (edge && !visible(q0 + row, k0 + col, Sq, Skv, off, causal, window))
        p = 0.f;
      st[i] = p;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
    // ds = p * (dp - delta), as bf16 hi + lo A operands
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = st[i] * (dp[i] - dlt[(i % 4) / 2]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(dp, kk, hi[kk], lo[kk]);

    // dq += ds k (k read MN-major from the same stage)
    sm90::wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs(acc[hh], hi[kk], mnmajor(sK, hh, kk));
        sm90::wgmma_rs(acc[hh], lo[kk], mnmajor(sK, hh, kk));
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    keep(hi);
    keep(lo);
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);

    __syncthreads();  // every read of stage s is done: refill it
    if (tid == 0 && j + STAGES < n) {
      const uint32_t bs = bar + 8 * (1 + s);
      const int kn = (t0 + j + STAGES) * 64;
      sm90::mbar_expect_tx(bs, 2 * TILE);
      load_tile(sK, &mk, bs, kh, kn, b);
      load_tile(sV, &mv, bs, kh, kn, b);
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = q0 + r0 + 8 * e;
    if (qpos >= Sq) continue;
    __nv_bfloat16* row = dq + (((long)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(row + 64 * hh + 8 * i + c0) =
            sm90::pack_bf16(acc[hh][4 * i + 2 * e] * scale,
                            acc[hh][4 * i + 2 * e + 1] * scale);
  }
}

__global__ void __launch_bounds__(NT, 2)
dkv_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const __grid_constant__ CUtensorMap mdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int BkvH, int H, int kvH, int Sq, int Skv, float scale, int causal,
           int window) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + TILE;
  const uint32_t ring = base + 2 * TILE;         // stage s: Q, then dO
  const uint32_t vecs = ring + STAGES * 2 * TILE;
  const uint32_t bar = vecs + 2 * STAGES * 64 * 4;  // K / V, then stage s
  // [stage][lse * log2 e, delta][64 q columns]
  float(*vec)[2][64] =
      reinterpret_cast<float(*)[2][64]>(smem_raw + (vecs - raw));

  // causal: the first kv tiles are seen by the most q rows, so go first
  const int kt = blockIdx.x / BkvH;
  const int bk = blockIdx.x % BkvH;
  const int b = bk / kvH, kh = bk % kvH;
  const int rep = H / kvH;
  const int k0 = kt * 64, off = Skv - Sq;
  const int tid = threadIdx.x;
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;  // kv rows r0, r0 + 8
  const int c0 = 2 * (tid % 4);                     // q columns 8 i + c0 + {0, 1}

  // the q tiles that can see any key of this kv tile, for each shared head
  const int k_last = min(k0 + 64, Skv) - 1;
  int q_lo = 0, q_hi = Sq;
  if (causal) {
    q_lo = max(0, k0 - off);
    if (window > 0) q_hi = min(Sq, k_last - off + window);
  }
  const int t0 = q_lo / 64;
  const int nq = max(0, (q_hi + 63) / 64 - t0);
  const int n = rep * nq;  // step j: head kh * rep + j / nq, q tile t0 + j % nq

  // step j's lse (times log2 e) and delta into the vector slot of its stage
  auto load_vecs = [&](int j) {
    const int hq = kh * rep + j / nq, qpos = (t0 + j % nq) * 64 + tid % 64;
    const float* src = tid < 64 ? lse : delta;
    float x = qpos < Sq ? src[((long)b * H + hq) * Sq + qpos] : 0.f;
    vec[j % STAGES][tid / 64][tid % 64] = tid < 64 ? x * LOG2E : x;
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) sm90::mbar_init(bar + 8 * s, 1);
    sm90::mbar_fence_init();
  }
  if (n > 0) load_vecs(0);
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar, 2 * TILE);
    load_tile(sK, &mk, bar, kh, k0, b);
    load_tile(sV, &mv, bar, kh, k0, b);
    for (int s = 0; s < STAGES && s < n; ++s) {
      const uint32_t bs = bar + 8 * (1 + s), st = ring + s * 2 * TILE;
      const int hq = kh * rep + s / nq, qn = (t0 + s % nq) * 64;
      sm90::mbar_expect_tx(bs, 2 * TILE);
      load_tile(st, &mq, bs, hq, qn, b);
      load_tile(st + TILE, &mdo, bs, hq, qn, b);
    }
  }
  const float scale2 = scale * LOG2E;
  float dka[2][32], dva[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[0][i] = dka[1][i] = dva[0][i] = dva[1][i] = 0.f;
  sm90::mbar_wait(bar, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    const uint32_t sQ = ring + s * 2 * TILE, sdO = sQ + TILE;
    const int q0 = (t0 + j % nq) * 64;
    sm90::mbar_wait(bar + 8 * (1 + s), (j / STAGES) & 1);

    // s^T = k q^T and dp^T = v do^T: kv rows x q columns
    float st[32], dp[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_ss(st, kmajor(sK, kk), kmajor(sQ, kk), kk);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      sm90::wgmma_ss(dp, kmajor(sV, kk), kmajor(sdO, kk), kk);
    sm90::wgmma_commit();

    // p^T, masked; then dv += p^T do while dp^T finishes
    sm90::wgmma_wait<1>();
    sm90::fence_regs(st);
    const float* lse2 = vec[s][0];
    const float* dlt = vec[s][1];
    const bool edge = edge_tile(q0, k0, Sq, Skv, off, causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + 8 * ((i % 4) / 2), col = 8 * (i / 4) + c0 + i % 2;
      float p = exp2f(st[i] * scale2 - lse2[col]);
      if (edge && !visible(q0 + col, k0 + row, Sq, Skv, off, causal, window))
        p = 0.f;
      st[i] = p;
    }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(st, kk, hi[kk], lo[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs(dva[hh], hi[kk], mnmajor(sdO, hh, kk));
        sm90::wgmma_rs(dva[hh], lo[kk], mnmajor(sdO, hh, kk));
      }
    sm90::wgmma_commit();

    // ds^T = p^T * (dp^T - delta); dk += ds^T q. The p operands are held
    // until dv is done, so the ds operands reuse their registers.
    sm90::wgmma_wait<0>();
    keep(hi);
    keep(lo);
    sm90::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + c0 + i % 2;
      dp[i] = st[i] * (dp[i] - dlt[col]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(dp, kk, hi[kk], lo[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs(dka[hh], hi[kk], mnmajor(sQ, hh, kk));
        sm90::wgmma_rs(dka[hh], lo[kk], mnmajor(sQ, hh, kk));
      }
    sm90::wgmma_commit();
    // the next step's vector slot was last read a step ago
    if (j + 1 < n) load_vecs(j + 1);
    sm90::wgmma_wait<0>();
    keep(hi);
    keep(lo);
    sm90::fence_regs(dva[0]);
    sm90::fence_regs(dva[1]);
    sm90::fence_regs(dka[0]);
    sm90::fence_regs(dka[1]);

    __syncthreads();  // every read of stage s is done: refill it
    if (tid == 0 && j + STAGES < n) {
      const uint32_t bs = bar + 8 * (1 + s);
      const int jn = j + STAGES;
      const int hq = kh * rep + jn / nq, qn = (t0 + jn % nq) * 64;
      sm90::mbar_expect_tx(bs, 2 * TILE);
      load_tile(sQ, &mq, bs, hq, qn, b);
      load_tile(sdO, &mdo, bs, hq, qn, b);
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kpos = k0 + r0 + 8 * e;
    if (kpos >= Skv) continue;
    const long o = (((long)b * Skv + kpos) * kvH + kh) * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 64 * hh + 8 * i + c0;
        *reinterpret_cast<uint32_t*>(dk + o + c) =
            sm90::pack_bf16(dka[hh][4 * i + 2 * e] * scale,
                            dka[hh][4 * i + 2 * e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o + c) =
            sm90::pack_bf16(dva[hh][4 * i + 2 * e], dva[hh][4 * i + 2 * e + 1]);
      }
  }
}

// the four operands' tensor maps; false if one cannot be encoded
inline bool maps(CUtensorMap (&m)[4], const void* q, const void* k,
                 const void* v, const void* dout, int B, int H, int kvH,
                 int Sq, int Skv) {
  return sm90::bshd_map(&m[0], q, B, Sq, H) &&
         sm90::bshd_map(&m[1], k, B, Skv, kvH) &&
         sm90::bshd_map(&m[2], v, B, Skv, kvH) &&
         sm90::bshd_map(&m[3], dout, B, Sq, H);
}

int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int kvH, int Sq, int Skv, float scale, int causal, int window,
              cudaStream_t stream) {
  CUtensorMap m[4];
  if (!maps(m, q, k, v, dout, B, H, kvH, Sq, Skv))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = (Sq + 63) / 64 * B * H;
  dq_kernel<<<grid, NT, SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq),
      B * H, H, kvH, Sq, Skv, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int kvH, int Sq, int Skv, float scale,
               int causal, int window, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!maps(m, q, k, v, dout, B, H, kvH, Sq, Skv))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = (Skv + 63) / 64 * B * kvH;
  dkv_kernel<<<grid, NT, SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B * kvH, H, kvH, Sq, Skv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns
// cudaGetLastError() (0 = ok).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int dtype, int B,
                            int H, int kvH, int Sq, int Skv, float scale,
                            int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return tc::launch_dq(q, k, v, dout, lse, delta, dq, B, H, kvH, Sq, Skv,
                         scale, causal, window, s);
  return launch_dq_f32(q, k, v, dout, lse, delta, dq, B, H, kvH, Sq, Skv,
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
    return tc::launch_dkv(q, k, v, dout, lse, delta, dk, dv, B, H, kvH, Sq,
                          Skv, scale, causal, window, s);
  return launch_dkv_f32(q, k, v, dout, lse, delta, dk, dv, B, H, kvH, Sq,
                           Skv, scale, causal, window, s);
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
