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
// The loop over kv tiles inside a block takes the place of the TPU grid's
// sequential kv axis. kv tiles that no row of a q tile can see (past the
// causal edge, before the window) are skipped: for every row with a visible
// key this gives the same result as the TPU kernel, which runs them and
// lets the exp(NEG - m) = 0 correction wipe their contribution. Rows never
// mix, so a row's result does not depend on how many rows share the
// launch. GQA: q head h reads kv head h / (H / kvH) in place (no repeated
// copy of k / v). No atomics: two launches are bit-equal.
//
// bfloat16 (serving's prefill, the training path): the tensor-core kernel
// in namespace `tc`.
// - One block per 128-row q tile of one (b, h): two consumer warpgroups of
//   64 rows each and one producer warp (288 threads, one block per SM).
//   Blocks are numbered heaviest causal tile first over the whole grid.
// - The producer thread loads both warpgroups' Q tiles once and streams K
//   and V through a three-stage ring by TMA (128-byte swizzle, the wgmma
//   descriptors' layout; rows past S read as zeros). K and V of a stage
//   have their own full barriers, so s = q k^T starts before V lands; a
//   stage is refilled once all 128 threads of each active warpgroup have
//   arrived on its empty barrier. Both warpgroups read each K / V stage,
//   so a kv tile is read from shared memory once per 128 q rows.
// - s = q k^T: 8 m64n64k16 `wgmma`s, both operands K-major in shared
//   memory. Online softmax on the accumulator registers in base 2 (p =
//   2^(s scale log2 e - m scale log2 e), one FFMA and one `ex2` a score,
//   scale * log2 e folded in f32): each row's max from a shuffle among the
//   4 threads that hold it; l is summed per thread and combined once at
//   the end. Only edge tiles are masked.
// - Within a warpgroup, s of tile j is issued before o += p v of tile
//   j - 1, and the softmax of tile j runs while that second product does.
// - o += p v: p rounded once to bf16 (as the plain version rounds p to
//   v's dtype) and fed from registers as the A operand (the accumulator's
//   layout is the register operand's); v's B read MN-major from the same
//   swizzled tile. m, l and o stay in f32 registers (o: two 64 x 64 halves).
// - A warpgroup skips the kv tiles its own rows cannot see (the first
//   warpgroup the second's diagonal tile, the second a window's first
//   tile) but still waits for them to land and releases them. When the second warpgroup's rows all lie
//   past Sq it exits at once and the ring counts only the first.
// - Epilogue: o = acc / max(l, 1e-30) as bf16 pairs, lse = m scale + log l
//   (natural-log units of the scaled scores, as the plain version); rows
//   at or past Sq are not written.
// float32 (the card-against-CPU reference runs, whose 1e-5 gates TF32
// would not hold): the CUDA-core kernel below, each thread owning a 4x4
// tile of scores and a 4x8 tile of the output; Q / K / V tiles in shared
// memory as float32 with an odd row pitch (conflict-free column reads); K
// and V share one buffer so two blocks fit on an SM; one block of 256
// threads per (64-row q tile, row of B*H).
//
// Layout: q, o [B, Sq, H, 128]; k, v [B, Skv, kvH, 128], contiguous, float32
// or bfloat16; lse [B, H, Sq] float32. Each launch reports
// cudaGetLastError() to the caller.

#include "tiles.cuh"

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

// dst[r][d] = src[(r0 + r) * row_stride + d] * mul, zero for rows at or
// past n_rows (the ragged edge; uninitialised shared memory could hold NaN,
// and 0 * NaN would reach the output).
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long row_stride, int r0, int n_rows,
                                          float mul) {
  for (int idx = threadIdx.x; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    float val = 0.f;
    if (r0 + r < n_rows) val = src[(long)(r0 + r) * row_stride + d] * mul;
    dst[r * LD + d] = val;
  }
}

__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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

  const float* qb = q + ((long)b * Sq * H + h) * HD;
  const float* kb = k + ((long)b * Skv * kvH + kh) * HD;
  const float* vb = v + ((long)b * Skv * kvH + kh) * HD;
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
    float* orow = o + (((long)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < 8; ++j) orow[tx + 16 * j] = acc[i][j] / denom;
    if (tx == 0) lse[(long)bh * Sq + qpos] = m[i] + logf(denom);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int kvH, int Sq, int Skv,
               float scale, int causal, int window, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in, per device
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, kvH, Sq,
      Skv, scale, causal, window);
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
using tiles::visible;

constexpr int NWG = 2;              // consumer warpgroups, 64 q rows each
constexpr int NT = NWG * 128 + 32;  // and one producer warp
constexpr int STAGES = 3;           // ring depth of the K / V tiles
// barriers: Q; then K landed, V landed and released, for each stage
constexpr int NBAR = 1 + 3 * STAGES;
// dynamic shared memory: the Q tiles, the ring, the barriers, and the slack
// that aligns the tiles to 1024 bytes
constexpr int SMEM = 1024 + NWG * TILE + STAGES * 2 * TILE + 8 * NBAR;

// 2^x, results under 2^-126 flushed to zero (p of a masked key is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = q k^T for one 64 x 64 tile, issued and committed
__device__ __forceinline__ void issue_s(float (&st)[32], uint32_t sQ,
                                        uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    sm90::wgmma_ss(st, kmajor(sQ, kk), kmajor(sK, kk), kk);
  sm90::wgmma_commit();
}

// o += p v for one 64-row kv tile (both column halves), issued, committed
__device__ __forceinline__ void issue_pv(float (&acc)[2][32],
                                         const uint32_t (&p)[4][4],
                                         uint32_t sV) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_rs(acc[hh], p[kk], mnmajor(sV, hh, kk));
  sm90::wgmma_commit();
}

// One tile of the online softmax on the accumulator registers. Element i
// of `st` is row qr + 8 ((i % 4) / 2), column kc + 8 (i / 4) + i % 2.
// Masks the tile if it is an edge tile (raw score NEG), takes each row's
// new max of the raw scores (a shuffle among the 4 threads that hold the
// row), turns st into p = 2^((s - m) scale2) in place and rescales and
// adds this thread's part of l; corr = 2^((m_old - m) scale2) rescales o.
__device__ __forceinline__ void softmax_tile(float (&st)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool edge, int qr, int kc,
                                             int Sq, int Skv, int off,
                                             int causal, int window,
                                             float scale2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int e = (i % 4) / 2;
    if (edge && !visible(qr + 8 * e, kc + 8 * (i / 4) + i % 2, Sq, Skv, off,
                         causal, window))
      st[i] = NEG;
    mx[e] = fmaxf(mx[e], st[i]);
  }
  float ms[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    corr[e] = ex2((m[e] - mx[e]) * scale2);
    m[e] = mx[e];
    ms[e] = mx[e] * scale2;
    l[e] *= corr[e];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int e = (i % 4) / 2;
    st[i] = ex2(fmaf(st[i], scale2, -ms[e]));
    l[e] += st[i];
  }
}

__global__ void __launch_bounds__(NT, 1)
fwd_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int BH,
           int H, int kvH, int Sq, int Skv, float scale, int causal,
           int window) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;                  // warpgroup w: sQ + w * TILE
  const uint32_t ring = base + NWG * TILE;   // stage s: K, then V
  const uint32_t qbar = ring + STAGES * 2 * TILE;
  const uint32_t kfull = qbar + 8, vfull = kfull + 8 * STAGES,
                 empty = vfull + 8 * STAGES;  // + 8 s for stage s

  // heaviest causal tiles (the last q rows) first, over the whole grid
  const int qt = gridDim.x / BH - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH;
  const int b = bh / H, h = bh % H, kh = h / (H / kvH);
  const int q0 = qt * 128, off = Skv - Sq;
  const int nwg = q0 + 64 < Sq ? 2 : 1;  // warpgroups with rows below Sq

  // the keys [lo, hi) that rows qw .. qw + 63 can see
  auto kv_range = [&](int qw, int& lo, int& hi) {
    const int q_last = min(qw + 64, Sq) - 1;
    lo = 0;
    hi = Skv;
    if (causal) {
      hi = min(Skv, q_last + off + 1);
      if (window > 0) lo = max(0, qw + off - window + 1);
    }
  };
  int lo, hi, lo_last, hi_last;
  kv_range(q0, lo, hi);
  kv_range(q0 + 64 * (nwg - 1), lo_last, hi_last);
  const int t0 = lo / 64;                         // the block's kv tiles
  const int n = max(0, (hi_last + 63) / 64 - t0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(kfull + 8 * s, 1);
      sm90::mbar_init(vfull + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 128 * nwg);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NWG * 128) {  // the producer warp: one thread fills the ring
    if (tid == NWG * 128) {
      sm90::mbar_expect_tx(qbar, nwg * TILE);
      for (int w = 0; w < nwg; ++w)
        load_tile(sQ + w * TILE, &mq, qbar, h, q0 + 64 * w, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES, kn = (t0 + j) * 64;
        const uint32_t st = ring + s * 2 * TILE;
        if (j >= STAGES) sm90::mbar_wait(empty + 8 * s, (j / STAGES - 1) & 1);
        sm90::mbar_expect_tx(kfull + 8 * s, TILE);
        load_tile(st, &mk, kfull + 8 * s, kh, kn, b);
        sm90::mbar_expect_tx(vfull + 8 * s, TILE);
        load_tile(st + TILE, &mv, vfull + 8 * s, kh, kn, b);
      }
    }
    return;
  }
  const int w = tid / 128;
  if (w >= nwg) return;
  const int t = tid % 128;
  const int qw = q0 + 64 * w;
  kv_range(qw, lo, hi);
  const int jb = lo / 64 - t0, je = (hi + 63) / 64 - t0;  // this warpgroup's
  const uint32_t sQw = sQ + w * TILE;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (t % 4);                   // columns 8 i + c0 + {0, 1}
  const float scale2 = scale * LOG2E;
  auto stage = [&](int j) { return ring + (j % STAGES) * 2 * TILE; };
  auto landed = [&](uint32_t full, int j) {
    sm90::mbar_wait(full + 8 * (j % STAGES), (j / STAGES) & 1);
  };
  auto release = [&](int j) { sm90::mbar_arrive(empty + 8 * (j % STAGES)); };
  auto softmax = [&](float(&st)[32], float(&m)[2], float(&l)[2],
                     float(&corr)[2], int j) {
    const int k0 = (t0 + j) * 64;
    softmax_tile(st, m, l, corr,
                 edge_tile(qw, k0, Sq, Skv, off, causal, window), qw + r0,
                 k0 + c0, Sq, Skv, off, causal, window, scale2);
  };

  // the block's tiles that these rows cannot see: wait for them to land
  // (a stage is refilled only after its last load completed), release them
  for (int j = 0; j < jb; ++j) {
    landed(kfull, j);
    landed(vfull, j);
    release(j);
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, corr[2], st[32], acc[2][32];
  uint32_t p[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
  sm90::mbar_wait(qbar, 0);
  landed(kfull, jb);
  sm90::wgmma_fence();
  issue_s(st, sQw, stage(jb));
  sm90::wgmma_wait<0>();
  sm90::fence_regs(st);
  softmax(st, m, l, corr, jb);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a_hi(st, kk, p[kk]);

  // s of tile j on the tensor cores, then o += p v of tile j - 1; the
  // softmax of tile j runs while the second product does
  for (int j = jb + 1; j < je; ++j) {
    landed(kfull, j);
    landed(vfull, j - 1);
    sm90::wgmma_fence();
    issue_s(st, sQw, stage(j));
    issue_pv(acc, p, stage(j - 1) + TILE);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(st);
    softmax(st, m, l, corr, j);
    sm90::wgmma_wait<0>();
    keep(p);
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);
    release(j - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[0][i] *= corr[(i % 4) / 2];
      acc[1][i] *= corr[(i % 4) / 2];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a_hi(st, kk, p[kk]);
  }
  landed(vfull, je - 1);
  sm90::wgmma_fence();
  issue_pv(acc, p, stage(je - 1) + TILE);
  sm90::wgmma_wait<0>();
  keep(p);
  sm90::fence_regs(acc[0]);
  sm90::fence_regs(acc[1]);
  release(je - 1);
  for (int j = je; j < n; ++j) {
    landed(kfull, j);
    landed(vfull, j);
    release(j);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const int qpos = qw + r0 + 8 * e;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[e], 1e-30f);
    __nv_bfloat16* row = o + (((long)b * Sq + qpos) * H + h) * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(row + 64 * hh + 8 * i + c0) =
            sm90::pack_bf16(acc[hh][4 * i + 2 * e] / denom,
                            acc[hh][4 * i + 2 * e + 1] / denom);
    if (t % 4 == 0) lse[(long)bh * Sq + qpos] = m[e] * scale + logf(denom);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int kvH, int Sq, int Skv, float scale, int causal,
           int window, cudaStream_t stream) {
  CUtensorMap m[3];
  if (!sm90::bshd_map(&m[0], q, B, Sq, H) ||
      !sm90::bshd_map(&m[1], k, B, Skv, kvH) ||
      !sm90::bshd_map(&m[2], v, B, Skv, kvH))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = (Sq + 127) / 128 * B * H;
  fwd_kernel<<<grid, NT, SMEM, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(o), lse, B * H, H, kvH,
      Sq, Skv, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns
// cudaGetLastError() (0 = ok).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int dtype, int B, int H, int kvH, int Sq,
                         int Skv, float scale, int causal, int window,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return tc::launch(q, k, v, o, lse, B, H, kvH, Sq, Skv, scale, causal,
                      window, s);
  return launch_f32(q, k, v, o, lse, B, H, kvH, Sq, Skv, scale, causal,
                    window, s);
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
