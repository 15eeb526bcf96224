// Gram matrices of replica stacks for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_gram_kernel` built by `gram_pallas_call`
// (src/repro/kernels/pairwise_sqdist/kernel.py): the float32 Gram X X^T of an
// [n, d] stack, accumulated over d. The wrapper turns it into squared
// distances d2 = max(diag + diag^T - 2G, 0), as ops.py does in JAX.
//
// What bounds it on the card: memory. n is tiny (4 or 7 on the training
// paths) and d is large (1.1 M to 816 M parameters), so every element is
// read once for (n + 1) / 2 multiply-adds: far under the CUDA cores' ~10
// FMA per byte. The design goal is bytes in flight, not arithmetic. The
// TPU kernel walks d in one sequential grid and keeps the [n, n] sum
// resident; Hopper runs blocks in no order, so d is split into chunks of
// whole 128-column tiles across blocks (a batch of B stacks adds
// blockIdx.y), each block writes its partial upper triangle to a scratch
// buffer, and a second kernel adds the partials of every pair in chunk
// order and mirrors the triangle.
//
// n <= 8 (every caller on the training paths): `gram_reg_kernel<N, V>`.
// Each thread loads V consecutive floats (one 16-, 8- or 4-byte load) of
// every row at the same column, U such column groups before any FMA, so
// N * U * 4V bytes per thread are in flight; no shared-memory staging and
// no barrier in the main loop. Columns go to threads in a fixed
// grid-stride order and the N(N+1)/2 sums stay in f32 registers. The
// block's sums are reduced in a fixed order: shuffles in a fixed xor order
// within a warp, then the warps in index order through shared memory.
// No TF32 (three decimal digits; the exact-f32 reference forbids it).
// 8 < n <= 64: `gram_partial_kernel`, which stages [n, 128]-column tiles in
// shared memory and lets several threads split each pair's columns.
// No atomics anywhere, so the result repeats bit for bit from run to run
// (the MDA selection built on it must). All addressing is 64-bit.
//
// Layout: x [B, n, d] float32 row-major; partial [B, C, P] scratch with
// C = number of chunks, P = n(n+1)/2; g [B, n, n] float32.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads of a block
constexpr int NW = NT / 32;    // warps of a block
constexpr int MAXN_REG = 8;    // largest n of the register kernel
constexpr int TW = 128;        // columns of a staged tile
constexpr int MAXN = 64;
constexpr int MAXP = MAXN * (MAXN + 1) / 2;
constexpr int RMAX = (MAXP + NT - 1) / NT;  // slots a thread may own

__device__ __forceinline__ void pair_of(int p, int n, int& i, int& j) {
  i = 0;
  while (p >= n - i) {
    p -= n - i;
    ++i;
  }
  j = i + p;
}

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<1> { using T = float; };
__device__ __forceinline__ float at(float4 a, int k) {
  return k == 0 ? a.x : k == 1 ? a.y : k == 2 ? a.z : a.w;
}
__device__ __forceinline__ float at(float2 a, int k) { return k == 0 ? a.x : a.y; }
__device__ __forceinline__ float at(float a, int) { return a; }

// acc[pairs of the upper triangle, row-major] += the V columns of r
template <int N, int V, typename T>
__device__ __forceinline__ void fma_group(float* acc, const T (&r)[N]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    int p = 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i; j < N; ++j, ++p)
        acc[p] = fmaf(at(r[i], k), at(r[j], k), acc[p]);
  }
}

// One block per (chunk, stack): the partial Gram of columns
// [c * chunk, min((c + 1) * chunk, d)) of stack b. d and chunk are
// multiples of V and x is 4V-byte aligned (the wrapper's launch plan).
template <int N, int V>
__global__ void __launch_bounds__(NT)
gram_reg_kernel(const float* __restrict__ x, float* __restrict__ partial,
                long long d, long long chunk, int n_chunks) {
  using T = typename Vec<V>::T;
  constexpr int P = N * (N + 1) / 2;
  // column groups in flight per thread: about 32 floats, 2 to 4 groups
  constexpr int U = (32 + N * V - 1) / (N * V) < 2   ? 2
                    : (32 + N * V - 1) / (N * V) > 4 ? 4
                    : (32 + N * V - 1) / (N * V);
  __shared__ float red[NW][P];
  const int c = blockIdx.x, b = blockIdx.y;
  const long long c0 = (long long)c * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;
  const long long groups = (c1 - c0) / V;
  const T* rows[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    rows[i] = reinterpret_cast<const T*>(x + ((long long)b * N + i) * d + c0);

  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  long long g = threadIdx.x;
  for (; g + (U - 1) * NT < groups; g += U * NT) {
    T r[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < N; ++i) r[u][i] = __ldg(rows[i] + g + u * NT);
#pragma unroll
    for (int u = 0; u < U; ++u) fma_group<N, V>(acc, r[u]);
  }
  for (; g < groups; g += NT) {
    T r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = __ldg(rows[i] + g);
    fma_group<N, V>(acc, r);
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v = acc[p];
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][p] = v;
  }
  __syncthreads();
  if (threadIdx.x < P) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NW; ++w) s += red[w][threadIdx.x];
    partial[((long long)b * n_chunks + c) * P + threadIdx.x] = s;
  }
}

template <int N, int V>
int launch_reg(const float* x, float* partial, int B, long long d,
               long long chunk, int n_chunks, cudaStream_t s) {
  gram_reg_kernel<N, V><<<dim3(n_chunks, B), NT, 0, s>>>(x, partial, d, chunk,
                                                         n_chunks);
  return (int)cudaGetLastError();
}

template <int N>
int launch_reg(const float* x, float* partial, int B, long long d,
               long long chunk, int n_chunks, int vec, cudaStream_t s) {
  if (vec == 4) return launch_reg<N, 4>(x, partial, B, d, chunk, n_chunks, s);
  if (vec == 2) return launch_reg<N, 2>(x, partial, B, d, chunk, n_chunks, s);
  return launch_reg<N, 1>(x, partial, B, d, chunk, n_chunks, s);
}

int launch_reg(const float* x, float* partial, int B, int n, long long d,
               long long chunk, int n_chunks, int vec, cudaStream_t s) {
  switch (n) {
    case 1: return launch_reg<1>(x, partial, B, d, chunk, n_chunks, vec, s);
    case 2: return launch_reg<2>(x, partial, B, d, chunk, n_chunks, vec, s);
    case 3: return launch_reg<3>(x, partial, B, d, chunk, n_chunks, vec, s);
    case 4: return launch_reg<4>(x, partial, B, d, chunk, n_chunks, vec, s);
    case 5: return launch_reg<5>(x, partial, B, d, chunk, n_chunks, vec, s);
    case 6: return launch_reg<6>(x, partial, B, d, chunk, n_chunks, vec, s);
    case 7: return launch_reg<7>(x, partial, B, d, chunk, n_chunks, vec, s);
    default: return launch_reg<8>(x, partial, B, d, chunk, n_chunks, vec, s);
  }
}

__global__ void __launch_bounds__(NT)
gram_partial_kernel(const float* __restrict__ x, float* __restrict__ partial,
                    int n, long long d, long long chunk, int n_chunks) {
  extern __shared__ float tile[];          // [n][TW + 1]
  __shared__ float red[RMAX * NT];
  const int P = n * (n + 1) / 2;
  const int L = P <= NT ? NT / P : 1;      // threads per pair
  const int slots = P * L;
  const int c = blockIdx.x, b = blockIdx.y;
  const float* xb = x + (long long)b * n * d;
  const long long c0 = (long long)c * chunk;
  const long long c1 = c0 + chunk < d ? c0 + chunk : d;

  int pi[RMAX], pj[RMAX], lane[RMAX];
  float acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int slot = threadIdx.x + r * NT;
    acc[r] = 0.f;
    lane[r] = slot % L;
    pi[r] = pj[r] = -1;
    if (slot < slots) pair_of(slot / L, n, pi[r], pj[r]);
  }
  for (long long t0 = c0; t0 < c1; t0 += TW) {
    for (int idx = threadIdx.x; idx < n * TW; idx += NT) {
      const int row = idx / TW, col = idx % TW;
      const long long g = t0 + col;
      tile[row * (TW + 1) + col] = g < c1 ? xb[(long long)row * d + g] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (pi[r] < 0) continue;
      const float* a = tile + pi[r] * (TW + 1);
      const float* bb = tile + pj[r] * (TW + 1);
      float s = acc[r];
      for (int k = lane[r]; k < TW; k += L) s = fmaf(a[k], bb[k], s);
      acc[r] = s;
    }
    __syncthreads();
  }
  // add the lanes of each pair in lane order
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int slot = threadIdx.x + r * NT;
    if (slot < slots) red[slot] = acc[r];
  }
  __syncthreads();
  float* out = partial + ((long long)b * n_chunks + c) * P;
  for (int p = threadIdx.x; p < P; p += NT) {
    float s = red[p * L];
    for (int l = 1; l < L; ++l) s += red[p * L + l];
    out[p] = s;
  }
}

__global__ void gram_finish_kernel(const float* __restrict__ partial,
                                   float* __restrict__ g, int n,
                                   int n_chunks) {
  const int P = n * (n + 1) / 2;
  const int b = blockIdx.x;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float* src = partial + (long long)b * n_chunks * P + p;
    float s = src[0];
    for (int c = 1; c < n_chunks; ++c) s += src[(long long)c * P];
    int i, j;
    pair_of(p, n, i, j);
    g[((long long)b * n + i) * n + j] = s;
    g[((long long)b * n + j) * n + i] = s;
  }
}

}  // namespace

// x [B, n, d] float32, 1 <= n <= 64, 1 <= B <= 65535; chunk a multiple of
// 128 with n_chunks = ceil(d / chunk); partial holds B * n_chunks *
// n(n+1)/2 floats. vec: floats per load of the register kernel (n <= 8):
// 4, 2 or 1, dividing d, with x aligned to 4 * vec bytes; 1 for n > 8.
// Returns cudaGetLastError() (0 = ok).
extern "C" int gram_f32(const float* x, float* partial, float* g, int B,
                        int n, long long d, long long chunk, int n_chunks,
                        int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > MAXN || B < 1 || B > 65535 || d < 1 || chunk < 1 ||
      chunk % TW != 0 || n_chunks < 1 || (long long)(n_chunks - 1) * chunk >= d)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (n <= MAXN_REG) {
    if ((vec != 1 && vec != 2 && vec != 4) || d % vec != 0 ||
        reinterpret_cast<unsigned long long>(x) % (4 * vec) != 0)
      return (int)cudaErrorInvalidValue;
    rc = launch_reg(x, partial, B, n, d, chunk, n_chunks, vec, s);
  } else {
    if (vec != 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)n * (TW + 1) * sizeof(float);
    gram_partial_kernel<<<dim3(n_chunks, B), NT, smem, s>>>(x, partial, n, d,
                                                            chunk, n_chunks);
    rc = (int)cudaGetLastError();
  }
  if (rc != 0) return rc;
  gram_finish_kernel<<<B, 256, 0, s>>>(partial, g, n, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
