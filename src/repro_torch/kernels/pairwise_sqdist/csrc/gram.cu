// Gram matrices of replica stacks for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_gram_kernel` built by `gram_pallas_call`
// (src/repro/kernels/pairwise_sqdist/kernel.py): the float32 Gram X X^T of an
// [n, d] stack, accumulated over d. The wrapper turns it into squared
// distances d2 = max(diag + diag^T - 2G, 0), as ops.py does in JAX.
//
// What bounds it on the card: memory. n is tiny (n <= 64; 7 on the training
// path) and d is large (a model's 1.1 M parameters), so every element is read
// once for about n/2 multiply-adds: n/2 FLOP for 4 bytes, far under the
// card's ~20 FLOP per byte of f32 CUDA-core arithmetic. What the design does
// about it: the TPU kernel walks d in one sequential grid and keeps the
// [n, n] sum resident; Hopper runs blocks in no order, so d is split into
// chunks across blocks (a batch of B stacks adds blockIdx.y), every block
// stages [n, 128]-column tiles of its chunk in shared memory with coalesced
// row loads, and its threads accumulate the n(n+1)/2 products of the upper
// triangle in float32 registers (with few pairs, several threads split each
// pair's columns, so the block stays busy). Each block writes its partial
// triangle to a scratch buffer; a second kernel adds the partials of every
// pair in chunk order and mirrors the triangle. No atomics, so the result
// repeats bit for bit from run to run (the MDA selection built on it must).
//
// Layout: x [B, n, d] float32 row-major; partial [B, C, P] scratch with
// C = number of chunks, P = n(n+1)/2; g [B, n, n] float32.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads of a block
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
// n(n+1)/2 floats. Returns cudaGetLastError() (0 = ok).
extern "C" int gram_f32(const float* x, float* partial, float* g, int B,
                        int n, long long d, long long chunk, int n_chunks,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > MAXN || B < 1 || B > 65535 || d < 1 || chunk < 1 ||
      chunk % TW != 0 || n_chunks < 1 || (long long)(n_chunks - 1) * chunk >= d)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * (TW + 1) * sizeof(float);
  gram_partial_kernel<<<dim3(n_chunks, B), NT, smem, s>>>(x, partial, n, d,
                                                          chunk, n_chunks);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  gram_finish_kernel<<<B, 256, 0, s>>>(partial, g, n, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
