// Subset diameters for exact MDA selection on Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_diam_kernel` built by `diam_pallas_call`
// (src/repro/kernels/mda_diameter/kernel.py): for every size-(n-f) subset of
// the n inputs, the largest squared distance between two of its members,
// -3.4e38 for an empty subset. The argmin over subsets and the enumeration
// of the subsets stay in agg/rules.py.
//
// What bounds it on the card: neither bytes nor operations at the training
// path's shapes — S = C(7, 5) = 21 subsets of n = 7 over a 7 x 7 matrix per
// receiver is a few hundred bytes and a few thousand compares, so its time is
// its launch. What the design does about it: one launch for a whole batch of
// receivers (blockIdx.y), each block staging its receiver's [n, n] matrix in
// shared memory, one thread per (receiver, subset); the subset masks arrive
// as uint64 bitmasks (n <= 64), built once per (n, f) on the host in
// itertools.combinations order and cached on the device, so a thread walks
// only its subset's members. A max does not depend on the order it is
// taken in, so the result is exact. NaN propagates, as jnp.max does.
//
// Layout: d2 [B, n, n] float32, masks [S] uint64, out [B, S] float32.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;
constexpr float NEG = -3.4e38f;

__global__ void __launch_bounds__(NT)
diam_kernel(const float* __restrict__ d2,
            const unsigned long long* __restrict__ masks,
            float* __restrict__ out, int n, int S) {
  extern __shared__ float sd2[];          // [n * n]
  const int b = blockIdx.y;
  const float* src = d2 + (long long)b * n * n;
  for (int i = threadIdx.x; i < n * n; i += NT) sd2[i] = src[i];
  __syncthreads();
  const int s = blockIdx.x * NT + threadIdx.x;
  if (s >= S) return;
  const unsigned long long m = masks[s];
  float best = NEG;
  for (int i = 0; i < n; ++i) {
    if (!((m >> i) & 1ull)) continue;
    for (int j = 0; j < n; ++j) {
      if (!((m >> j) & 1ull)) continue;
      const float v = sd2[i * n + j];
      if (v > best || v != v) best = v;  // NaN, once seen, stays
    }
  }
  out[(long long)b * S + s] = best;
}

}  // namespace

// d2 [B, n, n] float32, 1 <= n <= 64, 1 <= B <= 65535; masks [S] uint64.
// Returns cudaGetLastError() (0 = ok).
extern "C" int subset_diameters_f32(const float* d2,
                                    const unsigned long long* masks,
                                    float* out, int B, int n, int S,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 64 || B < 1 || B > 65535 || S < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + NT - 1) / NT, B);
  diam_kernel<<<grid, NT, (size_t)n * n * sizeof(float), st>>>(d2, masks, out,
                                                               n, S);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
