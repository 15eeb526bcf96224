// Coordinate-wise order statistics over replica stacks for Hopper (sm_90a),
// CUDA C++: the median, the trimmed mean and MeaMed (mean around the median).
//
// Replaces the Pallas TPU kernels `_median_kernel`, `_trimmed_mean_kernel`
// and `_meamed_kernel`, built by `median_pallas_call`,
// `trimmed_mean_pallas_call` and `meamed_pallas_call`
// (src/repro/kernels/cwise_median/kernel.py), which share one bitonic
// network (`_sorted_rows` / `bitonic_pairs`) and differ only in how they
// reduce the sorted rows; and the `_tile` contract of ops.py: rows padded to a
// power of two with _BIG = 3.4e38, NaN mapped to _BIG, so pads and NaN
// payloads sort last.
//
// What bounds them on the card: memory. Each column's n <= 64 values are read
// once and one value is written; the compare-exchange network is
// O(n log^2 n) min/max per column with no reuse across columns. What the
// design does about it: one thread per column, the column's values in
// registers (the network is unrolled at compile time for each power-of-two
// row count, so every index is static and nothing spills), and each row's
// load is one coalesced stream of consecutive columns across a warp. The
// _tile padding happens in registers, so no padded copy of the stack is ever
// written to device memory. A batch of B stacks ([B, n, d], the receivers of
// one simulator step) is one launch: blockIdx.y picks the stack.
//
// The reductions, each the Pallas kernel's arithmetic in its order:
//   median: row n/2 for odd n (returned directly — the TPU kernel's
//     0.5 * (row + row) overflows to inf when that row is _BIG, while
//     repro.agg.rules.median_stack, the serving read's reference, returns
//     _BIG), and 0.5 * (row[n/2 - 1] + row[n/2]) for even n;
//   trimmed mean: rows f .. n-f-1 added in order, divided by n - 2f;
//   MeaMed: the best of the f+1 windows of n-f consecutive sorted rows by the
//     larger endpoint distance to the median, ties broken by the smaller
//     in-window distance sum, the window's running sum divided by n - f. The
//     sorted column is copied to a per-thread local array for the scan, whose
//     window ends sit at runtime offsets (the network itself stays in
//     registers). __fmul_rn keeps the median's product out of any fused
//     multiply-add, so the plain PyTorch version repeats it bit for bit.
//
// Layout: x [B, n, d] float32 row-major, out [B, d] float32.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 3.4e38f;
constexpr int NT = 256;

enum Reduction { MEDIAN = 0, TRIMMED_MEAN = 1, MEAMED = 2 };

template <int NP, int RED>
__global__ void __launch_bounds__(NT)
order_stat_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                  int f, long long d) {
  const long long col = (long long)blockIdx.x * NT + threadIdx.x;
  if (col >= d) return;
  const float* xb = x + (long long)blockIdx.y * n * d;
  float r[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float val = BIG;
    if (i < n) {
      val = xb[(long long)i * d + col];
      if (isnan(val)) val = BIG;
    }
    r[i] = val;
  }
  // bitonic sorting network, ascending (kernel.py `bitonic_pairs`)
#pragma unroll
  for (int kk = 2; kk <= NP; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const float a = r[i], b = r[p];
          const float lo = fminf(a, b), hi = fmaxf(a, b);
          if ((i & kk) == 0) {
            r[i] = lo;
            r[p] = hi;
          } else {
            r[i] = hi;
            r[p] = lo;
          }
        }
      }
    }
  }
  float res;
  if (RED == MEDIAN) {
    const int lo_i = (n - 1) / 2, hi_i = n / 2;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i == lo_i) a = r[i];
      if (i == hi_i) b = r[i];
    }
    res = (n & 1) ? b : 0.5f * (a + b);
  } else if (RED == TRIMMED_MEAN) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i == f) acc = r[i];
      else if (i > f && i < n - f) acc = acc + r[i];
    }
    res = acc / (float)(n - 2 * f);
  } else {
    float s[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) s[i] = r[i];
    const int m = n - f;
    const float med = __fmul_rn(0.5f, s[(n - 1) / 2] + s[n / 2]);
    float win_sum = s[0], win_dsum = fabsf(s[0] - med);
    for (int j = 1; j < m; ++j) {
      win_sum = win_sum + s[j];
      win_dsum = win_dsum + fabsf(s[j] - med);
    }
    float best_sum = win_sum, best_dsum = win_dsum;
    float best_d = fmaxf(med - s[0], s[m - 1] - med);
    for (int i = 1; i <= f; ++i) {
      win_sum = (win_sum - s[i - 1]) + s[i + m - 1];
      win_dsum = (win_dsum - fabsf(s[i - 1] - med)) + fabsf(s[i + m - 1] - med);
      const float dd = fmaxf(med - s[i], s[i + m - 1] - med);
      if (dd < best_d || (dd == best_d && win_dsum < best_dsum)) {
        best_sum = win_sum;
        best_dsum = win_dsum;
      }
      best_d = fminf(best_d, dd);
    }
    res = best_sum / (float)m;
  }
  out[(long long)blockIdx.y * d + col] = res;
}

template <int NP, int RED>
int launch(const float* x, float* out, int B, int n, int f, long long d,
           cudaStream_t s) {
  const long long blocks = (d + NT - 1) / NT;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  order_stat_kernel<NP, RED><<<grid, NT, 0, s>>>(x, out, n, f, d);
  return (int)cudaGetLastError();
}

template <int RED>
int dispatch(const float* x, float* out, int B, int n, int f, long long d,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || d < 1) return (int)cudaErrorInvalidValue;
  int np = 1;
  while (np < n) np <<= 1;
  switch (np) {
    case 1: return launch<1, RED>(x, out, B, n, f, d, s);
    case 2: return launch<2, RED>(x, out, B, n, f, d, s);
    case 4: return launch<4, RED>(x, out, B, n, f, d, s);
    case 8: return launch<8, RED>(x, out, B, n, f, d, s);
    case 16: return launch<16, RED>(x, out, B, n, f, d, s);
    case 32: return launch<32, RED>(x, out, B, n, f, d, s);
    case 64: return launch<64, RED>(x, out, B, n, f, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, n, d] float32, 1 <= n <= 64, 1 <= B <= 65535. Each returns
// cudaGetLastError() (0 = ok).
extern "C" int cwise_median_f32(const float* x, float* out, int B, int n,
                                long long d, void* stream) {
  return dispatch<MEDIAN>(x, out, B, n, 0, d, stream);
}

// 0 <= f, 2f < n
extern "C" int cwise_trimmed_mean_f32(const float* x, float* out, int B,
                                      int n, int f, long long d,
                                      void* stream) {
  if (f < 0 || 2 * f >= n) return (int)cudaErrorInvalidValue;
  return dispatch<TRIMMED_MEAN>(x, out, B, n, f, d, stream);
}

// 0 <= f < n
extern "C" int cwise_meamed_f32(const float* x, float* out, int B, int n,
                                int f, long long d, void* stream) {
  if (f < 0 || f >= n) return (int)cudaErrorInvalidValue;
  return dispatch<MEAMED>(x, out, B, n, f, d, stream);
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
