// One column of an order statistic, in registers: the sorting networks and
// MeaMed's window scan, shared by the kernels of cwise_median.cu. Every array
// index below is a compile-time constant once the loops are unrolled (the
// networks' compare-exchanges come from constexpr schedules, the scans'
// bounds are template parameters), so a column never leaves registers.
#pragma once

#include <utility>

namespace ostat {

constexpr float BIG = 3.4e38f;

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Batcher's odd-even merge sort for any n (ref.py `_oddeven_pairs`): every
// compare-exchange puts the smaller value on the lower wire. On n wires it is
// the power-of-two network with each compare-exchange that touches a wire
// >= n dropped. Walks the schedule; returns the number of compare-exchanges,
// and the wires of the c-th one through *lo, *hi.
__host__ __device__ constexpr int oddeven_walk(int n, int c, int* lo,
                                               int* hi) {
  int count = 0;
  for (int p = 1; p < n; p *= 2)
    for (int k = p; k >= 1; k /= 2)
      for (int j = k % p; j < n - k; j += 2 * k)
        for (int i = 0; i < k && i < n - j - k; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            if (count == c) {
              *lo = i + j;
              *hi = i + j + k;
            }
            ++count;
          }
  return count;
}

__host__ __device__ constexpr int oddeven_count(int n) {
  int lo = 0, hi = 0;
  return oddeven_walk(n, -1, &lo, &hi);
}

__host__ __device__ constexpr int oddeven_lo(int n, int c) {
  int lo = 0, hi = 0;
  oddeven_walk(n, c, &lo, &hi);
  return lo;
}

__host__ __device__ constexpr int oddeven_hi(int n, int c) {
  int lo = 0, hi = 0;
  oddeven_walk(n, c, &lo, &hi);
  return hi;
}

template <int N, int C>
__device__ __forceinline__ void compare_exchange(float* r) {
  constexpr int i = oddeven_lo(N, C), j = oddeven_hi(N, C);
  const float a = r[i], b = r[j];
  r[i] = fminf(a, b);
  r[j] = fmaxf(a, b);
}

template <int N, int... C>
__device__ __forceinline__ void oddeven_apply(
    float* r, std::integer_sequence<int, C...>) {
  (compare_exchange<N, C>(r), ...);
}

// Sorts r[0..N) ascending on exactly N wires. Then gives rows 0..N-1 of the
// padded sort that the Pallas kernel and the plain version run (N rows and
// pow2(N) - N pads of BIG): with every value <= BIG those rows are the
// sorted values themselves, but a value above BIG (+inf, or a float in
// (3.4e38, FLT_MAX]) sorts after the pads. Row j of the padded sort is the
// merge of the sorted column with c = pow2(N) - N copies of BIG:
// max(r[j - c], min(r[j], BIG)), min(r[j], BIG) for j < c.
template <int N>
__device__ __forceinline__ void sort_exact(float* r) {
  oddeven_apply<N>(r, std::make_integer_sequence<int, oddeven_count(N)>{});
  constexpr int c = pow2_at_least(N) - N;
  if constexpr (c > 0) {
#pragma unroll
    for (int j = N - 1; j >= 0; --j)
      r[j] = j >= c ? fmaxf(r[j - c], fminf(r[j], BIG)) : fminf(r[j], BIG);
  }
}

// Bitonic sorting network over NP (a power of two) wires, ascending (the
// Pallas kernel's `bitonic_pairs`).
template <int NP>
__device__ __forceinline__ void sort_bitonic(float* r) {
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
}

// MeaMed's window scan over the sorted column s[0..N), f = F, all indices
// static: the best of the F+1 windows of M = N-F consecutive rows by the
// larger endpoint distance to the median, ties broken by the smaller
// in-window distance sum; the window's running sum over M. The Pallas
// kernel's arithmetic in its order; __fmul_rn keeps the median's product out
// of a fused multiply-add.
template <int N, int F>
__device__ __forceinline__ float meamed_scan(const float* s) {
  constexpr int M = N - F;
  const float med = __fmul_rn(0.5f, s[(N - 1) / 2] + s[N / 2]);
  float win_sum = s[0], win_dsum = fabsf(s[0] - med);
#pragma unroll
  for (int j = 1; j < M; ++j) {
    win_sum = win_sum + s[j];
    win_dsum = win_dsum + fabsf(s[j] - med);
  }
  float best_sum = win_sum, best_dsum = win_dsum;
  float best_d = fmaxf(med - s[0], s[M - 1] - med);
#pragma unroll
  for (int i = 1; i <= F; ++i) {
    win_sum = (win_sum - s[i - 1]) + s[i + M - 1];
    win_dsum = (win_dsum - fabsf(s[i - 1] - med)) + fabsf(s[i + M - 1] - med);
    const float dd = fmaxf(med - s[i], s[i + M - 1] - med);
    if (dd < best_d || (dd == best_d && win_dsum < best_dsum)) {
      best_sum = win_sum;
      best_dsum = win_dsum;
    }
    best_d = fminf(best_d, dd);
  }
  return best_sum / (float)M;
}

// The scan for the runtime f (0 <= f < N): a chain of warp-uniform branches
// down to the instance with F == f.
template <int N, int F = 0>
__device__ __forceinline__ float meamed_scan_for(const float* s, int f) {
  if constexpr (F + 1 < N) {
    if (f > F) return meamed_scan_for<N, F + 1>(s, f);
  }
  return meamed_scan<N, F>(s);
}

// The same scan over a padded column s[0..NP) with runtime n <= NP and f.
// The windows' upper ends s[i + m - 1] sit at a runtime offset, so the column
// is first copied shifted down by m - 1 (log2(NP) stages, each a select per
// entry between it and the one 2^b above, hi[i] = s[i + m - 1]); the median's
// rows are picked by selects too, so every index is static.
template <int NP>
__device__ __forceinline__ float meamed_scan_padded(const float* s, int n,
                                                    int f) {
  const int m = n - f, lo = (n - 1) / 2, up = n / 2;
  float a = s[0], b = s[0];
#pragma unroll
  for (int j = 1; j < NP; ++j) {
    a = j == lo ? s[j] : a;
    b = j == up ? s[j] : b;
  }
  const float med = __fmul_rn(0.5f, a + b);
  float win_sum = s[0], win_dsum = fabsf(s[0] - med);
#pragma unroll
  for (int j = 1; j < NP; ++j) {
    if (j < m) {
      win_sum = win_sum + s[j];
      win_dsum = win_dsum + fabsf(s[j] - med);
    }
  }
  float hi[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) hi[j] = s[j];
#pragma unroll
  for (int b = 0; (1 << b) < NP; ++b) {
    const bool take = ((m - 1) >> b) & 1;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (j + (1 << b) < NP) hi[j] = take ? hi[j + (1 << b)] : hi[j];
  }
  float best_sum = win_sum, best_dsum = win_dsum;
  float best_d = fmaxf(med - s[0], hi[0] - med);
#pragma unroll
  for (int i = 1; i < NP; ++i) {
    if (i <= f) {
      win_sum = (win_sum - s[i - 1]) + hi[i];
      win_dsum = (win_dsum - fabsf(s[i - 1] - med)) + fabsf(hi[i] - med);
      const float dd = fmaxf(med - s[i], hi[i] - med);
      if (dd < best_d || (dd == best_d && win_dsum < best_dsum)) {
        best_sum = win_sum;
        best_dsum = win_dsum;
      }
      best_d = fminf(best_d, dd);
    }
  }
  return best_sum / (float)m;
}

}  // namespace ostat
