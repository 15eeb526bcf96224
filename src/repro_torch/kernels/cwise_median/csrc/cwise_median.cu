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
//     in-window distance sum, the window's running sum divided by n - f.
//     __fmul_rn keeps the median's product out of any fused multiply-add, so
//     the plain PyTorch version repeats it bit for bit.
//
// MeaMed has kernels of its own: its instructions, not memory, are what it
// can lose time on. Window ends at runtime offsets would put the sorted
// column in an array indexed at run time (select chains, or a stack frame),
// and the padded network sorts n = 5 on 8 wires. For n <= 16,
// meamed_exact_kernel<N> sorts on exactly N wires (Batcher's odd-even
// network with every compare-exchange on a pad wire dropped: 9 for n = 5,
// not 24), restores what the pads do to values above BIG, and runs the scan
// instance of the runtime f, whose indices are all static; a thread takes two
// columns with 8-byte loads where d and the stack's alignment allow
// (ops.py `meamed_plan`). For 16 < n <= 64, meamed_padded_kernel<NP> keeps
// the padded bitonic column and shifts it once by the runtime window length,
// so its scan too indexes statically.
//
// Layout: x [B, n, d] float32 row-major, out [B, d] float32.

#include <cuda_runtime.h>

#include "column.cuh"

namespace {

using ostat::BIG;
constexpr int NT = 256;
constexpr int MAX_EXACT_N = 16;   // ops.py MAX_EXACT_N

enum Reduction { MEDIAN = 0, TRIMMED_MEAN = 1 };

// Rows 0..n-1 of column `col` into r[0..NP), NaN mapped to BIG, the rest BIG.
template <int NP>
__device__ __forceinline__ void load_padded(const float* xb, int n,
                                            long long d, long long col,
                                            float* r) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float val = BIG;
    if (i < n) {
      val = xb[(long long)i * d + col];
      if (isnan(val)) val = BIG;
    }
    r[i] = val;
  }
}

template <int NP, int RED>
__global__ void __launch_bounds__(NT)
order_stat_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                  int f, long long d) {
  const long long col = (long long)blockIdx.x * NT + threadIdx.x;
  if (col >= d) return;
  float r[NP];
  load_padded<NP>(x + (long long)blockIdx.y * n * d, n, d, col, r);
  ostat::sort_bitonic<NP>(r);
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
  } else {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i == f) acc = r[i];
      else if (i > f && i < n - f) acc = acc + r[i];
    }
    res = acc / (float)(n - 2 * f);
  }
  out[(long long)blockIdx.y * d + col] = res;
}

// MeaMed on exactly N <= 16 rows: VEC consecutive columns a thread, each
// row's VEC values in one 4- or 8-byte load (VEC = 2 needs d even and the
// stack 8-byte aligned), a network on N wires, the scan for the runtime f.
template <int N, int VEC>
__global__ void __launch_bounds__(NT)
meamed_exact_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int f, long long d) {
  const long long col = ((long long)blockIdx.x * NT + threadIdx.x) * VEC;
  if (col >= d) return;
  const float* p = x + (long long)blockIdx.y * N * d + col;
  float r[VEC][N];
#pragma unroll
  for (int i = 0; i < N; ++i, p += d) {
    if constexpr (VEC == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      r[0][i] = v.x;
      r[1][i] = v.y;
    } else {
      r[0][i] = *p;
    }
  }
  float res[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (isnan(r[v][i])) r[v][i] = BIG;
    ostat::sort_exact<N>(r[v]);
    res[v] = ostat::meamed_scan_for<N>(r[v], f);
  }
  float* o = out + (long long)blockIdx.y * d + col;
  if constexpr (VEC == 2)
    *reinterpret_cast<float2*>(o) = make_float2(res[0], res[1]);
  else
    *o = res[0];
}

// MeaMed on 16 < n <= NP rows: the padded column and bitonic network,
// with the static-index scan.
template <int NP>
__global__ void __launch_bounds__(NT)
meamed_padded_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int n, int f, long long d) {
  const long long col = (long long)blockIdx.x * NT + threadIdx.x;
  if (col >= d) return;
  float r[NP];
  load_padded<NP>(x + (long long)blockIdx.y * n * d, n, d, col, r);
  ostat::sort_bitonic<NP>(r);
  out[(long long)blockIdx.y * d + col] = ostat::meamed_scan_padded<NP>(r, n, f);
}

dim3 grid_for(long long cols, int B) {
  return dim3((unsigned)((cols + NT - 1) / NT), (unsigned)B);
}

template <int NP, int RED>
int launch(const float* x, float* out, int B, int n, int f, long long d,
           cudaStream_t s) {
  order_stat_kernel<NP, RED><<<grid_for(d, B), NT, 0, s>>>(x, out, n, f, d);
  return (int)cudaGetLastError();
}

template <int RED>
int dispatch(const float* x, float* out, int B, int n, int f, long long d,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || d < 1) return (int)cudaErrorInvalidValue;
  switch (ostat::pow2_at_least(n)) {
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

// The exact kernel's instance for the runtime n (1 <= n <= 16).
template <int N = 1>
int launch_meamed_exact(const float* x, float* out, int B, int n, int f,
                        long long d, int vec, cudaStream_t s) {
  if constexpr (N < MAX_EXACT_N) {
    if (n > N)
      return launch_meamed_exact<N + 1>(x, out, B, n, f, d, vec, s);
  }
  if (vec == 2)
    meamed_exact_kernel<N, 2><<<grid_for(d / 2, B), NT, 0, s>>>(x, out, f, d);
  else
    meamed_exact_kernel<N, 1><<<grid_for(d, B), NT, 0, s>>>(x, out, f, d);
  return (int)cudaGetLastError();
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

// 0 <= f < n; vec (columns a thread) is 2 only for n <= 16, d even and x
// 8-byte aligned (ops.py `meamed_plan`), else 1.
extern "C" int cwise_meamed_f32(const float* x, float* out, int B, int n,
                                int f, long long d, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f < 0 || f >= n || n < 1 || n > 64 || B < 1 || B > 65535 || d < 1 ||
      (vec != 1 && vec != 2) ||
      (vec == 2 && (n > MAX_EXACT_N || d % 2 != 0 ||
                    reinterpret_cast<unsigned long long>(x) % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  if (n <= MAX_EXACT_N)
    return launch_meamed_exact(x, out, B, n, f, d, vec, s);
  if (n <= 32)
    meamed_padded_kernel<32><<<grid_for(d, B), NT, 0, s>>>(x, out, n, f, d);
  else
    meamed_padded_kernel<64><<<grid_for(d, B), NT, 0, s>>>(x, out, n, f, d);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
