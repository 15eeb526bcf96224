// The inter-chunk state recurrence of RWKV6's chunked WKV scan on Hopper
// (sm_90a), CUDA C++: one launch forward, one backward.
//
// Replaces no TPU kernel. The JAX package runs this recurrence inside the
// `jax.lax.scan` of `wkv_chunked` (src/repro/models/rwkv6.py), which XLA
// compiles into one loop on the device. The port ran it as a Python loop
// over the chunks, ~14 small launches a chunk with autograd, and a backward
// that filled and added a zero gradient of the whole `add` tensor at every
// chunk. Here the recurrence is, per chunk i,
//
//     entering[i] = s_i,   s_{i+1} = decay[i] * s_i + add[i],
//
// elementwise over the B*H*K*V state, decay broadcast over V. The backward,
// from G_N = d_final (zero when absent):
//
//     d_add[i] = G_{i+1},
//     d_decay[i][k] = sum_v G_{i+1}[k, v] entering[i][k, v],
//     G_i = decay[i] * G_{i+1} + d_entering[i],      d_s0 = G_0.
//
// What bounds it on the card: memory. A chunk reads add[i] and writes
// entering[i] (forward), or reads entering[i] and d_entering[i] and writes
// d_add[i] (backward), for one or two FMAs an element. The state is the
// only carried value, and it is small ([B, H, K, V]: 2.6 MB at the training
// shape), so it lives in registers: a thread holds one float4 of one row
// (b, h, k) and walks the N chunks (chunk stride B*H*K*V). The chunk loads
// do not depend on the state, so each thread keeps the next U chunks' loads
// in flight in a register ring (slot u is refilled U chunks ahead as soon
// as it is used): with only B*H*K*V / 4 threads (163,840 at B = 4, H = 40),
// one load in flight a thread would not reach the bandwidth. Loads and
// stores of the big arrays are streaming (evict-first): each byte is
// touched once. d_decay sums a row's V columns: 4 in the thread, then a
// butterfly of warp shuffles over the row's V / 4 lanes (a row never
// straddles a warp), one store a (chunk, row). No atomics, so two launches
// are bit-equal. f32 throughout; fmaf rounds once where the plain version's
// multiply and add round twice.
//
// Layout: decay [N, R] with R = B*H*K rows; add, entering, d_entering,
// d_add [N, R, V]; s0, final, d_final, d_s0 [R, V]; all float32, row-major,
// 16-byte aligned; V in {4, 8, 16, 32, 64, 128}.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads of a block
constexpr int U = 8;      // chunks a thread has in flight

__device__ __forceinline__ float4 fma4(float d, float4 s, float4 a) {
  return make_float4(fmaf(d, s.x, a.x), fmaf(d, s.y, a.y), fmaf(d, s.z, a.z),
                     fmaf(d, s.w, a.w));
}

// RL: float4 lanes of a row (V / 4)
template <int RL>
__global__ void __launch_bounds__(NT) state_scan_fwd_kernel(
    const float* __restrict__ decay, const float4* __restrict__ add,
    const float4* __restrict__ s0, float4* __restrict__ entering,
    float4* __restrict__ final_state, long long n_chunks, long long rows,
    long long lanes) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= lanes) return;
  const long long row = t / RL;
  float4 a[U];
  float d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < n_chunks) {
      a[u] = __ldcs(add + u * lanes + t);
      d[u] = __ldg(decay + u * rows + row);
    }
  }
  float4 s = s0[t];
  for (long long i0 = 0; i0 < n_chunks; i0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = i0 + u;
      if (i < n_chunks) {
        __stcs(entering + i * lanes + t, s);
        s = fma4(d[u], s, a[u]);
        if (i + U < n_chunks) {
          a[u] = __ldcs(add + (i + U) * lanes + t);
          d[u] = __ldg(decay + (i + U) * rows + row);
        }
      }
    }
  }
  final_state[t] = s;
}

// d_final and d_s0 may be null (a zero incoming gradient; d_s0 not asked)
template <int RL>
__global__ void __launch_bounds__(NT) state_scan_bwd_kernel(
    const float* __restrict__ decay, const float4* __restrict__ entering,
    const float4* __restrict__ d_entering, const float4* __restrict__ d_final,
    float4* __restrict__ d_add, float* __restrict__ d_decay,
    float4* __restrict__ d_s0, long long n_chunks, long long rows,
    long long lanes) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  const bool live = t < lanes;
  // a row's lanes are all live or all not: the shuffles stay in the mask
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (!live) return;
  const long long row = t / RL;
  const bool lead = threadIdx.x % RL == 0;
  float4 e[U], de[U];
  float d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = n_chunks - 1 - u;
    if (i >= 0) {
      e[u] = __ldcs(entering + i * lanes + t);
      de[u] = __ldcs(d_entering + i * lanes + t);
      d[u] = __ldg(decay + i * rows + row);
    }
  }
  float4 g = d_final != nullptr ? d_final[t]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long j0 = 0; j0 < n_chunks; j0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = n_chunks - 1 - (j0 + u);
      if (i >= 0) {
        __stcs(d_add + i * lanes + t, g);
        float p = fmaf(g.x, e[u].x, fmaf(g.y, e[u].y,
                                         fmaf(g.z, e[u].z, g.w * e[u].w)));
#pragma unroll
        for (int o = RL / 2; o > 0; o /= 2)
          p += __shfl_xor_sync(mask, p, o);
        if (lead) d_decay[i * rows + row] = p;
        g = fma4(d[u], g, de[u]);
        if (i - U >= 0) {
          e[u] = __ldcs(entering + (i - U) * lanes + t);
          de[u] = __ldcs(d_entering + (i - U) * lanes + t);
          d[u] = __ldg(decay + (i - U) * rows + row);
        }
      }
    }
  }
  if (d_s0 != nullptr) d_s0[t] = g;
}

template <int RL>
int launch_fwd(const float* decay, const float* add, const float* s0,
               float* entering, float* final_state, long long n_chunks,
               long long rows, cudaStream_t st) {
  const long long lanes = rows * RL;
  const unsigned blocks = (lanes + NT - 1) / NT;
  state_scan_fwd_kernel<RL><<<blocks, NT, 0, st>>>(
      decay, reinterpret_cast<const float4*>(add),
      reinterpret_cast<const float4*>(s0), reinterpret_cast<float4*>(entering),
      reinterpret_cast<float4*>(final_state), n_chunks, rows, lanes);
  return (int)cudaGetLastError();
}

template <int RL>
int launch_bwd(const float* decay, const float* entering,
               const float* d_entering, const float* d_final, float* d_add,
               float* d_decay, float* d_s0, long long n_chunks, long long rows,
               cudaStream_t st) {
  const long long lanes = rows * RL;
  const unsigned blocks = (lanes + NT - 1) / NT;
  state_scan_bwd_kernel<RL><<<blocks, NT, 0, st>>>(
      decay, reinterpret_cast<const float4*>(entering),
      reinterpret_cast<const float4*>(d_entering),
      reinterpret_cast<const float4*>(d_final),
      reinterpret_cast<float4*>(d_add), d_decay,
      reinterpret_cast<float4*>(d_s0), n_chunks, rows, lanes);
  return (int)cudaGetLastError();
}

using FwdLaunch = int (*)(const float*, const float*, const float*, float*,
                         float*, long long, long long, cudaStream_t);
using BwdLaunch = int (*)(const float*, const float*, const float*,
                         const float*, float*, float*, float*, long long,
                         long long, cudaStream_t);
// instance i takes V = 4 << i (2^i lanes a row)
constexpr int N_INST = 6;
constexpr FwdLaunch FWD[N_INST] = {launch_fwd<1>, launch_fwd<2>,
                                   launch_fwd<4>, launch_fwd<8>,
                                   launch_fwd<16>, launch_fwd<32>};
constexpr BwdLaunch BWD[N_INST] = {launch_bwd<1>, launch_bwd<2>,
                                   launch_bwd<4>, launch_bwd<8>,
                                   launch_bwd<16>, launch_bwd<32>};

// the instance of V, or -1 when N, R or V is not taken (the grid's blocks
// must fit a grid dimension: R * V / 4 / NT < 2^31)
int instance(long long n_chunks, long long rows, int v) {
  if (n_chunks < 1 || rows < 1 || rows > (1LL << 33)) return -1;
  for (int i = 0; i < N_INST; ++i)
    if (v == 4 << i) return i;
  return -1;
}

}  // namespace

// decay [N, R], add [N, R, V], s0 [R, V] -> entering [N, R, V], final
// [R, V]; float32, 16-byte aligned. Returns cudaGetLastError() (0 = ok).
extern "C" int wkv_state_scan_fwd_f32(const float* decay, const float* add,
                                      const float* s0, float* entering,
                                      float* final_state, long long n_chunks,
                                      long long rows, int v, void* stream) {
  const int i = instance(n_chunks, rows, v);
  if (i < 0) return (int)cudaErrorInvalidValue;
  return FWD[i](decay, add, s0, entering, final_state, n_chunks, rows,
                static_cast<cudaStream_t>(stream));
}

// decay [N, R], entering and d_entering [N, R, V], d_final [R, V] or null
// -> d_add [N, R, V], d_decay [N, R], d_s0 [R, V] (skipped when null);
// float32, 16-byte aligned. Returns cudaGetLastError() (0 = ok).
extern "C" int wkv_state_scan_bwd_f32(const float* decay,
                                      const float* entering,
                                      const float* d_entering,
                                      const float* d_final, float* d_add,
                                      float* d_decay, float* d_s0,
                                      long long n_chunks, long long rows,
                                      int v, void* stream) {
  const int i = instance(n_chunks, rows, v);
  if (i < 0) return (int)cudaErrorInvalidValue;
  return BWD[i](decay, entering, d_entering, d_final, d_add, d_decay, d_s0,
                n_chunks, rows, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
