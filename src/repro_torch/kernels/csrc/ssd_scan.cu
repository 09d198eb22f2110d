// Mamba2 SSD scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (`_kernel`,
// launched by `_ssd_fwd_impl` through `pl.pallas_call`).
// Plain versions: src/repro_torch/kernels/ref.py::ssd_chunked_ref (the
// chunked algorithm the TPU kernel runs) and ssd_naive_ref (the
// recurrence).
//
// What it computes: x (B, S, H, P), dt (B, S, H) float32, a_log and d_skip
// (H,) float32, b/c (B, S, N) shared across heads. With a = -exp(a_log):
//   state_t = exp(a * dt_t) * state_{t-1} + (x_t * dt_t) outer b_t
//   y_t     = state_t . c_t + d_skip * x_t
// from a zero state; y in x's type (float32 or bf16), and the final state
// (B, H, P, N) in float32. This is the function the TPU kernel's chunked
// form computes (intra-chunk decay panel, inter-chunk term, carried state,
// D skip); this first kernel runs it in its recurrent form, which needs no
// Q x Q panel (256 KB at chunk 256, over a block's 227 KB) and has no
// chunk padding: a ragged S is just fewer steps.
//
// Grid and loop: one block per (head, batch); the TPU grid's sequential
// chunk axis becomes the loop over time inside the block. The P x N state
// lives in registers: thread (p, g) owns row p, columns g, g + G, ... (G
// threads per row, interleaved so a warp's reads of b_t and c_t hit
// consecutive banks), and y_t[p] is a shuffle sum over the row's G lanes.
// b and c are read per (batch, position) and shared by every head's block
// through L2 (the TPU wrapper materialises them per head). Each pass
// stages a run of steps of b, c, x and dt in shared memory.
//
// Bound: the recurrence costs ~5*P*N float operations per (position, head)
// and reads each input once, so at full width it is operation-bound; its
// time is set by the S sequential steps per block, not by bytes. The
// chunked form on tensor cores (intra-chunk products as wgmma tiles) is the
// redesign's lever.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kPer = 16;  // state columns per thread (at most)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int G>
__global__ void ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ a_log,
                           const T* __restrict__ bm, const T* __restrict__ cm,
                           const float* __restrict__ d_skip, T* __restrict__ y,
                           float* __restrict__ state_out, int s_len, int h,
                           int p_dim, int n_dim, int steps) {
  extern __shared__ float smem[];
  float* b_s = smem;                     // [steps][n_dim]
  float* c_s = b_s + steps * n_dim;      // [steps][n_dim]
  float* x_s = c_s + steps * n_dim;      // [steps][p_dim]
  float* dt_s = x_s + steps * p_dim;     // [steps]

  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int p = tid / G, g = tid % G;    // threads past p_dim only shuffle
  const bool row_ok = p < p_dim;
  const float a = -expf(a_log[hh]);
  const float dsk = d_skip[hh];
  float st[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) st[k] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += steps) {
    const int nt = min(steps, s_len - t0);
    __syncthreads();  // the previous run of steps is consumed
    for (int i = tid; i < nt * n_dim; i += nthreads) {
      const long long off = ((long long)b * s_len + t0) * n_dim + i;
      b_s[i] = to_f(bm[off]);
      c_s[i] = to_f(cm[off]);
    }
    for (int i = tid; i < nt * p_dim; i += nthreads) {
      const int t = i / p_dim, pp = i % p_dim;
      x_s[i] = to_f(x[(((long long)b * s_len + t0 + t) * h + hh) * p_dim + pp]);
    }
    for (int i = tid; i < nt; i += nthreads)
      dt_s[i] = dt[((long long)b * s_len + t0 + i) * h + hh];
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float dtv = dt_s[t];
      const float decay = expf(a * dtv);
      const float xv = row_ok ? x_s[t * p_dim + p] : 0.f;
      const float xd = xv * dtv;
      const float* bt = b_s + t * n_dim;
      const float* ct = c_s + t * n_dim;
      float yp = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int n = g + G * k;
        if (n < n_dim) {
          st[k] = st[k] * decay + xd * bt[n];
          yp += st[k] * ct[n];
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) yp += __shfl_xor_sync(0xffffffffu, yp, o);
      if (row_ok && g == 0)
        put(y + (((long long)b * s_len + t0 + t) * h + hh) * p_dim + p,
            yp + xv * dsk);
    }
  }

  if (!row_ok) return;
  float* so = state_out + (((long long)b * h + hh) * p_dim + p) * n_dim;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = g + G * k;
    if (n < n_dim) so[n] = st[k];
  }
}

template <typename T, int G>
int launch_g(const void* x, const float* dt, const float* a_log, const void* bm,
             const void* cm, const float* d_skip, void* y, float* state,
             int b, int s_len, int h, int p_dim, int n_dim,
             cudaStream_t stream) {
  const int threads = ((p_dim * G + 31) / 32) * 32;
  if (threads > 1024) return -1;
  // stage as many steps as fit in 48 KB of shared memory
  const int per_step = (2 * n_dim + p_dim + 1) * (int)sizeof(float);
  int steps = (48 * 1024) / per_step;
  if (steps > 64) steps = 64;
  if (steps < 1) return -1;
  const dim3 grid(h, b);
  ssd_kernel<T, G><<<grid, threads, steps * per_step, stream>>>(
      (const T*)x, dt, a_log, (const T*)bm, (const T*)cm, d_skip, (T*)y, state,
      s_len, h, p_dim, n_dim, steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* dt, const float* a_log, const void* bm,
           const void* cm, const float* d_skip, void* y, float* state, int b,
           int s_len, int h, int p_dim, int n_dim, cudaStream_t stream) {
  // G threads share a row: the least power of two with G * kPer >= N
  const int need = (n_dim + kPer - 1) / kPer;
#define SSD_ARGS x, dt, a_log, bm, cm, d_skip, y, state, b, s_len, h, p_dim, n_dim, stream
  if (need <= 1) return launch_g<T, 1>(SSD_ARGS);
  if (need <= 2) return launch_g<T, 2>(SSD_ARGS);
  if (need <= 4) return launch_g<T, 4>(SSD_ARGS);
  if (need <= 8) return launch_g<T, 8>(SSD_ARGS);
  if (need <= 16) return launch_g<T, 16>(SSD_ARGS);
  if (need <= 32) return launch_g<T, 32>(SSD_ARGS);
#undef SSD_ARGS
  return -1;
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16 (x, b, c and y share it; dt, a_log,
// d_skip and the state are float32). All tensors contiguous. Returns a
// cudaError_t code (0 on success), -1 for shapes the kernel does not take
// (N > 512, or P * G > 1024 threads). Launches on the current device, on
// `stream`.
extern "C" int ssd_scan_launch(int dtype, const void* x, const float* dt,
                               const float* a_log, const void* bm,
                               const void* cm, const float* d_skip, void* y,
                               float* state, int b, int s_len, int h,
                               int p_dim, int n_dim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define SSD_ARGS x, dt, a_log, bm, cm, d_skip, y, state, b, s_len, h, p_dim, n_dim, s
  if (dtype == 0) return launch<float>(SSD_ARGS);
  if (dtype == 2) return launch<__nv_bfloat16>(SSD_ARGS);
#undef SSD_ARGS
  return -1;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
