// Fused (B, N) eq. 11 routing-score matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/route_score.py
// (`_kernel`, launched by `route_score` through `pl.pallas_call`).
// Plain version: src/repro_torch/kernels/ref.py::route_score_ref.
//
// What it computes, per request b and server n (one thread each, 2-D grid):
//   score = prompt/uplink                                   (eq. 5)
//         + [size/backhaul, 0 where resident[n, model[b]]]  (eq. 7, gated)
//         + (queue*flops_tok + work)/flops                  (eq. 9)
//   plus the spill surcharge prompt/backhaul on neighbour-cell pairs and
//   +inf on every pair the request cannot see (other cell, not cloud,
//   not spilled). Absent pieces (no size column, no queue, no residency,
//   no cells, no spill) are null pointers and drop their term exactly as
//   the plain version does.
//
// Rounding: every add, multiply and divide is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn and their double forms), and
// the build passes --fmad=false, so nothing is contracted into an FMA.
// The terms group exactly as in the plain version, which makes the float32
// and float64 output bitwise equal to it; bf16 columns are read through
// __bfloat162float, the math runs in float32 and the result is rounded to
// bf16 once, as the plain version does.
//
// Bound: the (B, N) output write. Each thread reads 4 request and 4 server
// scalars (cached, B + N of them in all) and a residency byte, and writes
// one score, so bytes moved ~ B*N*sizeof(out) and the few divides per
// element stay far under the compute roof. The design keeps the columns in
// registers/L1 and writes the output row-major with consecutive threads on
// consecutive servers, so every warp store is one coalesced segment. The
// TPU's one-hot MXU contractions for the residency gate and the spill rows
// become direct byte reads (resident[n*K + model], spill[rc*C + sc]).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
};

template <typename T> __device__ __forceinline__ T load(const float* p, long long i) { return (T)p[i]; }
template <typename T> __device__ __forceinline__ T load(const double* p, long long i) { return (T)p[i]; }
template <typename T> __device__ __forceinline__ T load(const __nv_bfloat16* p, long long i) {
  return (T)__bfloat162float(p[i]);
}

__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(double* p, long long i, double v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) { p[i] = __float2bfloat16(v); }

template <typename In, typename T, typename Out>
__global__ void route_score_kernel(
    const In* __restrict__ prompt, const In* __restrict__ size,
    const In* __restrict__ flops_tok, const In* __restrict__ work,
    const In* __restrict__ uplink, const In* __restrict__ backhaul,
    const In* __restrict__ flops, const In* __restrict__ queue,
    const uint8_t* __restrict__ resident, const int32_t* __restrict__ model, int k,
    const int32_t* __restrict__ req_cell, const int32_t* __restrict__ srv_cell,
    const uint8_t* __restrict__ spill, int c, int cloud_cell,
    Out* __restrict__ out, int b_rows, int n_cols) {
  typedef Arith<T> A;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y * blockDim.y + threadIdx.y;
  if (n >= n_cols || b >= b_rows) return;

  const T p = load<T>(prompt, b);
  const T t_trans = A::div(p, load<T>(uplink, n));                  // eq. 5
  const T w = load<T>(work, b);
  const T backlog = queue == nullptr
      ? w : A::add(A::mul(load<T>(queue, n), load<T>(flops_tok, b)), w);
  const T t_comp = A::div(backlog, load<T>(flops, n));              // eq. 9
  T score;
  if (size != nullptr) {
    T t_switch = A::div(load<T>(size, b), load<T>(backhaul, n));    // eq. 7
    if (resident != nullptr) {
      int m = model[b];
      m = m < 0 ? 0 : (m >= k ? k - 1 : m);  // clamped like the plain gather
      if (resident[(long long)n * k + m]) t_switch = T(0);
    }
    score = A::add(A::add(t_trans, t_switch), t_comp);             // eq. 11
  } else {
    score = A::add(t_trans, t_comp);                               // switch-free base
  }
  if (req_cell != nullptr) {
    const int rc = req_cell[b];
    const int sc = srv_cell[n];
    const bool home = rc == sc;
    bool visible = home || sc == cloud_cell;
    if (spill != nullptr) {
      // out-of-range cells on either side (orphans, the cloud) never spill
      const bool in_range = rc >= 0 && rc < c && sc >= 0 && sc < c;
      const bool spilled = in_range && spill[(long long)rc * c + sc] && !home;
      score = A::add(score, spilled ? A::div(p, load<T>(backhaul, n)) : T(0));
      visible = visible || spilled;
    }
    if (!visible) score = A::inf();
  }
  store(out, (long long)b * n_cols + n, score);
}

template <typename In, typename T, typename Out>
int launch(const void* prompt, const void* size, const void* flops_tok,
           const void* work, const void* uplink, const void* backhaul,
           const void* flops, const void* queue, const uint8_t* resident,
           const int32_t* model, int k, const int32_t* req_cell,
           const int32_t* srv_cell, const uint8_t* spill, int c,
           int cloud_cell, void* out, int b_rows, int n_cols,
           cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((n_cols + block.x - 1) / block.x,
                  (b_rows + block.y - 1) / block.y);
  route_score_kernel<In, T, Out><<<grid, block, 0, stream>>>(
      (const In*)prompt, (const In*)size, (const In*)flops_tok,
      (const In*)work, (const In*)uplink, (const In*)backhaul,
      (const In*)flops, (const In*)queue, resident, model, k, req_cell,
      srv_cell, spill, c, cloud_cell, (Out*)out, b_rows, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 float64, 2 bfloat16. Supported (in, out)
// pairs: (0, 0), (1, 1), (2, 2), (0, 2). Returns a cudaError_t code
// (0 on success); -1 for an unsupported dtype pair.
// Launches on the calling thread's current device; the caller makes the
// tensors' device current and passes one of its streams.
extern "C" int route_score_launch(
    int in_dtype, int out_dtype,
    const void* prompt, const void* size, const void* flops_tok,
    const void* work, const void* uplink, const void* backhaul,
    const void* flops, const void* queue, const uint8_t* resident,
    const int32_t* model, int k, const int32_t* req_cell,
    const int32_t* srv_cell, const uint8_t* spill, int c, int cloud_cell,
    void* out, int b_rows, int n_cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ROUTE_SCORE_ARGS prompt, size, flops_tok, work, uplink, backhaul, flops, \
    queue, resident, model, k, req_cell, srv_cell, spill, c, cloud_cell, out,     \
    b_rows, n_cols, s
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float, float>(ROUTE_SCORE_ARGS);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<double, double, double>(ROUTE_SCORE_ARGS);
  if (in_dtype == 2 && out_dtype == 2)
    return launch<__nv_bfloat16, float, __nv_bfloat16>(ROUTE_SCORE_ARGS);
  if (in_dtype == 0 && out_dtype == 2)
    return launch<float, float, __nv_bfloat16>(ROUTE_SCORE_ARGS);
#undef ROUTE_SCORE_ARGS
  return -1;
}

extern "C" const char* route_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
