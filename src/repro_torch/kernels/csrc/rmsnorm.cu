// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (`_kernel`,
// launched by `rmsnorm` through `pl.pallas_call`).
// Plain version: src/repro_torch/kernels/ref.py::rmsnorm_ref.
//
// What it computes, per row of x (rows, d):
//   out = x * rsqrt(mean(x^2) + eps) * scale
// in float32, read and written in the input's type (float32 or bf16);
// scale arrives as float32 (the wrapper converts its d values).
//
// Bound: bytes. Each element is read twice (the second read hits L1/L2)
// and written once, for ~4 float operations, far under the card's
// operations-per-byte line. One warp owns one row: lanes stride the row so
// every warp load and store is one coalesced segment, the sum of squares
// is a register sum plus a 5-step shuffle reduction, and no shared memory
// or block barrier is needed. A ragged last block is masked by its row
// index (the TPU kernel's 1-row fallback for rows % 128 != 0 has no
// counterpart). The TPU kernel computes x*rsqrt(ms+eps) like this one; the
// plain version divides by sqrt(ms+eps), an ulp apart.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;  // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)d + eps);
  T* orow = out + row * d;
  for (int i = lane; i < d; i += 32) put(orow + i, to_f(xr[i]) * r * scale[i]);
}

template <typename T>
int launch(const void* x, const float* scale, void* out, long long rows, int d,
           float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      (const T*)x, scale, (T*)out, rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16 (x and out share it). Returns a
// cudaError_t code (0 on success), -1 for an unsupported dtype. Launches on
// the calling thread's current device, on `stream`.
extern "C" int rmsnorm_launch(int dtype, const void* x, const float* scale,
                              void* out, long long rows, int d, float eps,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, scale, out, rows, d, eps, s);
  if (dtype == 2) return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return -1;
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
