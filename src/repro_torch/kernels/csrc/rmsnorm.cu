// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:34 (`_kernel`,
// launched by `rmsnorm` through `pl.pallas_call`).
// Plain version: src/repro_torch/kernels/ref.py::rmsnorm_ref.
//
// What it computes, per row of x (rows, d):
//   out = x * rsqrt(mean(x^2) + eps) * scale
// in float32, read and written in the input's type (float32 or bf16); scale
// comes in its own type (float32 or bf16), so a caller never casts it.
//
// Bound: bytes (x read once, out written once, ~4 float operations an
// element, far under the card's operations-per-byte line). The design
// keeps every byte moving in wide, independent requests:
// - 16-byte loads and stores: 8 bf16 or 4 float32 values a lane.
// - One read of x: a lane issues all its loads of the row at once into
//   registers (up to 16 vectors), sums their squares, and writes from the
//   same registers. Scale is loaded vectorised once per lane, in its type.
// - A row belongs to `w` warps (the wrapper picks w by width, so that a
//   lane holds at most 16 vectors); with w > 1 the warps' sums meet in
//   shared memory. A block is four warps (w <= 4) or one row of w warps.
// - Where d is not a multiple of the vector width, or a base is not on a
//   16-byte boundary, the same kernel takes a scalar path (lane i takes
//   elements i, i + 32w, ..., and reads them again for the write): the
//   card never falls back to another version.
// rsqrt as the TPU kernel has it; the plain version divides by sqrt, an
// ulp apart. A ragged last block is masked by its row index (the TPU
// kernel's 1-row fallback for rows % 128 != 0 has no counterpart).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxVec = 16;   // 16-byte vectors a lane holds at most
constexpr int kMaxWarps = 8;  // warps of one row at most
constexpr int kMaxThreads = 32 * kMaxWarps;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The 16 bytes of one vector of T as float32 values, and back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack2(uint32_t r, float* f) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
    f[0] = __low2float(v); f[1] = __high2float(v);
  }
  __device__ static void unpack(const uint4& r, float* f) {
    unpack2(r.x, f); unpack2(r.y, f + 2); unpack2(r.z, f + 4); unpack2(r.w, f + 6);
  }
  __device__ static uint32_t pack2(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// N values of scale from element i on (i a multiple of N, the base on a
// 16-byte boundary): 16-byte loads, or one 8-byte load for 4 bf16 values.
template <typename TS, int N>
__device__ __forceinline__ void load_scale(const TS* s, int i, float* f) {
  if constexpr (sizeof(TS) * N == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(s + i));
    Vec<__nv_bfloat16>::unpack2(r.x, f);
    Vec<__nv_bfloat16>::unpack2(r.y, f + 2);
  } else {
    constexpr int kPer = 16 / sizeof(TS);
#pragma unroll
    for (int k = 0; k < N; k += kPer)
      Vec<TS>::unpack(__ldg(reinterpret_cast<const uint4*>(s + i + k)), f + k);
  }
}

// NV: 16-byte vectors a lane holds on the vector path. The scalar path
// holds nothing: it reads its elements again for the write.
// blockDim.x = 32 * w * rows_per_block (128, or 256 at w = 8).
template <typename T, typename TS, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, float eps, int w,
               int vec_path) {
  constexpr int VEC = Vec<T>::kN;
  __shared__ float red[kMaxWarps];
  const int lanes = 32 * w;                  // threads of one row
  const int t = threadIdx.x % lanes, rb = threadIdx.x / lanes;
  const long long row = (long long)blockIdx.x * (blockDim.x / lanes) + rb;
  const bool live = row < rows;              // no early return: w > 1 syncs
  const T* xr = x + (live ? row : 0) * d;
  T* orow = out + (live ? row : 0) * d;
  const int nvec = d / VEC;
  float ss = 0.f;
  uint4 raw[NV];
  if (vec_path) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {           // every load before any sum
      const int v = t + k * lanes;
      if (live && v < nvec) raw[k] = __ldg(reinterpret_cast<const uint4*>(xr) + v);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = t + k * lanes;
      if (live && v < nvec) {
        float f[VEC];
        Vec<T>::unpack(raw[k], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
      }
    }
  } else if (live) {
    for (int i = t; i < d; i += lanes) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (w > 1) {                               // the row's warps meet here
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < w; ++i) ss += red[rb * w + i];
  }
  const float r = rsqrtf(ss / (float)d + eps);
  if (!live) return;
  if (vec_path) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = t + k * lanes;
      if (v < nvec) {
        float f[VEC], s[VEC];
        Vec<T>::unpack(raw[k], f);
        load_scale<TS, VEC>(scale, v * VEC, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = f[e] * r * s[e];
        reinterpret_cast<uint4*>(orow)[v] = Vec<T>::pack(f);
      }
    }
  } else {
    for (int i = t; i < d; i += lanes) put(orow + i, to_f(xr[i]) * r * to_f(scale[i]));
  }
}

template <typename T, typename TS, int NV>
int launch_nv(const void* x, const void* scale, void* out, long long rows,
              int d, float eps, int w, int vec_path, cudaStream_t stream) {
  const int per_block = w >= 4 ? 1 : 4 / w;  // rows a block
  const long long blocks = (rows + per_block - 1) / per_block;
  rmsnorm_kernel<T, TS, NV><<<(unsigned)blocks, 32 * w * per_block, 0, stream>>>(
      (const T*)x, (const TS*)scale, (T*)out, rows, d, eps, w, vec_path);
  return (int)cudaGetLastError();
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           float eps, int w, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::kN;
  const bool vec_path = d % VEC == 0 && (uintptr_t)x % 16 == 0 &&
                        (uintptr_t)scale % 16 == 0 && (uintptr_t)out % 16 == 0;
  // vectors a lane holds (the scalar path holds none: its bound is the
  // same, so one rule picks w for both)
  const int per_lane = ((d + VEC - 1) / VEC + 32 * w - 1) / (32 * w);
#define RMS_ARGS x, scale, out, rows, d, eps, w, vec_path ? 1 : 0, stream
  if (per_lane <= 2) return launch_nv<T, TS, 2>(RMS_ARGS);
  if (per_lane <= 4) return launch_nv<T, TS, 4>(RMS_ARGS);
  if (per_lane <= 8) return launch_nv<T, TS, 8>(RMS_ARGS);
  if (per_lane <= kMaxVec) return launch_nv<T, TS, kMaxVec>(RMS_ARGS);
#undef RMS_ARGS
  return -1;
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16 (x and out share `dtype`; scale has
// `scale_dtype`). `warps_per_row` is 1, 2, 4 or 8 (the wrapper's rule).
// Returns a cudaError_t code (0 on success), -1 for arguments the kernel
// does not take (a type, w, or a row longer than 32 w lanes x 16 vectors).
// Launches on the calling thread's current device, on `stream`.
extern "C" int rmsnorm_launch(int dtype, int scale_dtype, const void* x,
                              const void* scale, void* out, long long rows,
                              int d, float eps, int warps_per_row,
                              void* stream) {
  const int w = warps_per_row;
  if (w < 1 || w > kMaxWarps || (w & (w - 1)) || d < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && scale_dtype == 0) return launch<float, float>(x, scale, out, rows, d, eps, w, s);
  if (dtype == 0 && scale_dtype == 2) return launch<float, bf16>(x, scale, out, rows, d, eps, w, s);
  if (dtype == 2 && scale_dtype == 0) return launch<bf16, float>(x, scale, out, rows, d, eps, w, s);
  if (dtype == 2 && scale_dtype == 2) return launch<bf16, bf16>(x, scale, out, rows, d, eps, w, s);
  return -1;
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
