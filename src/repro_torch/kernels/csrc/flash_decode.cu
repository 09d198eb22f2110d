// Single-query attention over a KV cache (flash decode) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (`_kernel`, launched by `flash_decode` through `pl.pallas_call`).
// Plain version: src/repro_torch/kernels/ref.py::decode_attention_ref.
//
// What it computes: q (B, 1, H, D) against the cache k/v (B, S, KV, D);
// key j is visible iff j <= pos and, with a window, j > pos - window. The
// rep = H / KV q heads of one kv group share its keys. Online softmax in
// float32 with -1e30 for masked scores; out = acc / max(l, 1e-30) in the
// input's type. Like the TPU kernel, the probabilities stay float32 in the
// PV product (the plain version rounds them to the cache's type first, as
// the JAX reference does: equal in float32, within the bf16 tolerance in
// bf16).
//
// Grid and loop: one block per (kv group, batch), as the TPU grid's
// (B * KV) axis; its sequential key axis becomes a loop inside the block
// over 32-key tiles, and only tiles holding visible keys are read (the
// loop ends at pos, so a long cache costs only what is filled). One warp
// per q head of the group: the K/V tile is loaded into shared memory once
// and read by all rep warps, lane j scores key j (the K tile's padded row
// keeps the 32 lanes on 32 banks), and lane j owns output columns j, j+32,
// ... of the accumulator.
//
// Bound: bytes (the visible K/V rows are read once; ~4*D operations per
// key and head). At serving batch 1 the grid is only B * KV blocks (2 for
// starcoder2-3b, 3 for smollm-135m), so most of the 132 SMs idle; splitting
// the keys across blocks with a combining pass (flash decoding) is the
// redesign's lever.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxRep = 16;   // q heads per kv group (warps per block)
constexpr int kBlockK = 32;   // keys per tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {  // elements between neighbours along batch, seq, head
  long long b, s, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxRep * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int s_len,
                    int rep, Strides qs_, Strides ks_, Strides vs_,
                    Strides os_, int pos, int window, float scale) {
  __shared__ float q_s[kMaxRep][D];
  __shared__ float k_s[kBlockK][D + 1];
  __shared__ float v_s[kBlockK][D];
  constexpr int kCols = D / 32;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = rep * 32;
  const int g = blockIdx.x, b = blockIdx.y, hq = g * rep + warp;
  const T* kb = k + b * ks_.b + g * ks_.h;
  const T* vb = v + b * vs_.b + g * vs_.h;

  for (int i = tid; i < rep * D; i += nthreads) {
    const int r = i / D, c = i % D;
    q_s[r][c] = to_f(q[b * qs_.b + (g * rep + r) * qs_.h + c]);
  }

  float m = kNegInf, l = 0.f, acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  const int k_end = min(s_len, pos + 1);
  int k_begin = window > 0 ? max(0, pos - window + 1) : 0;
  k_begin = (k_begin / kBlockK) * kBlockK;

  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous tile is consumed (q_s is loaded)
    for (int i = tid; i < kBlockK * D; i += nthreads) {
      const int j = i / D, c = i % D, kj = kt + j;
      const bool ok = kj < s_len;
      k_s[j][c] = ok ? to_f(kb[kj * ks_.s + c]) : 0.f;
      v_s[j][c] = ok ? to_f(vb[kj * vs_.s + c]) : 0.f;
    }
    __syncthreads();

    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) s += q_s[warp][c] * k_s[lane][c];
    const int kj = kt + lane;
    bool vis = kj < s_len && kj <= pos;
    if (window > 0) vis = vis && kj > pos - window;
    const float sv = vis ? s * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(sv));
    const float p = expf(sv - m_new);
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] += pj * v_s[j][lane + 32 * i];
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + b * os_.b + hq * os_.h;
#pragma unroll
  for (int i = 0; i < kCols; ++i) put(orow + lane + 32 * i, acc[i] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s_len, int kv, int rep, const long long* st, int pos,
           int window, float scale, cudaStream_t stream) {
  if (rep < 1 || rep > kMaxRep) return -1;
  const dim3 grid(kv, b);
  const Strides qs_{st[0], st[1], st[2]}, ks_{st[3], st[4], st[5]},
      vs_{st[6], st[7], st[8]}, os_{st[9], st[10], st[11]};
  flash_decode_kernel<T, D><<<grid, rep * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s_len, rep, qs_, ks_,
      vs_, os_, pos, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16 (q, k, v and out share it); d is 64 or
// 128; H / KV at most 16. `strides` holds 12 element strides: (batch, seq,
// head) of q, k, v, out in that order. Returns a cudaError_t code (0 on
// success), -1 for arguments the kernel does not take. Launches on the
// current device, on `stream`.
extern "C" int flash_decode_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int b,
    int s_len, int h, int kv, int d, const long long* strides, int pos,
    int window, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rep = h / kv;
#define FD_ARGS q, k, v, out, b, s_len, kv, rep, strides, pos, window, scale, s
  if (dtype == 0 && d == 64) return launch<float, 64>(FD_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(FD_ARGS);
  if (dtype == 2 && d == 64) return launch<__nv_bfloat16, 64>(FD_ARGS);
  if (dtype == 2 && d == 128) return launch<__nv_bfloat16, 128>(FD_ARGS);
#undef FD_ARGS
  return -1;
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
