// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`_kernel`, launched by `_flash_fwd` through `pl.pallas_call`).
// Plain version: src/repro_torch/kernels/ref.py::attention_ref.
//
// What it computes: q (B, Sq, H, D), k/v (B, Sk, KV, D), query i at absolute
// position i + q_offset sees key j iff j <= i (causal) and j > i - window
// (window > 0); q head h reads kv head h / (H / KV). Online softmax in
// float32: running max m, running sum l, accumulator acc; masked scores are
// -1e30 (exp() gives 0, never NaN); out = acc / max(l, 1e-30), in the
// input's type (float32 or bf16).
//
// Layout: the (B, S, heads, D) tensors are read through their batch, seq
// and head strides (the last axis is contiguous), so the TPU wrapper's
// transposes have no counterpart. Any Sq and Sk: the ragged q tile and key
// tile are masked (the TPU kernel asserts divisibility).
//
// Grid and loop: one block of 4 warps per (16-query tile, q head, batch).
// The TPU grid's sequential k axis becomes a loop inside the block over
// 32-key tiles, from the first key the tile's window can see to the last
// its causal bound allows, so tiles wholly outside the mask are never
// read. Each warp owns 4 query rows; lane j scores key j of the tile for
// all 4 rows (q rows in shared memory are broadcast reads; the K tile has
// a padded row so the 32 lanes hit 32 banks), the row max and sum are warp
// shuffles, and lane j owns output columns j, j+32, ... of acc, fed by the
// probabilities shuffled from their lanes.
//
// Bound: at prefill lengths, operations (4*D per visible query-key pair);
// this first kernel runs them as float32 FMAs on the CUDA cores, not on the
// tensor cores, so it stays far from the bf16 bound. wgmma tiles, TMA
// loads and a deeper pipeline are for the redesign.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;                 // warps per block
constexpr int kRows = 4;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per block
constexpr int kBlockK = 32;               // keys per tile: one per lane
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
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int sq, int sk, int rep, Strides qs_, Strides ks_,
                       Strides vs_, Strides os_, int causal, int window,
                       int q_offset, float scale) {
  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];  // +1: lane j reads row j conflict-free
  __shared__ float v_s[kBlockK][D];
  constexpr int kCols = D / 32;          // output columns per lane

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int hq = blockIdx.y, b = blockIdx.z, g = hq / rep;
  const T* qb = q + b * qs_.b + hq * qs_.h;
  const T* kb = k + b * ks_.b + g * ks_.h;
  const T* vb = v + b * vs_.b + g * vs_.h;

  for (int i = tid; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D, c = i % D, qi = q0 + r;
    q_s[r][c] = qi < sq ? to_f(qb[qi * qs_.s + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[r][i] = 0.f;
  }

  // keys any row of this tile can see: [k_begin, k_end)
  const int last_q = min(q0 + kBlockQ, sq) - 1 + q_offset;
  const int k_end = causal ? min(sk, last_q + 1) : sk;
  int k_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  k_begin = (k_begin / kBlockK) * kBlockK;

  for (int kt = k_begin; kt < k_end; kt += kBlockK) {
    __syncthreads();  // the previous tile is consumed (q_s is loaded)
    for (int i = tid; i < kBlockK * D; i += kWarps * 32) {
      const int j = i / D, c = i % D, kj = kt + j;
      const bool ok = kj < sk;
      k_s[j][c] = ok ? to_f(kb[kj * ks_.s + c]) : 0.f;
      v_s[j][c] = ok ? to_f(vb[kj * vs_.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kv = k_s[lane][c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += q_s[warp * kRows + r][c] * kv;
    }

    const int kj = kt + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r + q_offset;
      bool vis = kj < sk;
      if (causal) vis = vis && kj <= qi;
      if (window > 0) vis = vis && kj > qi - window;
      const float sv = vis ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = expf(sv - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[r][i] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[r][i] += pj * v_s[j][lane + 32 * i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + b * os_.b + qi * os_.s + hq * os_.h;
#pragma unroll
    for (int i = 0; i < kCols; ++i) put(orow + lane + 32 * i, acc[r][i] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int h, int rep, const long long* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  const Strides qs_{st[0], st[1], st[2]}, ks_{st[3], st[4], st[5]},
      vs_{st[6], st[7], st[8]}, os_{st[9], st[10], st[11]};
  flash_attention_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, rep, qs_, ks_,
      vs_, os_, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16 (q, k, v and out share it); d is 64 or
// 128. `strides` holds 12 element strides: (batch, seq, head) of q, k, v,
// out in that order. Returns a cudaError_t code (0 on success), -1 for an
// unsupported dtype or head size. Launches on the current device, on
// `stream`.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int b,
    int sq, int sk, int h, int kv, int d, const long long* strides, int causal,
    int window, int q_offset, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rep = h / kv;
#define FA_ARGS q, k, v, out, b, sq, sk, h, rep, strides, causal, window, q_offset, scale, s
  if (dtype == 0 && d == 64) return launch<float, 64>(FA_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(FA_ARGS);
  if (dtype == 2 && d == 64) return launch<__nv_bfloat16, 64>(FA_ARGS);
  if (dtype == 2 && d == 128) return launch<__nv_bfloat16, 128>(FA_ARGS);
#undef FA_ARGS
  return -1;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
