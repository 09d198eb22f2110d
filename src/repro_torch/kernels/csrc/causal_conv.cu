// The Mamba2 block's depthwise causal conv, its bias and its SiLU, for
// Hopper (sm_90a): the x, B and C streams of one block in one launch.
//
// Replaces no TPU kernel: the JAX package's conv is plain jnp
// (src/repro/models/mamba2.py `_causal_conv`, then `jax.nn.silu`).
// Plain version: src/repro_torch/kernels/ref.py::causal_conv_ref.
//
// What it computes, for each stream (x (B, S, C), w (K, C), bias (C,),
// cache (B, K-1, C) or none):
//   xp        = cache ++ x along the sequence (K-1 zero rows without one)
//   out       = silu(sum_i xp[:, t + i] * w[i] + bias), t = 0 .. S-1
//   new cache = the last K-1 rows of xp (a copy)
// in float32, rounded once to the input's type (float32 or bf16); out and
// the new cache are contiguous.
//
// Bound: bytes (K multiply-adds, a bias and a SiLU an element, far under
// the card's operations-per-byte line). The plain version reads and
// writes (B, S, C) about eleven times (a padded copy, K strided products,
// K-1 adds, the bias, the SiLU); the design reads each input byte once and
// writes each output byte once:
// - A thread owns one 16-byte vector of channels (8 bf16 or 4 float32) of
//   one sequence and walks a run of T time steps (the wrapper's `run`).
//   Its K weights and bias stay in registers, in float32, and so do the
//   K-1 inputs before the current step, as loaded: per step one coalesced
//   16-byte load of the input and one 16-byte store of the output. Four
//   steps' loads are issued together before their arithmetic, and each
//   input stays a packed 16-byte vector until then: bf16 holds 128
//   registers a thread (two blocks of 256 an SM), and four loads in
//   flight a thread keep the card near its bandwidth. (Unpacked at the
//   load, 96 more floats a thread held the bf16 kernel at 62 % of its
//   bound; capped at fewer registers it spills.)
// - A run's K-1 inputs before its first step are the previous run's last
//   (read again: (K-1)/T extra reads, most from L2), the cache's rows, or
//   zeros. The thread of a sequence's last run writes the new cache from
//   its registers.
// - The streams share one grid: a small table of the streams' first
//   blocks (x has C = d_inner channels, B and C have N), so a decode step
//   is one launch (T = 1, the cache's K-1 rows before it).
// - A width that is not a multiple of the vector, or a base or stride off
//   the 16-byte grid, takes the same kernel's scalar path for that
//   stream, each lane's vector masked at the edge.
// - x and the cache may be strided over batch and sequence (a
//   tensor-parallel body's channel slice of a gathered cache), contiguous
//   in their channels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 4;        // conv width the kernel is built for
constexpr int kMaxStreams = 3;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // steps whose loads go out together

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

struct Stream {
  const void* x;          // (B, S, C), strides x_sb, x_ss, channels 1
  const void* w;          // (K, C) contiguous
  const void* bias;       // (C,)
  const void* cache;      // (B, K-1, C), strides c_sb, c_ss; or null
  void* out;              // (B, S, C) contiguous
  void* new_cache;        // (B, K-1, C) contiguous
  long long x_sb, x_ss, c_sb, c_ss;
  long long first_block;  // the stream's first block of the grid
  int channels, groups, runs, vec;
};

struct Args {
  Stream s[kMaxStreams];
  int n, batch, seq, run;
};

// The V values of a row from channel c0 on, as they lie in memory: one
// 16-byte load, or masked scalar loads at the edge (zeros past it).
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, int c0, int c, bool vec) {
  constexpr int V = Vec<T>::kN;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + c0));
  float f[V];
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = c0 + e < c ? to_f(p[c0 + e]) : 0.f;
  return Vec<T>::pack(f);
}

template <typename T>
__device__ __forceinline__ void load_row(const T* p, int c0, int c, bool vec,
                                         float* f) {
  Vec<T>::unpack(load_raw(p, c0, c, vec), f);
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, int c0, int c, bool vec,
                                          const float* f) {
  constexpr int V = Vec<T>::kN;
  if (vec) {
    *reinterpret_cast<uint4*>(p + c0) = Vec<T>::pack(f);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c0 + e < c) put(p + c0 + e, f[e]);
  }
}

template <typename T>
__device__ __forceinline__ void store_raw(T* p, int c0, int c, bool vec,
                                          const uint4& r) {
  if (vec) {
    *reinterpret_cast<uint4*>(p + c0) = r;
  } else {
    float f[Vec<T>::kN];
    Vec<T>::unpack(r, f);
    store_row(p, c0, c, false, f);
  }
}

__device__ __forceinline__ float silu(float v) {
  // v / (1 + e^-v); e^-v = inf below ~-88 gives -0 (silu's limit)
  return __fdividef(v, 1.f + __expf(-v));
}

// U steps from t: their loads first, then each output from the K-1
// inputs before it (h, oldest first) and the new ones; h then slides.
// Inputs stay as loaded (raw vectors) until their arithmetic.
template <typename T, int K, int U>
__device__ __forceinline__ void steps(const T* xb, long long x_ss, T* ob,
                                      int t, int c, int c0, bool vec,
                                      uint4 (&h)[K - 1],
                                      const float (&w)[K][Vec<T>::kN],
                                      const float (&bias)[Vec<T>::kN]) {
  constexpr int V = Vec<T>::kN, H = K - 1;
  uint4 f[U];
#pragma unroll
  for (int u = 0; u < U; ++u) f[u] = load_raw(xb + (long long)(t + u) * x_ss, c0, c, vec);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float in[K][V], o[V];
#pragma unroll
    for (int i = 0; i < K; ++i) Vec<T>::unpack(u + i < H ? h[u + i] : f[u + i - H], in[i]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float acc = in[0][e] * w[0][e];
#pragma unroll
      for (int i = 1; i < K; ++i) acc = fmaf(in[i][e], w[i][e], acc);
      o[e] = silu(acc + bias[e]);
    }
    store_row(ob + (long long)(t + u) * c, c0, c, vec, o);
  }
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = j + U < H ? h[j + U] : f[j + U - H];
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
causal_conv_kernel(const __grid_constant__ Args a) {
  constexpr int V = Vec<T>::kN, H = K - 1;
  int si = 0;
#pragma unroll
  for (int i = 1; i < kMaxStreams; ++i)
    if (i < a.n && (long long)blockIdx.x >= a.s[i].first_block) si = i;
  const Stream& st = a.s[si];
  const long long item =
      ((long long)blockIdx.x - st.first_block) * kThreads + threadIdx.x;
  if (item >= (long long)a.batch * st.runs * st.groups) return;
  const int g = (int)(item % st.groups);
  const long long rest = item / st.groups;
  const int r = (int)(rest % st.runs), b = (int)(rest / st.runs);
  const int c = st.channels, c0 = g * V;
  const bool vec = st.vec != 0;
  const int t0 = r * a.run, t1 = min(t0 + a.run, a.seq);

  float w[K][V], bias[V];
  uint4 h[H];
#pragma unroll
  for (int i = 0; i < K; ++i)
    load_row((const T*)st.w + (long long)i * c, c0, c, vec, w[i]);
  load_row((const T*)st.bias, c0, c, vec, bias);
  const T* xb = (const T*)st.x + b * st.x_sb;
#pragma unroll
  for (int j = 0; j < H; ++j) {       // the inputs at t0 - H .. t0 - 1
    const int p = t0 - H + j;
    if (p >= 0)
      h[j] = load_raw(xb + (long long)p * st.x_ss, c0, c, vec);
    else if (st.cache != nullptr)
      h[j] = load_raw((const T*)st.cache + b * st.c_sb + (long long)(H + p) * st.c_ss,
                      c0, c, vec);
    else
      h[j] = make_uint4(0, 0, 0, 0);
  }
  T* ob = (T*)st.out + (long long)b * a.seq * c;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll)
    steps<T, K, kUnroll>(xb, st.x_ss, ob, t, c, c0, vec, h, w, bias);
  for (; t < t1; ++t) steps<T, K, 1>(xb, st.x_ss, ob, t, c, c0, vec, h, w, bias);
  if (t1 == a.seq) {                  // the sequence's last run
    T* nb = (T*)st.new_cache + (long long)b * H * c;
#pragma unroll
    for (int j = 0; j < H; ++j) store_raw(nb + (long long)j * c, c0, c, vec, h[j]);
  }
}

template <typename T, int K>
int launch(const Args& a, long long blocks, cudaStream_t s) {
  causal_conv_kernel<T, K><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(int k, const Args& a, long long blocks, cudaStream_t s) {
  switch (k) {
    case 2: return launch<T, 2>(a, blocks, s);
    case 3: return launch<T, 3>(a, blocks, s);
    case 4: return launch<T, kMaxK>(a, blocks, s);
    default: return -1;
  }
}

bool on16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// dtype code: 0 float32, 2 bfloat16, for every tensor of every stream.
// Per stream i of n (1-3), six pointers ptrs[6i ..]: x, w, bias, cache
// (null: zeros), out, new cache; four strides strides[4i ..], in
// elements: x over batch and sequence, the cache over batch and row; its
// channel count channels[i]. `k` is the conv width (2-4), `run` the steps
// a thread walks. Returns a cudaError_t code (0 on success), -1 for
// arguments the kernel does not take. Launches on the calling thread's
// current device, on `stream`.
extern "C" int causal_conv_launch(int dtype, int n, int k, int batch, int seq,
                                  int run, void* const* ptrs,
                                  const long long* strides,
                                  const int* channels, void* stream) {
  if (n < 1 || n > kMaxStreams || k < 2 || k > kMaxK || batch < 1 ||
      seq < 1 || run < 1 || (dtype != 0 && dtype != 2))
    return -1;
  const int vec_n = dtype == 0 ? 4 : 8;
  Args a = {};
  a.n = n; a.batch = batch; a.seq = seq; a.run = run;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    Stream& st = a.s[i];
    void* const* p = ptrs + 6 * i;
    const long long* sd = strides + 4 * i;
    st.x = p[0]; st.w = p[1]; st.bias = p[2]; st.cache = p[3];
    st.out = p[4]; st.new_cache = p[5];
    st.x_sb = sd[0]; st.x_ss = sd[1]; st.c_sb = sd[2]; st.c_ss = sd[3];
    st.channels = channels[i];
    if (st.channels < 1) return -1;
    st.groups = (st.channels + vec_n - 1) / vec_n;
    st.runs = (seq + run - 1) / run;
    st.vec = st.channels % vec_n == 0 && on16(st.x) && on16(st.w) &&
             on16(st.bias) && on16(st.out) && on16(st.new_cache) &&
             st.x_sb % vec_n == 0 && st.x_ss % vec_n == 0 &&
             (st.cache == nullptr ||
              (on16(st.cache) && st.c_sb % vec_n == 0 && st.c_ss % vec_n == 0));
    st.first_block = blocks;
    blocks += ((long long)batch * st.runs * st.groups + kThreads - 1) / kThreads;
  }
  if (blocks > 0x7fffffffLL) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_k<float>(k, a, blocks, s);
  return launch_k<__nv_bfloat16>(k, a, blocks, s);
}

extern "C" const char* causal_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
