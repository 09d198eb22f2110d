// Single-query attention over a KV cache (flash decoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:83
// (`_kernel`, launched by `flash_decode` through `pl.pallas_call`).
// Plain versions: src/repro_torch/kernels/ref.py::decode_attention_ref (the
// function) and ::decode_attention_split_ref (this two-pass decomposition).
//
// What it computes: q (B, 1, H, D) against the cache k/v (B, S, KV, D); key
// j is visible iff j <= pos and, with a window, j > pos - window. The
// rep = H / KV q heads of one kv group share its keys. Online softmax in
// float32 with -1e30 for masked scores; out = acc / max(l, 1e-30) in the
// input's type. Head size D is 64, 112 (zamba2-7b) or 128: the tilings
// below step through D in 16-column pieces, and 112 is seven of them.
//
// Bound: bytes (each visible K/V row is read once; ~4*D operations per key
// and head), and at the serving and full-width sizes (0.03-13 MB of K/V)
// latency: the whole read takes 0.01-4 us at HBM rate, so what costs is
// how many loads are in flight and on how many SMs. Two levers:
// - Split the keys across blocks (flash decoding). The wrapper plans on
//   the host (flash_decode.py::plan_splits): the visible range, rounded
//   down to a 64-key tile, is cut into `splits` contiguous pieces of whole
//   tiles so that B * KV * splits fills the SMs about once. Pass 1 runs one
//   block per (split, kv group, batch) and writes a float32 partial
//   (m, l, acc[D]) per (batch, head, split); pass 2 merges the splits with
//   the log-sum-exp rule and writes out. With one split pass 1 writes out
//   itself and there is no second launch (serving's batch-1 short caches).
// - Wide loads, many in flight. Each tile's K and V rows go to shared
//   memory by 16-byte cp.async copies (8 bf16 or 4 float32 a thread, a
//   whole tile's worth issued at once), in a ring of three tiles, so the
//   next tiles load while this one is scored. Rows past the split's end
//   (past pos, past S) are never read: their copies zero-fill.
// Inside a block: four warps whatever rep is; warp w takes keys
// 16w..16w+15 of each tile, scores them against every q head of the group
// and keeps its own online-softmax state per head; the four warps merge in
// shared memory at the end of the block. Two pass-1 kernels, by type:
// - bf16 (every full-width path) on the tensor cores: the group's rep <= 16
//   q heads are the rows of one mma.sync m16n8k16 A operand, so a warp's
//   16 keys cost D / 8 mma for the scores and D / 8 for P V; P is rounded
//   to bf16 for the second product, as the plain version rounds it.
// - float32 as float32 FMAs (tensor-core float32 would be TF32, about three
//   digits): lane (j, half) scores key j for the heads of its half (16-byte
//   row reads on 16-byte-padded rows hit distinct banks), lane i owns
//   output columns i, i+32, ... below D (at D = 112 the last group is half
//   used); the probabilities stay float32.
// A warp or split whose keys are all masked (a window that starts inside
// its tile, pos 0) carries m = -1e30, l = 0 and gets weight 0 in the merge:
// masked probabilities are exactly 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxRep = 16;   // q heads per kv group
constexpr int kTile = 64;     // keys per tile (the planner's unit)
constexpr int kWarps = 4;
constexpr int kWarpKeys = kTile / kWarps;  // 16 keys of a tile per warp
constexpr int kStages = 3;    // tiles in flight per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// the 16-byte chunk at p as four float32 values
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// max / sum over the 16 lanes of a half warp
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {  // elements between neighbours along batch, seq, head
  long long b, s, h;
};

template <typename T, int D>
struct Smem {
  static constexpr int kE = 16 / sizeof(T);        // elements per 16 bytes
  static constexpr int kRowChunks = D / kE;        // 16-byte chunks per row
  static constexpr int kRow = D + kE;              // padded row, elements
  static constexpr int kTileElems = kTile * kRow;
  static constexpr int kQRow = D + 4;             // padded q row, floats
  static constexpr size_t kKV = 2ull * kStages * kTileElems * sizeof(T);
  // the warps' partials reuse the K/V ring after the loop
  static constexpr size_t kMerge = (size_t)kWarps * kMaxRep * (D + 2) * sizeof(float);
  static constexpr size_t kRing = kKV > kMerge ? kKV : kMerge;
  static constexpr size_t kBytes = kRing + (size_t)kMaxRep * kQRow * sizeof(float);
};

// Tile t of a split (keys s_begin + 64t ...) -> ring slot t % kStages, by
// 16-byte cp.async copies; rows at or past s_end read nothing and are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* ring, int t, const T* kb,
                                          const T* vb, long long k_row,
                                          long long v_row, int s_begin,
                                          int s_end, int tid) {
  using L = Smem<T, D>;
  T* ks = ring + (t % kStages) * L::kTileElems;
  T* vs = ks + kStages * L::kTileElems;
  const int kt = s_begin + t * kTile;
#pragma unroll
  for (int n = 0; n < kTile * L::kRowChunks / (kWarps * 32); ++n) {
    const int i = tid + n * kWarps * 32;
    const int j = i / L::kRowChunks, c = (i % L::kRowChunks) * L::kE;
    const int kj = kt + j;
    const bool ok = kj < s_end;
    const long long kr = ok ? kj : 0;
    cp_async16(ks + j * L::kRow + c, kb + kr * k_row + c, ok ? 16 : 0);
    cp_async16(vs + j * L::kRow + c, vb + kr * v_row + c, ok ? 16 : 0);
  }
}

// The end of pass 1: the four warps' (m, l, acc) per head, written to `mg`
// as [warp][head][D + 2] by the caller, merged by the log-sum-exp rule into
// out (one split) or the split's float32 partial.
template <typename T, int D>
__device__ __forceinline__ void merge_warps(
    const float* mg, int rep, int h, int g, int b, int split, int splits,
    T* out, const Strides& os_, float* part_m, float* part_l,
    float* part_acc) {
  constexpr int kStride = D + 2;
  for (int i = threadIdx.x; i < rep * D; i += kWarps * 32) {
    const int r = i / D, c = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mg[(w * kMaxRep + r) * kStride + D]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* row = mg + (w * kMaxRep + r) * kStride;
      const float wt = expf(row[D] - mx);  // 0 for a warp that saw no key
      lt += wt * row[D + 1];
      at += wt * row[c];
    }
    const int hq = g * rep + r;
    if (part_m == nullptr) {  // one split: this block is the whole answer
      put(out + b * os_.b + hq * os_.h + c, at / fmaxf(lt, 1e-30f));
    } else {
      const long long pi = ((long long)b * h + hq) * splits + split;
      part_acc[pi * D + c] = at;
      if (c == 0) { part_m[pi] = mx; part_l[pi] = lt; }
    }
  }
}

// Pass 1, float32: one block per (split, kv group, batch), scores and PV as
// float32 FMAs (tensor-core float32 would be TF32). REPB bounds rep (1, 4
// or 16) so the per-head state stays in registers with constant indices.
template <int D, int REPB>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int rep, int h,
                        Strides qs_, Strides ks_, Strides vs_, Strides os_,
                        int k_first, int k_end, int chunk, int win_lo,
                        float scale) {
  using T = float;
  using L = Smem<T, D>;
  constexpr int kE = L::kE, kRow = L::kRow;
  constexpr int kQRow = L::kQRow;
  constexpr int kCols = (D + 31) / 32;     // output columns per lane
  constexpr int kHalfHeads = (REPB + 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);                 // [2][stage][tile]
  float* q_s = reinterpret_cast<float*>(smem_raw + L::kRing);  // [rep][kQRow]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int s_begin = k_first + split * chunk;
  const int s_end = min(s_begin + chunk, k_end);
  const int lo = max(s_begin, win_lo);   // first visible key of the split
  const int ntiles = (s_end - s_begin + kTile - 1) / kTile;
  const T* kb = k + b * ks_.b + g * ks_.h;
  const T* vb = v + b * vs_.b + g * vs_.h;

  auto issue = [&](int t) {
    load_tile<T, D>(kv_s, t, kb, vb, ks_.s, vs_.s, s_begin, s_end, tid);
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();
  }

  for (int i = tid; i < rep * D; i += kWarps * 32) {
    const int r = i / D, c = i % D;
    q_s[r * kQRow + c] = q[b * qs_.b + (g * rep + r) * qs_.h + c];
  }

  const int jj = lane & 15, half = lane >> 4;
  float m[REPB], l[REPB], acc[REPB][kCols];
#pragma unroll
  for (int r = 0; r < REPB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + kStages - 1 < ntiles) issue(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // tile t has landed (this thread's part)
    __syncthreads();                // ... and every thread's; q_s is loaded
    const T* ks = kv_s + (t % kStages) * L::kTileElems;
    const T* vs = ks + kStages * L::kTileElems;
    const int key = warp * kWarpKeys + jj;        // row of the tile
    const int kj = s_begin + t * kTile + key;
    const bool vis = kj >= lo && kj < s_end;

    // scores of key jj against the heads of this lane's half
    float sc[kHalfHeads];
#pragma unroll
    for (int i = 0; i < kHalfHeads; ++i) sc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += kE) {
      float kf[kE];
      load16(ks + key * kRow + c, kf);
#pragma unroll
      for (int i = 0; i < kHalfHeads; ++i) {
        const int r = 2 * i + half;
        if (r < rep) {
          const float* qr = q_s + r * kQRow + c;
#pragma unroll
          for (int e = 0; e < kE; ++e) sc[i] += qr[e] * kf[e];
        }
      }
    }
    // online softmax per head over this warp's 16 keys
    float p[kHalfHeads];
#pragma unroll
    for (int i = 0; i < kHalfHeads; ++i) {
      if (2 * i >= rep) break;  // warp-uniform: heads past rep do nothing
      const bool ok = vis && (2 * i + half) < rep;
      const float sv = ok ? sc[i] * scale : kNegInf;
      const float mx_mine = half_max(sv);
      const float mx_other = __shfl_xor_sync(0xffffffffu, mx_mine, 16);
      const float mx0 = half ? mx_other : mx_mine;   // head 2i
      const float mx1 = half ? mx_mine : mx_other;   // head 2i + 1
      float m_new[2], alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (2 * i + e < REPB) {
          m_new[e] = fmaxf(m[2 * i + e], e ? mx1 : mx0);
          alpha[e] = expf(m[2 * i + e] - m_new[e]);
          m[2 * i + e] = m_new[e];
        } else {
          m_new[e] = kNegInf;
          alpha[e] = 1.f;
        }
      }
      p[i] = ok ? expf(sv - (half ? m_new[1] : m_new[0])) : 0.f;
      const float s_mine = half_sum(p[i]);
      const float s_other = __shfl_xor_sync(0xffffffffu, s_mine, 16);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (2 * i + e < REPB) {
          const float ps = (e == half) ? s_mine : s_other;
          l[2 * i + e] = l[2 * i + e] * alpha[e] + ps;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[2 * i + e][c] *= alpha[e];
        }
      }
    }
    // acc += p V over this warp's 16 keys
#pragma unroll 4
    for (int j = 0; j < kWarpKeys; ++j) {
      const T* vrow = vs + (warp * kWarpKeys + j) * kRow;
      float vc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        vc[c] = (D % 32 == 0 || lane + 32 * c < D) ? vrow[lane + 32 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < kHalfHeads; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (2 * i + e < REPB && 2 * i + e < rep) {
            const float pj = __shfl_sync(0xffffffffu, p[i], j + 16 * e);
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[2 * i + e][c] += pj * vc[c];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this ring slot
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the four warps' states: [warp][head] m, l, acc[D] over the ring
  float* mg = reinterpret_cast<float*>(smem_raw);
  constexpr int kStride = D + 2;
#pragma unroll
  for (int r = 0; r < REPB; ++r) {
    if (r < rep) {
      float* row = mg + (warp * kMaxRep + r) * kStride;
      if (lane == 0) { row[D] = m[r]; row[D + 1] = l[r]; }
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (D % 32 == 0 || lane + 32 * c < D) row[lane + 32 * c] = acc[r][c];
    }
  }
  __syncthreads();
  merge_warps<T, D>(mg, rep, h, g, b, split, splits, out, os_, part_m,
                    part_l, part_acc);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// d += a b: m16n8k16, bf16 operands, float32 accumulate (tensor cores)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8 x 8 bf16 matrices from shared memory, transposed: lane i gives the
// address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Pass 1, bf16: the same block and ring as the float32 kernel, products on
// the tensor cores. The group's rep <= 16 q heads are the 16 rows of one
// m16n8k16 A operand (rows past rep are zero), so each warp's 16 keys of a
// tile cost D / 8 mma for the scores and D / 8 for P V. Lane (g = lane / 4,
// t = lane % 4) holds heads g and g + 8: scores of keys 2t, 2t+1, 8+2t,
// 9+2t of the warp's 16, and columns 8j + 2t, 8j + 2t + 1 of acc; a head's
// max and sum are shuffles among the four lanes of its row. The score
// fragment is the A fragment of P V (P rounded to bf16, as the plain
// version rounds it); V's B fragments come transposed by ldmatrix.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int rep, int h,
                        Strides qs_, Strides ks_, Strides vs_, Strides os_,
                        int k_first, int k_end, int chunk, int win_lo,
                        float scale) {
  using T = __nv_bfloat16;
  using L = Smem<T, D>;
  constexpr int kRow = L::kRow;
  constexpr int kQRow = D + 8;            // bf16 q rows, padded
  constexpr int kN = D / 8;               // 8-column tiles of acc
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);
  T* q_s = reinterpret_cast<T*>(smem_raw + L::kRing);  // [16][kQRow]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int s_begin = k_first + split * chunk;
  const int s_end = min(s_begin + chunk, k_end);
  const int lo = max(s_begin, win_lo);
  const int ntiles = (s_end - s_begin + kTile - 1) / kTile;
  const T* kb = k + b * ks_.b + g * ks_.h;
  const T* vb = v + b * vs_.b + g * vs_.h;

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles)
      load_tile<T, D>(kv_s, t, kb, vb, ks_.s, vs_.s, s_begin, s_end, tid);
    cp_async_commit();
  }
  for (int i = tid; i < kMaxRep * D; i += kWarps * 32) {
    const int r = i / D, c = i % D;
    q_s[r * kQRow + c] = r < rep ? q[b * qs_.b + (g * rep + r) * qs_.h + c]
                                 : __float2bfloat16(0.f);
  }
  __syncthreads();
  uint32_t qa[D / 16][4];  // A fragments of the 16 q rows, 16 columns each
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const T* q0 = q_s + gr * kQRow + ks * 16 + 2 * t4;
    qa[ks][0] = ld32(q0);
    qa[ks][1] = ld32(q0 + 8 * kQRow);
    qa[ks][2] = ld32(q0 + 8);
    qa[ks][3] = ld32(q0 + 8 * kQRow + 8);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // heads gr, gr + 8
  float acc[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + kStages - 1 < ntiles)
      load_tile<T, D>(kv_s, t + kStages - 1, kb, vb, ks_.s, vs_.s, s_begin,
                      s_end, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* kw = kv_s + (t % kStages) * L::kTileElems + warp * kWarpKeys * kRow;
    const T* vw = kw + kStages * L::kTileElems;
    const int key0 = s_begin + t * kTile + warp * kWarpKeys;

    float sc[2][4];  // keys 8n + 2t4 + {0, 1}: heads gr (0, 1), gr + 8 (2, 3)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      const T* krow = kw + (8 * n + gr) * kRow + 2 * t4;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_bf16(sc[n], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = key0 + 8 * n + 2 * t4 + (e & 1);
        const float x = (kj >= lo && kj < s_end) ? sc[n][e] * scale : kNegInf;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p = x == kNegInf ? 0.f : expf(x - m[e >> 1]);
        sc[n][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rsum[hh];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
    // lane i addresses key (i % 8) + 8 ((i / 8) % 2), columns 16n + 8 (i / 16)
    const T* vrow = vw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kRow + 8 * (lane >> 4);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t vb4[4];
      ldmatrix_x4_trans(vb4, vrow + 16 * n);
      mma_bf16(acc[2 * n], pa, vb4[0], vb4[1]);
      mma_bf16(acc[2 * n + 1], pa, vb4[2], vb4[3]);
    }
    __syncthreads();  // every warp is done with this ring slot
  }
  cp_async_wait<0>();
  __syncthreads();

  float* mg = reinterpret_cast<float*>(smem_raw);
  constexpr int kStride = D + 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    float* row = mg + (warp * kMaxRep + gr + 8 * hh) * kStride;
    if (t4 == 0) { row[D] = m[hh]; row[D + 1] = l[hh]; }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      row[8 * j + 2 * t4] = acc[j][2 * hh];
      row[8 * j + 2 * t4 + 1] = acc[j][2 * hh + 1];
    }
  }
  __syncthreads();
  merge_warps<T, D>(mg, rep, h, g, b, split, splits, out, os_, part_m,
                    part_l, part_acc);
}

// Pass 2: one block of D threads per (q head, batch) merges the splits.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc,
                            T* __restrict__ out, int h, int splits,
                            Strides os_) {
  const int hq = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const long long base = ((long long)b * h + hq) * splits;
  float mx = kNegInf;
  for (int i = 0; i < splits; ++i) mx = fmaxf(mx, part_m[base + i]);
  float lt = 0.f, at = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float wt = expf(part_m[base + i] - mx);  // 0 for an all-masked split
    lt += wt * part_l[base + i];
    at += wt * part_acc[(base + i) * D + c];
  }
  put(out + b * os_.b + hq * os_.h + c, at / fmaxf(lt, 1e-30f));
}

template <typename T, int D, typename Kernel>
int launch_split(Kernel kern, const void* q, const void* k, const void* v,
                 void* out, float* part, int b, int kv, int rep,
                 const long long* st, int k_first, int k_end, int chunk,
                 int splits, int win_lo, float scale, cudaStream_t stream) {
  using L = Smem<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int h = kv * rep;
  const Strides qs_{st[0], st[1], st[2]}, ks_{st[3], st[4], st[5]},
      vs_{st[6], st[7], st[8]}, os_{st[9], st[10], st[11]};
  float* pm = nullptr;
  float* pl = nullptr;
  float* pa = nullptr;
  if (splits > 1) {  // part holds m, l (B*H*splits each), then acc (*D)
    const long long n = (long long)b * h * splits;
    pm = part;
    pl = part + n;
    pa = part + 2 * n;
  }
  kern<<<dim3(splits, kv, b), kWarps * 32, L::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, pm, pl, pa, rep, h,
      qs_, ks_, vs_, os_, k_first, k_end, chunk, win_lo, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  flash_decode_combine_kernel<T, D><<<dim3(h, b), D, 0, stream>>>(
      pm, pl, pa, (T*)out, h, splits, os_);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(int rep, const void* q, const void* k, const void* v, void* out,
           float* part, int b, int kv, const long long* st, int k_first,
           int k_end, int chunk, int splits, int win_lo, float scale,
           cudaStream_t stream) {
#define FD_ARGS q, k, v, out, part, b, kv, rep, st, k_first, k_end, chunk, \
    splits, win_lo, scale, stream
  if (rep < 1 || rep > kMaxRep) return -1;
  if constexpr (sizeof(T) == 2) {
    return launch_split<T, D>(flash_decode_mma_kernel<D>, FD_ARGS);
  } else {
    if (rep == 1)
      return launch_split<T, D>(flash_decode_f32_kernel<D, 1>, FD_ARGS);
    if (rep <= 4)
      return launch_split<T, D>(flash_decode_f32_kernel<D, 4>, FD_ARGS);
    return launch_split<T, D>(flash_decode_f32_kernel<D, kMaxRep>, FD_ARGS);
  }
#undef FD_ARGS
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16 (q, k, v and out share it); d is 64,
// 112 or 128; H / KV at most 16; the 16-byte K/V copies need the base pointers and
// the batch, seq and head strides of k and v on 16-byte boundaries.
// `strides` holds 12 element strides: (batch, seq, head) of q, k, v, out in
// that order. The plan (flash_decode.py::plan_splits): keys [k_first, k_end)
// in `splits` pieces of `chunk` keys (a multiple of 64; the last may be
// short); keys below `win_lo` are masked. With splits > 1, `part` is a
// float32 workspace of B * H * splits * (D + 2) values. Returns a
// cudaError_t code (0 on success), -1 for arguments the kernel does not
// take. Launches on the current device, on `stream`: one kernel for one
// split, two otherwise.
extern "C" int flash_decode_launch(
    int dtype, const void* q, const void* k, const void* v, void* out,
    float* part, int b, int h, int kv, int d, const long long* strides,
    int k_first, int k_end, int chunk, int splits, int win_lo, float scale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (kv < 1 || h % kv || splits < 1 || chunk < 1 || chunk % kTile ||
      (splits > 1 && part == nullptr))
    return -1;
  const int rep = h / kv;
#define FD_ARGS rep, q, k, v, out, part, b, kv, strides, k_first, k_end, \
    chunk, splits, win_lo, scale, s
  if (dtype == 0 && d == 64) return launch<float, 64>(FD_ARGS);
  if (dtype == 0 && d == 112) return launch<float, 112>(FD_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(FD_ARGS);
  if (dtype == 2 && d == 64) return launch<__nv_bfloat16, 64>(FD_ARGS);
  if (dtype == 2 && d == 112) return launch<__nv_bfloat16, 112>(FD_ARGS);
  if (dtype == 2 && d == 128) return launch<__nv_bfloat16, 128>(FD_ARGS);
#undef FD_ARGS
  return -1;
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
