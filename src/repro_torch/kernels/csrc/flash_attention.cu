// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:98
// (`_kernel`, launched by `_flash_fwd` through `pl.pallas_call`).
// Plain version: src/repro_torch/kernels/ref.py::attention_ref.
//
// What it computes: q (B, Sq, H, D), k/v (B, Sk, KV, D), query i at absolute
// position i + q_offset sees key j iff j <= i (causal) and j > i - window
// (window > 0); q head h reads kv head h / (H / KV). Online softmax in
// float32: running max m, running sum l, accumulator acc; masked scores are
// -1e30 (exp() gives 0, never NaN); out = acc / max(l, 1e-30), in the
// input's type. Any Sq and Sk: the ragged q tile and key tile are masked
// (the TPU kernel asserts divisibility). In both kernels the TPU grid's
// sequential k axis becomes a loop inside the block over key tiles, from
// the first key the tile's window can see to the last its causal bound
// allows, so tiles wholly outside the mask are never read. The (B, S,
// heads, D) tensors are read through their strides, so the TPU wrapper's
// transposes have no counterpart. Head size D is 64, 112 (zamba2-7b) or
// 128.
//
// Bound: at prefill lengths, operations (4*D per visible query-key pair).
// Two kernels, picked by type:
//
// bf16 (every full-width path): QK^T and PV on the tensor cores with
// `wgmma`. One block per (64-query tile, q head, batch): one consumer
// warpgroup owns the 64 rows, one producer warp issues TMA loads. Q is
// loaded once; 64-key K and V tiles are staged by TMA (`cp.async.bulk.
// tensor`, 4-d maps over the (D, heads, S, B) view with the tensors' own
// strides, built on the host with cuTensorMapEncodeTiled) into a ring of
// two stages in shared memory, each stage released by an `mbarrier` the
// consumers arrive on and filled under one the TMA completes. The maps use
// the 128-byte swizzle the `wgmma` descriptors expect: a D = 64 bf16 row is
// one 128-byte atom, D = 128 two 64-column panels. D = 112 keeps the D = 128
// tiling: its maps carry the true width, so TMA fills columns 112-127 of
// the second panel with zeros (its out-of-bounds fill), and the padded
// columns add nothing. S = Q K^T is m64n64k16 with both operands K-major
// (contiguous along D), D / 16 steps (7 at D = 112: the padding is never
// multiplied).
// The softmax runs on the accumulator fragments in registers: each thread
// holds two rows' columns, the row max and sum are shuffles among the four
// threads of a row, and the mask is applied only on tiles that cross the
// causal diagonal, the window edge or Sk. P is rounded to bf16 in registers
// and is the A operand of P V (m64nDk16, n 128 at D = 112: its last 16
// columns are the zeros of V's padding and are not stored), whose B
// operand V is read
// MN-major (the descriptor's transpose bit): the accumulator fragment of S
// is the A fragment of P V, so no shuffle is needed. Rounding P to bf16 is
// what FlashAttention-3 does; it stays inside the bf16 tolerance against
// attention_ref, which keeps P in float32. TMA zero-fills rows past Sq and
// Sk; keys >= Sk are masked and rows >= Sq are not stored. The rep q heads
// of a kv group read the same K/V tiles, shared through L2.
//
// float32: float32 `wgmma` would be TF32 (about three digits) and miss the
// 2e-5 tolerance, so float32 keeps a CUDA-core kernel (it beats SDPA in
// float32 on the card): one block of 4 warps per (16-query tile, q head,
// batch) loops over 32-key tiles; each warp owns 4 query rows, lane j
// scores key j of the tile for all 4 rows (the K tile has a padded row so
// the 32 lanes hit 32 banks), the row max and sum are warp shuffles, and
// lane j owns output columns j, j+32, ... of acc (below D: at D = 112 the
// last column group is half used).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps per block
constexpr int kRows = 4;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per block
constexpr int kBlockK = 32;               // keys per tile: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

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
  constexpr int kCols = (D + 31) / 32;   // output columns per lane

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
        for (int i = 0; i < kCols; ++i)
          if (D % 32 == 0 || lane + 32 * i < D)
            acc[r][i] += pj * v_s[j][lane + 32 * i];
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
    for (int i = 0; i < kCols; ++i)
      if (D % 32 == 0 || lane + 32 * i < D)
        put(orow + lane + 32 * i, acc[r][i] * inv);
  }
}

// ============================ bf16: wgmma + TMA ==============================
namespace wg {

constexpr int kBlockQ = 64;            // query rows per block: one wgmma M
constexpr int kBlockK = 64;            // keys per tile
constexpr int kStages = 2;             // K/V tiles in the ring
constexpr int kConsumers = 128;        // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kPanel = 64 * 128;       // 64 rows x 64 bf16, 128-byte swizzled

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed. A load that never
// lands traps after ~10 s of spinning instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}
// one TMA box (64 columns of D, 1 head, 64 rows of S, 1 batch) -> shared
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins the registers a wgmma reads or writes on this side of the asm fences
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= A B^T, A (64 x 16) and B (64 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, "
      "0, 0;"
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A (64 x 16) bf16 in registers, B (16 x 64) MN-major in shared
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, "
      "%35}, %36, p, 1, 1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, A (64 x 16) bf16 in registers, B (16 x 128) MN-major in shared
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, "
      "%66, %67}, %68, p, 1, 1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// n = DP, the head size padded to whole 64-column panels
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t* a,
                                         uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t* a,
                                             uint64_t b) {
  wgmma_rs_n64(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t* a,
                                              uint64_t b) {
  wgmma_rs_n128(o, a, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, Strides os_,
                             int sq, int sk, int rep, int causal, int window,
                             int q_offset, float scale_log2) {
  constexpr int kPanels = (D + 63) / 64;
  constexpr int kDP = 64 * kPanels;         // D padded to whole panels
  constexpr int kTile = kPanels * kPanel;   // bytes of one 64-row tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q, full, empty
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + kTile, v_s = k_s + kStages * kTile;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest rows first
  const int hq = blockIdx.y, b = blockIdx.z, g = hq / rep;
  // keys any row of this tile can see: [k_lo, k_hi), k_lo on a tile edge
  const int last_q = min(q0 + kBlockQ, sq) - 1 + q_offset;
  const int k_hi = causal ? min(sk, last_q + 1) : sk;
  int k_lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  k_lo = k_lo / kBlockK * kBlockK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kBlockK - 1) / kBlockK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread issues
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, kTile);
      for (int p = 0; p < kPanels; ++p)
        tma_load(q_s + p * kPanel, &tq, bar_q, 64 * p, hq, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * kTile);
        const int kt = k_lo + i * kBlockK;
        for (int p = 0; p < kPanels; ++p) {
          tma_load(k_s + st * kTile + p * kPanel, &tk, bar_full + 8 * st,
                   64 * p, g, kt, b);
          tma_load(v_s + st * kTile + p * kPanel, &tv, bar_full + 8 * st,
                   64 * p, g, kt, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: thread (warp w, lane l) holds rows r0 and r0 + 8
  // of the tile, columns 8j + 2(l % 4) + {0, 1} of each 8-column group j
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + lane / 4;
  const int qa0 = q0 + r0 + q_offset, qa1 = qa0 + 8;  // absolute positions
  const int c0 = 2 * (lane % 4);
  float o[kDP / 2];
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const int kt = k_lo + i * kBlockK;
    mbar_wait(bar_full + 8 * st, (i / kStages) & 1);

    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {  // 16 columns of D a step
      const uint32_t off = (ks / 4) * kPanel + (ks % 4) * 32;
      wgmma_ss_n64(s, desc(q_s + off, 16, 1024),
                   desc(k_s + st * kTile + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool edge = kt + kBlockK > sk ||
                      (causal && kt + kBlockK - 1 > q0 + q_offset) ||
                      (window > 0 && kt <= q0 + kBlockQ - 1 + q_offset - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int kj = kt + 8 * j + c0 + (e & 1);
          const int qa = e < 2 ? qa0 : qa1;
          bool vis = kj < sk;
          if (causal) vis = vis && kj <= qa;
          if (window > 0) vis = vis && kj > qa - window;
          x = vis ? x : kNegInf;
        }
        s[4 * j + e] = x;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the four threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(s[4 * j] - mn0);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - mn0);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - mn1);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - mn1);
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + rs0;  // this thread's columns; summed over the row at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    // S's accumulator fragment, keys 16kk..16kk+15, is P V's A fragment
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[4 * kk + r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 keys (rows of V) a step
      wgmma_pv<kDP>(o, pa + 4 * kk,
                  desc(v_s + st * kTile + kk * 2048, kPanel, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * st);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0, row1 = row0 + 8;
  __nv_bfloat16* ob = out + b * os_.b + hq * os_.h + c0;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os_.s + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * os_.s + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// 4-d tensor map over the (D, heads, S, B) view of a (B, S, heads, D) bf16
// tensor, boxes of 64 x 1 x 64 x 1, 128-byte swizzle, zeros out of bounds.
// `st` holds the (batch, seq, head) element strides; a stride of a size-1
// axis is never used and is replaced by a packed one.
int make_map(CUtensorMap* map, const void* ptr, int b, int s, int heads,
             int d, const long long* st) {
  const long long sh = heads > 1 ? st[2] : d;
  const long long ss = s > 1 ? st[1] : sh * heads;
  const long long sb = b > 1 ? st[0] : ss * s;
  if ((uintptr_t)ptr % 16 || sh % 8 || ss % 8 || sb % 8) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int sk, int h, int kv, const long long* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (make_map(&tq, q, b, sq, h, D, st) || make_map(&tk, k, b, sk, kv, D, st + 3) ||
      make_map(&tv, v, b, sk, kv, D, st + 6))
    return -1;
  constexpr int kSmem = (1 + 2 * kStages) * ((D + 63) / 64) * kPanel + 1024;
  auto kern = flash_attention_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const Strides os_{st[9], st[10], st[11]};
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  kern<<<grid, kThreads, kSmem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, os_, sq, sk, h / kv, causal, window,
      q_offset, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// dtype codes: 0 float32 (the CUDA-core kernel), 2 bfloat16 (the wgmma
// kernel; its TMA maps need q, k, v's base pointers and their batch, seq
// and head strides on 16-byte boundaries); q, k, v and out share the type;
// d is 64, 112 or 128. `strides` holds 12 element strides: (batch, seq, head) of
// q, k, v, out in that order. Returns a cudaError_t code (0 on success), -1
// for arguments the kernels do not take. Launches on the current device, on
// `stream`.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int b,
    int sq, int sk, int h, int kv, int d, const long long* strides, int causal,
    int window, int q_offset, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rep = h / kv;
#define FA_ARGS q, k, v, out, b, sq, sk, h, rep, strides, causal, window, q_offset, scale, s
  if (dtype == 0 && d == 64) return launch<float, 64>(FA_ARGS);
  if (dtype == 0 && d == 112) return launch<float, 112>(FA_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(FA_ARGS);
#undef FA_ARGS
#define WG_ARGS q, k, v, out, b, sq, sk, h, kv, strides, causal, window, q_offset, scale, s
  if (dtype == 2 && d == 64) return wg::launch<64>(WG_ARGS);
  if (dtype == 2 && d == 112) return wg::launch<112>(WG_ARGS);
  if (dtype == 2 && d == 128) return wg::launch<128>(WG_ARGS);
#undef WG_ARGS
  return -1;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
