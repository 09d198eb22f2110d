// Mamba2 SSD scan (forward) for Hopper (sm_90a): the chunked form.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:99 (`_kernel`,
// launched by `_ssd_fwd_impl` through `pl.pallas_call`).
// Plain versions: src/repro_torch/kernels/ref.py::ssd_tiled_ref (this
// kernel's order: chunks of 64, bf16 operand pairs), ::ssd_chunked_ref (the
// TPU kernel's chunked algorithm) and ::ssd_naive_ref (the recurrence).
//
// What it computes: x (B, S, H, P), dt (B, S, H) float32, a_log and d_skip
// (H,) float32, b/c (B, S, N) shared across heads. With a = -exp(a_log):
//   state_t = exp(a * dt_t) * state_{t-1} + (x_t * dt_t) outer b_t
//   y_t     = state_t . c_t + d_skip * x_t
// from a zero state; y in x's type (float32 or bf16), and the final state
// (B, H, P, N) in float32.
//
// Both kernels walk the sequence in chunks of L = 64 positions inside a
// block and carry the block's slice of the state across chunks, as the TPU
// kernel carries it in VMEM scratch. L is this kernel's own, not the
// config's ssm_chunk: the function does not depend on it. Chunk c + 1's
// tiles (x, dt, b, c) load by 16-byte cp.async copies (dt by 4-byte ones)
// into the other slot of a two-slot ring while the block computes chunk c,
// in their own type; b and c, shared by every head, come through L2. Rows
// past S are zero-filled (dt = x = b = c = 0), so a ragged tail adds
// nothing; S < 64 is one partial chunk. One chunk, with cum the inclusive
// sum of a*dt and total = cum[L-1]:
//   G    = C B^T                                         (L x L over N)
//   gate = G * exp(cum_i - cum_j) * dt_j for j <= i, else 0; the exponent is
//          clamped to <= 0 and the mask applied before the product: with the
//          model's a_log = log U(1, 16), cum_i - cum_j for j > i overflows
//   y    = exp(cum_i) (C state) + gate x + d_skip x
//   state <- exp(total) state + B^T (x * dt exp(total - cum))
// cum is summed in float64 by the float32 kernel (a float32 sum loses ulps
// of |cum|, which at chunk 256 costs the plain chunked form about the
// 5e-4 tolerance), in float32 by the bf16 one (far inside bf16's).
//
// bf16: the products on the tensor cores with wgmma (m64n64k16, float32
// accumulators; L = 64 is one warpgroup's M). One block per (64-column
// tile of P, head, batch), three warpgroups on the same chunk at once, one
// block barrier a chunk:
//   - warpgroup 0: G, then C state while it makes the gate from decay
//     tables (G's accumulators are the A fragments of gate x), then gate x;
//     y goes out through a staged tile, by 16-byte stores;
//   - warpgroup 1: owns the (N x 64) state in its accumulators, updates it
//     and hands it to warpgroup 0 through shared memory, double-buffered;
//   - warpgroup 2: loads chunk c + 1's tiles and makes its decay tables as
//     soon as dt lands (see tables()).
// All shared tiles are 128-byte swizzled (the layout wgmma's descriptors
// take; the cp.async copies write it). Rounding per product:
//   - G = C B^T: b and c as they are (bf16, exact): no rounding.
//   - C state: c exact; the float32 state as a pair of bf16 operands,
//     hi = bf16(s) and lo = bf16(s - hi) (two wgmma, ~16 bits).
//   - gate x: x exact; the float32 gate (dt_j folded in) as a hi/lo pair
//     made in registers from G's accumulators.
//   - state update: b exact; x_j * dt_j * exp(total - cum_j) as a hi/lo
//     pair written to shared memory each chunk.
// A single bf16 rounding of the gate, the state or the scaled x puts errors
// of ~2^-9 of the larger terms into y, beyond the 5e-2 tolerance where y is
// near 0 at mamba2-2.7b's width; the pairs keep ~2^-17.
//
// float32: products as float32 FMAs (tensor-core float32 is TF32, ~10 bits:
// beyond the 5e-4 tolerance); one block of four warps per (32-column tile
// of P, head, batch) runs the whole chunk.
//
// Bound: bytes at full width (each input read once: ~4 us for mamba2-2.7b
// at S 512). The bf16 kernel's floor is its tensor-core work, ~3 M MACs a
// chunk and block (the hi/lo pairs double three of its four products), and
// at batch 4 the third wave of its 320 blocks on 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;        // positions per chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 / 4 bytes global -> shared; `bytes` 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
  const void* x;
  const float* dt;
  const float* a_log;
  const void* bm;
  const void* cm;
  const float* d_skip;
  void* y;
  float* state;
  int s_len, h, p_dim, n_dim;
};

// cum = inclusive sum of a * dt over the chunk (float32 products, a float64
// sum), and sc_j = dt_j * exp(total - cum_j), into this warp's own arrays;
// returns total.
__device__ __forceinline__ double chunk_scan(const float* dts, float a,
                                             double* cum, float* sc) {
  const int lane = threadIdx.x & 31;
  const double v0 = a * dts[2 * lane], v1 = a * dts[2 * lane + 1];
  double incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const double c0 = incl - v1;  // the sum through row 2 * lane
  const double total = __shfl_sync(0xffffffffu, incl, 31);
  cum[2 * lane] = c0;
  cum[2 * lane + 1] = incl;
  sc[2 * lane] = dts[2 * lane] * expf((float)(total - c0));
  sc[2 * lane + 1] = dts[2 * lane + 1] * expf((float)(total - incl));
  __syncwarp();
  return total;
}

// exp(cum_i - cum_j) for j <= i; the exponent is clamped to <= 0 so that
// the j > i entries, masked by the caller, never overflow
__device__ __forceinline__ float seg_exp(double ci, double cj) {
  return expf(fminf((float)(ci - cj), 0.f));
}

// ------------------------------- bf16: wgmma --------------------------------
namespace wg {

constexpr int kPT = 64;                  // head-dim columns per block
constexpr int kThreads = 384;            // three warpgroups
constexpr int kPanel = 64 * 128;         // 64 rows x 64 bf16, 128-byte swizzled

// The decay tables of one chunk (floats), made by one warp (see tables()):
constexpr int kTabR = 0;        // R[k][i] = exp(cum_i - cum_end(k)), i past block k
constexpr int kTabQ = 256;      // Q[j] = exp(cum_end(block of j) - cum_j) dt_j
constexpr int kTabSc = 320;     // sc[j] = dt_j exp(total - cum_j)
constexpr int kTabE = 384;      // E[i] = exp(cum_i)
constexpr int kTabDecay = 448;  // exp(total)
constexpr int kTabD = 512;      // D[k][ii][jj] = exp(cum_i - cum_j) dt_j, j <= i
constexpr int kTabFloats = kTabD + 4 * 16 * 16;

// Shared memory, every panel on a 1024-byte boundary. NPAN = panels of the
// state dim (N padded with zeros to 64 or 128).
template <int NPAN>
struct Lay {
  static constexpr int kC = 0;                       // c tile [i][n], NPAN panels
  static constexpr int kB = kC + NPAN * kPanel;      // b tile [j][n]
  static constexpr int kX = kB + NPAN * kPanel;      // x tile [j][p]
  static constexpr int kDt = kX + kPanel;            // dt [64] float32
  static constexpr int kSlot = kDt + 1024;
  static constexpr int kXs = 2 * kSlot;              // x * sc, hi and lo panels
  static constexpr int kS = kXs + 2 * kPanel;        // state [n][p]: 2 buffers x (hi, lo)
  static constexpr int kSBuf = 2 * NPAN * kPanel;    //   one buffer: hi then lo
  static constexpr int kTab = kS + 2 * kSBuf;        // decay tables: 2 buffers
  static constexpr int kY = kTab + 2 * kTabFloats * 4;   // y tile [i][p], staged
  static constexpr int kBytes = kY + kPanel;
};

// byte offset of the 16-byte chunk q of row r in a 128-byte swizzled panel
__device__ __forceinline__ uint32_t swz(int r, int q) {
  return r * 128 + ((q ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}
// K-major operand (rows of the tile along M or N, K contiguous): k-step ks
__device__ __forceinline__ uint64_t kmaj(uint32_t tile, int ks) {
  return desc(tile + (ks / 4) * kPanel + (ks % 4) * 32, 16, 1024);
}
// MN-major operand (rows of the tile along K, 64 M or N values a row): the
// 16 rows of k-step ks
__device__ __forceinline__ uint64_t mnmaj(uint32_t tile, int ks) {
  return desc(tile + ks * 2048, kPanel, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins the registers a wgmma reads or writes on this side of the asm fences
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void bar_wg0() {   // each warpgroup's own barrier
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
__device__ __forceinline__ void bar_wg1() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}
__device__ __forceinline__ void bar_wg2() {
  asm volatile("bar.sync 3, 128;\n" ::: "memory");
}

#define WG_D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define WG_D32_OUT(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])

// d (+)= A B, m64n64k16, both operands in shared memory; TA / TB: the
// descriptor's transpose bits (0 K-major, 1 MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_D32_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}
// d (+)= A B, m64n64k16, A (64 x 16) in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
#undef WG_D32
#undef WG_D32_OUT

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// (v0, v1) float32 -> the hi and lo bf16 operand pairs
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&r);
  return make_float2(__low2float(v), __high2float(v));
}

// Chunk c's tiles into the ring slot at `slot` (a shared address), 128-byte
// swizzled, by warpgroup 2 (thread tid of it); rows past S and columns past
// N or P read nothing and are zero. dt goes first, in a cp.async group of
// its own, so that the decay tables can start before the tiles land.
template <int NPAN>
__device__ __forceinline__ void load_chunk(uint32_t slot, const Args& a, int c,
                                           int b, int hh, int p0, int tid) {
  using Ly = Lay<NPAN>;
  const int t0 = c * kL;
  const long long row0 = (long long)b * a.s_len + t0;   // the chunk's first row
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x) +
                           (row0 * a.h + hh) * a.p_dim + p0;
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(a.bm) + row0 * a.n_dim;
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(a.cm) + row0 * a.n_dim;
  const int hp = a.h * a.p_dim, rows = a.s_len - t0;
  if (tid < kL) {                             // dt
    const bool ok = tid < rows;
    cp_async4(slot + Ly::kDt + 4 * tid, a.dt + (ok ? (row0 + tid) * a.h + hh : 0),
              ok ? 4 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < kL * 8 / 128; ++k) {   // x: 8 chunks a row
    const int i = tid + k * 128, r = i >> 3, q = i & 7;
    const bool ok = r < rows && p0 + 8 * q < a.p_dim;
    cp_async16(slot + Ly::kX + swz(r, q), x + (ok ? r * hp + 8 * q : 0), ok ? 16 : 0);
  }
#pragma unroll
  for (int k = 0; k < kL * 8 * NPAN / 128; ++k) {  // b, c
    const int i = tid + k * 128, r = i / (8 * NPAN), q = i % (8 * NPAN);
    const bool ok = r < rows && 8 * q < a.n_dim;
    const int off = ok ? r * a.n_dim + 8 * q : 0;
    const uint32_t dst = (q >> 3) * kPanel + swz(r, q & 7);
    cp_async16(slot + Ly::kB + dst, bm + off, ok ? 16 : 0);
    cp_async16(slot + Ly::kC + dst, cm + off, ok ? 16 : 0);
  }
  cp_async_commit();
}

// The decay tables of a chunk from its dt, made by the four warps of
// warpgroup 2 (warp w1 of it; lane l holds rows 2l and 2l + 1; every warp
// runs the scan, then makes its share). cum, the inclusive sum of a * dt, is
// summed in float32 here: its rounding (a few ulps of |cum|) is far inside
// bf16's tolerance. The
// gate of a key j in an earlier 16-row block k than row i factors as
// R[k][i] * Q[j] (both exponents <= 0: no overflow, and an underflow of
// either means the product underflows too); keys of the row's own block
// take D, whose exponent is clamped to <= 0 and whose j > i entries are 0
// (exp(cum_i - cum_j) for j > i overflows at the model's decay rates, so
// it is never taken).
__device__ __forceinline__ void tables(const float* dts, float a, float* tb,
                                       int w1) {
  const int lane = threadIdx.x & 31;
  // every load before the first store: the compiler keeps shared-memory
  // loads and stores through one pointer in program order
  const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
  const float djj = dts[16 * w1 + (lane & 15)];
  const float v0 = a * d0, v1 = a * d1;
  float incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float c0 = incl - v1, c1 = incl;     // cum of rows 2l and 2l + 1
  const float total = __shfl_sync(0xffffffffu, incl, 31);
  const float ce = __shfl_sync(0xffffffffu, incl, (lane >> 3) * 8 + 7);  // its block's end
  const float cw = __shfl_sync(0xffffffffu, incl, 8 * w1 + 7);          // block w1's end
  // D of block w1: lane l makes entries 32 r + l (row 2 r + l / 16, key
  // column l % 16), so that each store covers 32 consecutive words
  const int jj = lane & 15, odd = lane >> 4;
  const float cj0 = __shfl_sync(0xffffffffu, c0, 8 * w1 + jj / 2);
  const float cj1 = __shfl_sync(0xffffffffu, c1, 8 * w1 + jj / 2);
  const float cj = (jj & 1) ? cj1 : cj0;
  float dv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float ci0 = __shfl_sync(0xffffffffu, c0, 8 * w1 + r);
    const float ci1 = __shfl_sync(0xffffffffu, c1, 8 * w1 + r);
    const int ii = 2 * r + odd;
    dv[r] = jj <= ii ? __expf(fminf((odd ? ci1 : ci0) - cj, 0.f)) * djj : 0.f;
  }
  const float2 rv = make_float2(__expf(fminf(c0 - cw, 0.f)), __expf(fminf(c1 - cw, 0.f)));
  reinterpret_cast<float2*>(tb + kTabR + 64 * w1)[lane] = rv;
  if (w1 == 0) {
    reinterpret_cast<float2*>(tb + kTabQ)[lane] =
        make_float2(__expf(ce - c0) * d0, __expf(ce - c1) * d1);
    reinterpret_cast<float2*>(tb + kTabSc)[lane] =
        make_float2(d0 * __expf(total - c0), d1 * __expf(total - c1));
    reinterpret_cast<float2*>(tb + kTabE)[lane] = make_float2(__expf(c0), __expf(c1));
    if (lane == 0) tb[kTabDecay] = __expf(total);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) tb[kTabD + 256 * w1 + 32 * r + lane] = dv[r];
}

// Warpgroup 2's share of a chunk: load chunk c into its slot, and make its
// decay tables as soon as dt has landed; on return the tiles have landed
// too and are visible to wgmma after the next block barrier.
template <int NPAN>
__device__ __forceinline__ void produce(uint32_t base, unsigned char* gbase,
                                        float* tabs, const Args& a, int c,
                                        int b, int hh, int p0, float av) {
  using Ly = Lay<NPAN>;
  const int tid = threadIdx.x - 256, w2 = tid >> 5;
  load_chunk<NPAN>(base + (c & 1) * Ly::kSlot, a, c, b, hh, p0, tid);
  cp_async_wait<1>();          // this thread's dt copy (the older group)
  bar_wg2();                   // ... and every thread's
  tables(reinterpret_cast<const float*>(gbase + (c & 1) * Ly::kSlot + Ly::kDt), av,
         tabs + (c & 1) * kTabFloats, w2);
  cp_async_wait<0>();
  fence_async_smem();
}

// Accumulator fragment of m64n64: thread (warp w of its warpgroup, lane
// gr * 4 + t4) holds d[4 j + e] = row 16 w + gr + 8 (e >> 1), column
// 8 j + 2 t4 + (e & 1), for j = 0..7.
template <int NPAN>
__global__ void __launch_bounds__(kThreads, 1)
ssd_wgmma_kernel(Args a) {
  using Ly = Lay<NPAN>;
  constexpr int kK = 4 * NPAN;               // k-steps over the state dim
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warpgroup index, shown warp-uniform to the compiler (a branch it
  // cannot prove uniform makes ptxas serialize the wgmma inside it)
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int w = warp & 3;                     // warp within its warpgroup
  const int gr = lane >> 2, t4 = lane & 3;
  float* tabs = reinterpret_cast<float*>(gbase + Ly::kTab);  // [2][kTabFloats]
  const int p0 = blockIdx.x * kPT, hh = blockIdx.y, b = blockIdx.z;
  const float av = -expf(a.a_log[hh]), dsk = a.d_skip[hh];
  const int nchunks = (a.s_len + kL - 1) / kL;

  if (wgi == 2 && nchunks > 0)                // chunk 0's tiles and tables
    produce<NPAN>(base, gbase, tabs, a, 0, b, hh, p0, av);
  // the zero state, both buffers (warpgroup 0 reads buffer 0 at chunk 0)
  for (int i = threadIdx.x; i < 2 * Ly::kSBuf / 16; i += kThreads)
    reinterpret_cast<uint4*>(gbase + Ly::kS)[i] = make_uint4(0, 0, 0, 0);

  float st[NPAN][32];                        // warpgroup 1: the state rows n
#pragma unroll
  for (int m = 0; m < NPAN; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) st[m][i] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    fence_async_smem();        // this thread's state writes -> wgmma
    __syncthreads();           // chunk c landed; every warpgroup past chunk c-1
    const uint32_t slot = base + (c & 1) * Ly::kSlot;
    const unsigned char* gslot = gbase + (c & 1) * Ly::kSlot;
    const float* tb = tabs + (c & 1) * kTabFloats;
    const int rows = min(kL, a.s_len - c * kL);
    const uint32_t s_cur = base + Ly::kS + (c & 1) * Ly::kSBuf;   // after c-1

    if (wgi == 0) {
      // ---- warpgroup 0: G = C B^T, then C state while the gate is made,
      // then gate x into its own accumulators while C state may still run
      float g[32], y[32];   // the first wgmma of each overwrites it
      fence_regs(g);
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kK; ++ks)
        wgmma_ss<0, 0>(g, kmaj(slot + Ly::kC, ks), kmaj(slot + Ly::kB, ks), ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < kK; ++ks) {
        wgmma_ss<0, 1>(y, kmaj(slot + Ly::kC, ks), mnmaj(s_cur, ks), ks > 0);
        wgmma_ss<0, 1>(y, kmaj(slot + Ly::kC, ks),
                       mnmaj(s_cur + NPAN * kPanel, ks), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();         // G is done; C state may still run
      fence_regs(g);
      // the gate from the tables: rows i0, i1 lie in block w; key block
      // k < w is R[k][i] Q[j], block w is D[w], later blocks are 0
      const int i0 = 16 * w + gr, i1 = i0 + 8;
      uint32_t ph[16], pl[16];  // the gate's A fragments, hi and lo
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = j >> 1, jj = 8 * j + 2 * t4;
        float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
        if (k < w) {
          const float r0 = tb[kTabR + 64 * k + i0], r1 = tb[kTabR + 64 * k + i1];
          const float q0 = tb[kTabQ + jj], q1 = tb[kTabQ + jj + 1];
          v00 = g[4 * j] * r0 * q0;
          v01 = g[4 * j + 1] * r0 * q1;
          v10 = g[4 * j + 2] * r1 * q0;
          v11 = g[4 * j + 3] * r1 * q1;
        } else if (k == w) {
          const float* dk = tb + kTabD + 256 * w + 16 * gr + (jj - 16 * w);
          v00 = g[4 * j] * dk[0];
          v01 = g[4 * j + 1] * dk[1];
          v10 = g[4 * j + 2] * dk[128];
          v11 = g[4 * j + 3] * dk[129];
        }
        // columns 8j.. of key block j / 2: A register 2 (j % 2) + {0, 1}
        split2(v00, v01, ph[4 * (j >> 1) + 2 * (j & 1)], pl[4 * (j >> 1) + 2 * (j & 1)]);
        split2(v10, v11, ph[4 * (j >> 1) + 2 * (j & 1) + 1],
               pl[4 * (j >> 1) + 2 * (j & 1) + 1]);
      }
      wgmma_wait<0>();
      fence_regs(y);
      const float e0 = tb[kTabE + i0], e1 = tb[kTabE + i1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[4 * j] *= e0; y[4 * j + 1] *= e0; y[4 * j + 2] *= e1; y[4 * j + 3] *= e1;
      }
      // gate x: hi and lo A fragments against x's tile (MN-major)
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(y, ph + 4 * kk, mnmaj(slot + Ly::kX, kk), 1);
        wgmma_rs(y, pl + 4 * kk, mnmaj(slot + Ly::kX, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      // y + d_skip x into the staged tile, then 16-byte stores of the rows
      // < S and columns < P
      uint32_t xw[2][8];                       // loads first (see tables())
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xw[hr][j] = *reinterpret_cast<const uint32_t*>(
              gslot + Ly::kX + swz(hr ? i1 : i0, j) + 4 * t4);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 xv = unpack_bf16(xw[hr][j]);
          *reinterpret_cast<uint32_t*>(gbase + Ly::kY + swz(hr ? i1 : i0, j) + 4 * t4) =
              pack_bf16(y[4 * j + 2 * hr] + dsk * xv.x, y[4 * j + 2 * hr + 1] + dsk * xv.y);
        }
      }
      bar_wg0();
      __nv_bfloat16* yo = static_cast<__nv_bfloat16*>(a.y) +
                          (((long long)b * a.s_len + c * kL) * a.h + hh) * a.p_dim + p0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = threadIdx.x + 128 * k, r = i >> 3, q = i & 7;
        if (r < rows && p0 + 8 * q < a.p_dim)
          *reinterpret_cast<uint4*>(yo + (long long)r * a.h * a.p_dim + 8 * q) =
              *reinterpret_cast<const uint4*>(gbase + Ly::kY + swz(r, q));
      }
    } else if (wgi == 1) {
      // ---- warpgroup 1: x * sc as hi/lo panels, then the state update
      const int t = threadIdx.x - 128, r = t >> 1;   // row r, chunks 4 (t % 2) ..
      uint4 xv[4];                             // loads first (see tables())
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xv[u] = *reinterpret_cast<const uint4*>(gslot + Ly::kX + swz(r, 4 * (t & 1) + u));
      const float s = tb[kTabSc + r];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = 4 * (t & 1) + u;
        uint32_t hv[4], lv[4];
        const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[u]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = unpack_bf16(xw[k]);
          split2(f.x * s, f.y * s, hv[k], lv[k]);
        }
        *reinterpret_cast<uint4*>(gbase + Ly::kXs + swz(r, q)) =
            make_uint4(hv[0], hv[1], hv[2], hv[3]);
        *reinterpret_cast<uint4*>(gbase + Ly::kXs + kPanel + swz(r, q)) =
            make_uint4(lv[0], lv[1], lv[2], lv[3]);
      }
      fence_async_smem();
      bar_wg1();
      const float decay = tb[kTabDecay];
#pragma unroll
      for (int m = 0; m < NPAN; ++m)
#pragma unroll
        for (int i = 0; i < 32; ++i) st[m][i] *= decay;
#pragma unroll
      for (int m = 0; m < NPAN; ++m) fence_regs(st[m]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < NPAN; ++m) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {   // rows past S are zero
          // A[n][j] = b[j][n]: b's tile read MN-major (transposed)
          const uint64_t bt = mnmaj(slot + Ly::kB + m * kPanel, kk);
          wgmma_ss<1, 1>(st[m], bt, mnmaj(base + Ly::kXs, kk), 1);
          wgmma_ss<1, 1>(st[m], bt, mnmaj(base + Ly::kXs + kPanel, kk), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < NPAN; ++m) fence_regs(st[m]);
      // the new state, hi and lo, for chunk c + 1: rows n, columns p
      const uint32_t s_next = Ly::kS + ((c + 1) & 1) * Ly::kSBuf;
#pragma unroll
      for (int m = 0; m < NPAN; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int n = 16 * w + gr + 8 * hr;   // row within panel m
            uint32_t hv, lv;
            split2(st[m][4 * j + 2 * hr], st[m][4 * j + 2 * hr + 1], hv, lv);
            const uint32_t o = m * kPanel + swz(n, j) + 4 * t4;
            *reinterpret_cast<uint32_t*>(gbase + s_next + o) = hv;
            *reinterpret_cast<uint32_t*>(gbase + s_next + NPAN * kPanel + o) = lv;
          }
    } else if (c + 1 < nchunks) {
      // ---- warpgroup 2: chunk c + 1's tiles and tables
      produce<NPAN>(base, gbase, tabs, a, c + 1, b, hh, p0, av);
    }
  }

  if (wgi == 1) {              // the final state, (B, H, P, N) float32
#pragma unroll
    for (int m = 0; m < NPAN; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * m + 16 * w + gr + 8 * (e >> 1);
          const int p = p0 + 8 * j + 2 * t4 + (e & 1);
          if (n < a.n_dim && p < a.p_dim)
            a.state[(((long long)b * a.h + hh) * a.p_dim + p) * a.n_dim + n] =
                st[m][4 * j + e];
        }
  }
}

}  // namespace wg

// ------------------------------ float32: FMAs -------------------------------
constexpr int kPT = 32;       // head-dim columns per block
constexpr int kFmaThreads = 128;

// Shared-memory layout of the float32 kernel. Tiles are row-major with
// padded rows (a 16-byte multiple; 8 consecutive rows of a 16-byte column
// chunk land in distinct banks).
template <int NP>
struct FmaLayout {
  static constexpr int kWarps = kFmaThreads / 32;
  static constexpr int kThreads = kFmaThreads;
  static constexpr int kXld = kPT + 4;           // x tile row
  static constexpr int kNld = NP + 4;            // b / c tile row
  static constexpr int kX = kL * kXld * 4;
  static constexpr int kBC = kL * kNld * 4;
  static constexpr int kSlot = kX + 2 * kBC + kL * 4;   // x, b, c, dt
  static constexpr int kScan = kWarps * kL * (8 + 4);   // cum (double), sc
  // the gate [kL][kL + 1] and the state [NP][kXld]
  static constexpr int kState = kL * (kL + 1) * 4 + NP * kXld * 4;
  static constexpr int kBytes = 2 * kSlot + kScan + kState;
};

// Chunk c's tiles into ring slot `slot` (x, b, c, dt), rows past S zero.
template <int NP>
__device__ __forceinline__ void load_chunk_f32(unsigned char* slot, const Args& a,
                                               int c, int b, int hh, int p0) {
  using Ly = FmaLayout<NP>;
  float* xs = reinterpret_cast<float*>(slot);
  float* bs = reinterpret_cast<float*>(slot + Ly::kX);
  float* cs = reinterpret_cast<float*>(slot + Ly::kX + Ly::kBC);
  float* dts = reinterpret_cast<float*>(slot + Ly::kX + 2 * Ly::kBC);
  const float* x = static_cast<const float*>(a.x);
  const float* bm = static_cast<const float*>(a.bm);
  const float* cm = static_cast<const float*>(a.cm);
  const int t0 = c * kL;
  constexpr int kXc = kPT / 4, kNc = NP / 4;     // 16-byte chunks per row
  for (int i = threadIdx.x; i < kL * kXc; i += kFmaThreads) {
    const int r = i / kXc, col = (i % kXc) * 4;
    const bool ok = t0 + r < a.s_len && p0 + col < a.p_dim;
    const long long off = ok ? (((long long)b * a.s_len + t0 + r) * a.h + hh)
                                   * a.p_dim + p0 + col : 0;
    cp_async16(smem_u32(xs + r * Ly::kXld + col), x + off, ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < kL * kNc; i += kFmaThreads) {
    const int r = i / kNc, col = (i % kNc) * 4;
    const bool ok = t0 + r < a.s_len && col < a.n_dim;
    const long long off = ok ? ((long long)b * a.s_len + t0 + r) * a.n_dim + col : 0;
    cp_async16(smem_u32(bs + r * Ly::kNld + col), bm + off, ok ? 16 : 0);
    cp_async16(smem_u32(cs + r * Ly::kNld + col), cm + off, ok ? 16 : 0);
  }
  for (int r = threadIdx.x; r < kL; r += kFmaThreads) {
    const bool ok = t0 + r < a.s_len;
    const long long off = ok ? ((long long)b * a.s_len + t0 + r) * a.h + hh : 0;
    cp_async4(smem_u32(dts + r), a.dt + off, ok ? 4 : 0);
  }
}

// Thread (ty = tid / 8, tx = tid % 8) owns rows ty + 16 r of the gate and of
// y (columns tx + 8 q of the gate, 4 tx .. 4 tx + 3 of y) and state rows
// ty + 16 r (columns 4 tx .. 4 tx + 3).
template <int NP>
__global__ void __launch_bounds__(FmaLayout<NP>::kThreads)
ssd_fma_kernel(Args a) {
  using Ly = FmaLayout<NP>;
  constexpr int kXld = Ly::kXld, kNld = Ly::kNld;
  constexpr int kG = kL + 1;                 // gate row
  constexpr int kSR = NP / 16;               // state rows a thread
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem + 2 * Ly::kSlot) + (threadIdx.x >> 5) * kL;
  float* sc = reinterpret_cast<float*>(smem + 2 * Ly::kSlot + Ly::kWarps * kL * 8) +
              (threadIdx.x >> 5) * kL;               // this warp's own
  float* gs = reinterpret_cast<float*>(smem + 2 * Ly::kSlot + Ly::kScan);  // [kL][kG]
  float* ss = gs + kL * kG;                  // the state [NP][kXld]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int p0 = blockIdx.x * kPT, hh = blockIdx.y, b = blockIdx.z;
  const float av = -expf(a.a_log[hh]), dsk = a.d_skip[hh];
  const int nchunks = (a.s_len + kL - 1) / kL;

  if (nchunks > 0) load_chunk_f32<NP>(smem, a, 0, b, hh, p0);
  cp_async_commit();
  for (int i = tid; i < NP * kXld; i += Ly::kThreads) ss[i] = 0.f;
  float st[kSR][4];
#pragma unroll
  for (int r = 0; r < kSR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[r][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < nchunks)
      load_chunk_f32<NP>(smem + ((c + 1) & 1) * Ly::kSlot, a, c + 1, b, hh, p0);
    cp_async_commit();
    unsigned char* slot = smem + (c & 1) * Ly::kSlot;
    const float* xs = reinterpret_cast<const float*>(slot);
    const float* bs = reinterpret_cast<const float*>(slot + Ly::kX);
    const float* cs = reinterpret_cast<const float*>(slot + Ly::kX + Ly::kBC);
    const float* dts = reinterpret_cast<const float*>(slot + Ly::kX + 2 * Ly::kBC);
    const int rows = min(kL, a.s_len - c * kL);
    const double total = chunk_scan(dts, av, cum, sc);

    // gate[i][j] = (c_i . b_j) exp(cum_i - cum_j) dt_j, j <= i
    {
      float g[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) g[r][q] = 0.f;
#pragma unroll 2
      for (int k = 0; k < NP; k += 4) {
        float4 cv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(cs + (ty + 16 * r) * kNld + k);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          bv[q] = *reinterpret_cast<const float4*>(bs + (tx + 8 * q) * kNld + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            g[r][q] += cv[r].x * bv[q].x + cv[r].y * bv[q].y +
                       cv[r].z * bv[q].z + cv[r].w * bv[q].w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = tx + 8 * q;
          gs[i * kG + j] = j <= i ? g[r][q] * seg_exp(cum[i], cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();            // the gate is whole

    // y = exp(cum_i) (C state) + gate x + d_skip x
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
#pragma unroll 4
      for (int n = 0; n < NP; ++n) {
        const float4 sv = *reinterpret_cast<const float4*>(ss + n * kXld + 4 * tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = cs[(ty + 16 * r) * kNld + n];
          acc[r][0] += cv * sv.x; acc[r][1] += cv * sv.y;
          acc[r][2] += cv * sv.z; acc[r][3] += cv * sv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf((float)cum[ty + 16 * r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }
      for (int j = 0; j < rows; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * kXld + 4 * tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float gv = gs[(ty + 16 * r) * kG + j];
          acc[r][0] += gv * xv.x; acc[r][1] += gv * xv.y;
          acc[r][2] += gv * xv.z; acc[r][3] += gv * xv.w;
        }
      }
      float* y = static_cast<float*>(a.y);
      if (p0 + 4 * tx < a.p_dim) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r;
          if (i >= rows) continue;
          const float4 xv = *reinterpret_cast<const float4*>(xs + i * kXld + 4 * tx);
          const long long off = (((long long)b * a.s_len + c * kL + i) * a.h + hh)
                                * a.p_dim + p0 + 4 * tx;
          *reinterpret_cast<float4*>(y + off) = make_float4(
              acc[r][0] + dsk * xv.x, acc[r][1] + dsk * xv.y,
              acc[r][2] + dsk * xv.z, acc[r][3] + dsk * xv.w);
        }
      }
    }

    // state <- exp(total) state + (B * sc)^T x
    const float decay = expf((float)total);
#pragma unroll
    for (int r = 0; r < kSR; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[r][e] *= decay;
    for (int j = 0; j < rows; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * kXld + 4 * tx);
      const float s = sc[j];
#pragma unroll
      for (int r = 0; r < kSR; ++r) {
        const float bv = bs[j * kNld + ty + 16 * r] * s;
        st[r][0] += bv * xv.x; st[r][1] += bv * xv.y;
        st[r][2] += bv * xv.z; st[r][3] += bv * xv.w;
      }
    }
    __syncthreads();            // every thread has read the old state
#pragma unroll
    for (int r = 0; r < kSR; ++r)
      *reinterpret_cast<float4*>(ss + (ty + 16 * r) * kXld + 4 * tx) =
          make_float4(st[r][0], st[r][1], st[r][2], st[r][3]);
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < kSR; ++r) {
    const int n = ty + 16 * r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 4 * tx + e;
      if (n < a.n_dim && p < a.p_dim)
        a.state[(((long long)b * a.h + hh) * a.p_dim + p) * a.n_dim + n] = st[r][e];
    }
  }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, int threads, int bytes,
                  const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_f32(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid((a.p_dim + kPT - 1) / kPT, a.h, b);
  return launch_kernel(ssd_fma_kernel<NP>, grid, kFmaThreads,
                       FmaLayout<NP>::kBytes, a, stream);
}

template <int NPAN>
int launch_bf16(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid((a.p_dim + wg::kPT - 1) / wg::kPT, a.h, b);
  return launch_kernel(wg::ssd_wgmma_kernel<NPAN>, grid, wg::kThreads,
                       wg::Lay<NPAN>::kBytes + 1024, a, stream);
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16 (x, b, c and y share it; dt, a_log,
// d_skip and the state are float32). All tensors contiguous with 16-byte
// aligned bases. Returns a cudaError_t code (0 on success), -1 for shapes
// the kernel does not take (N > 128, N or P not a multiple of 8, an empty
// grid). Launches on the current device, on `stream`.
extern "C" int ssd_scan_launch(int dtype, const void* x, const float* dt,
                               const float* a_log, const void* bm,
                               const void* cm, const float* d_skip, void* y,
                               float* state, int b, int s_len, int h,
                               int p_dim, int n_dim, void* stream) {
  if ((dtype != 0 && dtype != 2) || n_dim < 1 || n_dim > 128 || n_dim % 8 ||
      p_dim < 1 || p_dim % 8 || b < 1 || h < 1 || s_len < 0)
    return -1;
  const Args a{x, dt, a_log, bm, cm, d_skip, y, state, s_len, h, p_dim, n_dim};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 2) return n_dim <= 64 ? launch_bf16<1>(a, b, s) : launch_bf16<2>(a, b, s);
  if (n_dim <= 16) return launch_f32<16>(a, b, s);
  if (n_dim <= 32) return launch_f32<32>(a, b, s);
  if (n_dim <= 64) return launch_f32<64>(a, b, s);
  return launch_f32<128>(a, b, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
