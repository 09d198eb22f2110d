// Fused (B, N) eq. 11 routing-score matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/route_score.py
// (`_kernel`, launched by `route_score` through `pl.pallas_call`).
// Plain version: src/repro_torch/kernels/ref.py::route_score_ref.
//
// What it computes, per request b and server n:
//   score = prompt/uplink                                   (eq. 5)
//         + [size/backhaul, 0 where resident[n, model[b]]]  (eq. 7, gated)
//         + (queue*flops_tok + work)/flops                  (eq. 9)
//   plus the spill surcharge prompt/backhaul on neighbour-cell pairs and
//   +inf on every pair the request cannot see (other cell, not cloud,
//   not spilled). Absent pieces (no size column, no queue, no residency,
//   no cells, no spill) are null pointers and drop their term exactly as
//   the plain version does. The eq. 16 knobs fold in as the plain
//   version's costs.apply_eta_beta does: prompt*eta and work*eta (one
//   multiply each, rounded to the columns' type), and beta False makes
//   size +inf before the residency gate.
//
// What bounds it on the H100. Each of the B*N outputs is written once and
// the inputs are only B + N scalars, so at a large panel such as
// (65536, 64) the bound is the output write over HBM (16.8 MB in float32:
// 5.0 us at 3.35 TB/s). A kernel with one thread an output, a full IEEE
// divide per term and one 4-byte store is bound there by its instruction
// stream instead: it writes a bf16 panel no faster than a float32 one. At
// the main path's (256, 64), once per chunk, the launch and one round trip
// to memory are all there is. What the design does about it:
//   * The host plans a 1-D grid (route_score.py:plan), so no row count is
//     too large for it, and picks one of two paths.
//   * Panels (a strip of more rows than a block has row groups): a thread
//     owns V consecutive servers of a row, V = 16 / sizeof(out) (4
//     float32, 2 float64, 8 bf16), and writes them as one 16-byte vector
//     when every row starts 16-byte aligned (N % V == 0), else one by one.
//     A block is tx column groups x ty rows over a tile of tx*V servers
//     and a strip of rows; the grid (column tiles x strips) is two blocks
//     an SM, the most the 128 registers a thread allow. The tile's servers
//     are read once per block into shared memory, each with the
//     reciprocals of its divisors (uplink, flops, backhaul), its K
//     residency bytes packed into one 32-bit mask (K <= 32; a byte read
//     per score above that) and the (C, C) spill adjacency packed into
//     one 64-bit mask row per request cell, its own cell's bit cleared
//     (C <= 63; a byte read per score above that). Each thread keeps its
//     V servers in registers. Rows go through shared memory a chunk at a
//     time, one a thread, read and derived once (eta, beta, the model's
//     clamp, the range checks below); a thread issues its row's loads
//     before the column work, so the two latencies overlap.
//   * Everything smaller (the router's (256, 64) chunks): one score a
//     thread over the B*N outputs in row-major order, so the grid holds as
//     many threads as scores; no staging and no barrier; each thread reads
//     its row and its server itself and divides with the IEEE divide, since
//     a reciprocal pays only when rows share it. One round trip to memory
//     before the score. (V servers a thread here left (256, 64) 16 blocks
//     in float32 and 8 in bf16, each thread dividing V times in sequence:
//     slower than one score a thread.) On a (65536, 64) float32 panel this
//     path takes 54.5 us against the staged path's 8.4 us (H100 80GB HBM3,
//     700 W, chip_smoke.py `panel-direct`): it runs at the staged path's
//     register count, 16 warps an SM, each score latency-bound.
//   * The divides in the panels. Each quotient a/b must be the correctly
//     rounded one (the plain version divides with IEEE `/`). With y =
//     RN(1/b) from the column, q = RN(a*y), r = fma(-b, q, a) (exact) and
//     RN(q + r*y) = RN(a/b) (Markstein's theorem: y correctly rounded, q
//     faithful, the remainder exact). That holds while no step leaves the
//     normal range: the divisor's exponent in [-63, 63] (float32;
//     [-511, 511] in float64), the dividend's in [-36, 63] ([-400, 511])
//     or the dividend +0; then the quotient's exponent lies in
//     [-100, 126], the remainder is exact and r*y is normal. The eq. 9
//     backlog queue*flops_tok + work is a dividend of that range when
//     work (exponent [-36, 60]), flops_tok ([-18, 39]) and queue
//     ([-18, 19]) are each +0 or in theirs, so that is checked per row
//     and per server, not per score. Where a row's or a thread's servers'
//     operands leave those ranges (zeros of either sign as divisors,
//     infinities, NaNs, subnormals, negatives, quotients near overflow or
//     underflow) that row's V scores take the IEEE divide (__fdiv_rn /
//     __ddiv_rn) one server at a time. An infinite size (beta False) over
//     a positive divisor in range is +inf without a divide. Held bit for
//     bit on the card by the `divide-stress` cases of
//     tests/test_torch_kernels_cuda.py (operands over the whole exponent
//     range, quotients within an ulp of a rounding midpoint).

// Rounding: every add, multiply and fma is an explicit round-to-nearest
// intrinsic and the build passes --fmad=false, so nothing is contracted.
// The terms group exactly as in the plain version: (t_trans + t_switch) +
// t_comp, queue*flops_tok + work, the spill surcharge added last. So the
// float32 and float64 output is bitwise equal to it; bf16 columns are read
// as they are, the math runs in float32 and the result is rounded to bf16
// once, as the plain version does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads a block at most (tx * ty)
constexpr int kMaxTx = 32;       // column groups a tile at most
constexpr int kMaxCells = 63;    // spill as mask rows up to 63 cells
constexpr int kNoCell = 63;      // bit index of a server outside [0, C)

template <typename T> struct Arith;

template <> struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
  // biased exponent with the sign bit above it: negatives fall out of range
  static __device__ __forceinline__ uint32_t expo(float a) { return __float_as_uint(a) >> 23; }
  static __device__ __forceinline__ bool zero(float a) { return __float_as_uint(a) == 0u; }
  static constexpr uint32_t kBias = 127;
};

template <> struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }
  static __device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
  static __device__ __forceinline__ uint32_t expo(double a) {
    return (uint32_t)((unsigned long long)__double_as_longlong(a) >> 52);
  }
  static __device__ __forceinline__ bool zero(double a) { return __double_as_longlong(a) == 0LL; }
  static constexpr uint32_t kBias = 1023;
};

// Exponent ranges (unbiased) of the reciprocal divide's operands (see the
// note): a divisor, a dividend, and the three parts of the eq. 9 backlog
// queue*flops_tok + work, which keep the backlog a dividend in range.
template <typename T> struct Range;
template <> struct Range<float> {
  static constexpr int kDiv = 63, kNumLo = -36, kNumHi = 63;
};
template <> struct Range<double> {
  static constexpr int kDiv = 511, kNumLo = -400, kNumHi = 511;
};
constexpr int kWorkLo = -36, kWorkHi = 60, kFtokLo = -18, kFtokHi = 39;
constexpr int kQueueLo = -18, kQueueHi = 19;

// x positive, normal, with its exponent in [lo, hi]; or +0 where allowed
template <typename T> __device__ __forceinline__ bool in_range(T x, int lo, int hi, bool zero_ok) {
  typedef Arith<T> A;
  return A::expo(x) - (uint32_t)(A::kBias + lo) <= (uint32_t)(hi - lo) || (zero_ok && A::zero(x));
}
template <typename T> __device__ __forceinline__ bool divisor_ok(T b) {
  return in_range(b, -Range<T>::kDiv, Range<T>::kDiv, false);
}
template <typename T> __device__ __forceinline__ bool dividend_ok(T a) {
  return in_range(a, Range<T>::kNumLo, Range<T>::kNumHi, true);
}

// a/b from y = RN(1/b): correctly rounded inside the ranges above.
template <typename T> __device__ __forceinline__ T rdiv(T a, T b, T y) {
  typedef Arith<T> A;
  const T q = A::mul(a, y);
  const T r = A::fma(-b, q, a);
  return A::fma(r, y, q);
}

template <typename T> __device__ __forceinline__ T load(const float* p, long long i) { return (T)p[i]; }
template <typename T> __device__ __forceinline__ T load(const double* p, long long i) { return (T)p[i]; }
template <typename T> __device__ __forceinline__ T load(const __nv_bfloat16* p, long long i) {
  return (T)__bfloat162float(p[i]);
}

// x rounded to the input type: the plain version multiplies by eta there.
template <typename In, typename T> __device__ __forceinline__ T round_in(T x) { return x; }
template <> __device__ __forceinline__ float round_in<__nv_bfloat16, float>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename Out, typename T, int V> struct Store;
template <> struct Store<float, float, 4> {
  static __device__ __forceinline__ void vec(float* p, const float* s) {
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  }
  static __device__ __forceinline__ void one(float* p, float s) { *p = s; }
};
template <> struct Store<double, double, 2> {
  static __device__ __forceinline__ void vec(double* p, const double* s) {
    *reinterpret_cast<double2*>(p) = make_double2(s[0], s[1]);
  }
  static __device__ __forceinline__ void one(double* p, double s) { *p = s; }
};
template <> struct Store<__nv_bfloat16, float, 8> {
  static __device__ __forceinline__ void vec(__nv_bfloat16* p, const float* s) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
  }
  static __device__ __forceinline__ void one(__nv_bfloat16* p, float s) { *p = __float2bfloat16_rn(s); }
};

// The packed argument array of route_score_launch (route_score.py:_prepare).
enum Arg {
  kInDtype, kOutDtype, kPrompt, kSize, kFlopsTok, kWork, kEta, kUplink,
  kBackhaul, kFlops, kQueue, kResident, kBeta, kSpill, kModel, kReqCell,
  kSrvCell, kOut, kK, kC, kCloud, kRows, kCols, kDirect, kBlocks, kTx, kTy,
  kColTiles, kStripRows, kDevice, kArgs
};

template <typename In>
struct Args {
  const In *prompt, *size, *flops_tok, *work, *eta;
  const In *uplink, *backhaul, *flops, *queue;
  const uint8_t *resident, *beta, *spill;
  const int32_t *model, *req_cell, *srv_cell;
  void* out;
  int k, c, cloud_cell, b_rows, n_cols;
  bool direct;
  int tx, ty, col_tiles, strip_rows;
};

struct Flags {
  bool queue, gate, spill, res_bits, spill_bits, need_bh;
  int cloud;
};

template <typename In>
__device__ __forceinline__ Flags flags_of(const Args<In>& a, bool sw, bool cells) {
  Flags f;
  f.queue = a.queue != nullptr;
  f.gate = sw && a.resident != nullptr;
  f.spill = cells && a.spill != nullptr;
  f.res_bits = f.gate && a.k <= 32;
  f.spill_bits = f.spill && a.c <= kMaxCells;
  f.need_bh = sw || f.spill;
  f.cloud = a.cloud_cell;
  return f;
}

// A request's scalars as loaded, then as the scores use them.
template <typename T> struct RowRaw {
  T p, w, e, ft, sz;
  int m, rc;
  bool refuse;
};
template <typename T> struct Row {
  T p, w, ft, sz;                // after eta and beta
  int m, rc;                     // clamped model; request cell
  bool fast, sz_inf;             // in the reciprocal divide's range; size +inf
};

template <typename In, typename T, bool kSwitch, bool kCells>
__device__ __forceinline__ RowRaw<T> load_row(const Args<In>& a, const Flags& f, long long row) {
  RowRaw<T> r;
  r.p = load<T>(a.prompt, row);
  r.w = load<T>(a.work, row);
  r.e = a.eta != nullptr ? load<T>(a.eta, row) : T(1);
  r.ft = f.queue ? load<T>(a.flops_tok, row) : T(0);
  r.sz = kSwitch ? load<T>(a.size, row) : T(0);
  r.refuse = kSwitch && a.beta != nullptr && a.beta[row] == 0;
  r.m = f.gate ? a.model[row] : 0;
  r.rc = kCells ? a.req_cell[row] : 0;
  return r;
}

template <typename In, typename T, bool kSwitch>
__device__ __forceinline__ Row<T> derive_row(const Args<In>& a, const Flags& f, const RowRaw<T>& raw) {
  typedef Arith<T> A;
  Row<T> r;
  r.p = raw.p;
  r.w = raw.w;
  if (a.eta != nullptr) {
    r.p = round_in<In, T>(A::mul(raw.p, raw.e));
    r.w = round_in<In, T>(A::mul(raw.w, raw.e));
  }
  r.ft = raw.ft;
  r.sz = raw.refuse ? A::inf() : raw.sz;
  r.m = f.gate ? (raw.m < 0 ? 0 : (raw.m >= a.k ? a.k - 1 : raw.m)) : 0;  // as the plain gather clamps
  r.rc = raw.rc;
  r.sz_inf = kSwitch && r.sz == A::inf();
  // the backlog stays in range: see kWorkLo and the note
  const bool backlog_ok = f.queue
      ? in_range(r.w, kWorkLo, kWorkHi, true) && in_range(r.ft, kFtokLo, kFtokHi, true)
      : dividend_ok(r.w);
  r.fast = dividend_ok(r.p) && backlog_ok && (!kSwitch || r.sz_inf || dividend_ok(r.sz));
  return r;
}

// A server's scalars, with the reciprocals of its divisors.
template <typename T> struct Col {
  T up, up_r, fl, fl_r, bh, bh_r, q;
  int cell, cell_bit;
  uint32_t res;                  // residency bits (staged tiles, K <= 32)
  bool ok;                       // every operand in the reciprocal divide's range
};

template <typename In, typename T, bool kCells, bool kRcp = true>
__device__ __forceinline__ Col<T> load_col(const Args<In>& a, const Flags& f, int n) {
  typedef Arith<T> A;
  Col<T> c;
  c.up = load<T>(a.uplink, n);
  c.fl = load<T>(a.flops, n);
  c.bh = f.need_bh ? load<T>(a.backhaul, n) : T(1);
  c.q = f.queue ? load<T>(a.queue, n) : T(0);
  c.cell = kCells ? a.srv_cell[n] : 0;
  c.cell_bit = c.cell >= 0 && c.cell < a.c ? c.cell : kNoCell;
  c.up_r = kRcp ? A::rcp(c.up) : T(1);
  c.fl_r = kRcp ? A::rcp(c.fl) : T(1);
  c.bh_r = kRcp && f.need_bh ? A::rcp(c.bh) : T(1);
  c.res = 0;
  c.ok = divisor_ok(c.up) && divisor_ok(c.fl) && (!f.need_bh || divisor_ok(c.bh)) &&
         (!f.queue || in_range(c.q, kQueueLo, kQueueHi, true));
  return c;
}

template <typename T> __device__ __forceinline__ Col<T> inert_col() {
  Col<T> c = {T(1), T(1), T(1), T(1), T(1), T(1), T(0), 0, kNoCell, 0u, true};
  return c;
}

// The residency gate and the spill bit read as bytes (K > 32, C > 63, or
// a row walked without staging).
template <typename In>
__device__ __forceinline__ bool hit_byte(const Args<In>& a, const Flags& f, int n, int m) {
  return f.gate && a.resident[(long long)n * a.k + m] != 0;
}
template <typename In>
__device__ __forceinline__ bool spill_byte(const Args<In>& a, const Flags& f, int rc, int sc) {
  // out-of-range cells on either side (orphans, the cloud) never spill
  return f.spill && rc >= 0 && rc < a.c && sc >= 0 && sc < a.c && rc != sc &&
         a.spill[(long long)rc * a.c + sc] != 0;
}

// One score: eq. 5 + 7 + 9, the spill surcharge and the visibility mask,
// grouped as the plain version groups them. `hit` is the residency gate,
// `spilled` the pair's spill bit; kFast divides by the reciprocals.
template <bool kFast, bool kSwitch, bool kCells, typename T>
__device__ __forceinline__ T element(const Flags& f, const Row<T>& r, const Col<T>& c,
                                     bool hit, bool spilled) {
  typedef Arith<T> A;
  auto quot = [](T x, T d, T y) { return kFast ? rdiv(x, d, y) : A::div(x, d); };
  const T t_trans = quot(r.p, c.up, c.up_r);                            // eq. 5
  const T backlog = f.queue ? A::add(A::mul(c.q, r.ft), r.w) : r.w;
  const T t_comp = quot(backlog, c.fl, c.fl_r);                         // eq. 9
  T score;
  if (kSwitch) {
    T t_switch = kFast && r.sz_inf ? A::inf() : quot(r.sz, c.bh, c.bh_r);  // eq. 7
    if (f.gate && hit) t_switch = T(0);
    score = A::add(A::add(t_trans, t_switch), t_comp);                  // eq. 11
  } else {
    score = A::add(t_trans, t_comp);                                    // switch-free base
  }
  if (kCells) {
    const bool home = r.rc == c.cell;
    bool visible = home || c.cell == f.cloud;
    if (f.spill) {
      score = A::add(score, spilled ? quot(r.p, c.bh, c.bh_r) : T(0));
      visible = visible || spilled;
    }
    if (!visible) score = A::inf();
  }
  return score;
}

// A thread's V scores of one row: one 16-byte vector when every row of
// the output starts 16-byte aligned (N % V == 0), else one at a time.
template <int V, typename In, typename T, typename Out>
__device__ __forceinline__ void store_row(const Args<In>& a, int n0, Out* dst, const T (&score)[V]) {
  if (a.n_cols % V == 0) {
    Store<Out, T, V>::vec(dst, score);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (n0 + v < a.n_cols) Store<Out, T, V>::one(dst + v, score[v]);
  }
}

// The V scores of a thread's row: the reciprocal divides from the Cols
// held in registers and one 16-byte store (when the row stride allows),
// or, where an operand leaves the range, the IEEE divides one server at a
// time from `col(v)`.
template <bool kSwitch, bool kCells, int V, typename In, typename T, typename Out,
          typename Hit, typename Spill, typename ColAt>
__device__ __forceinline__ void row_out(const Args<In>& a, const Flags& f, const Row<T>& r,
                                        const Col<T> (&c)[V], bool cols_ok, int n0, Out* dst,
                                        Hit hit, Spill spilled, ColAt col) {
  if (cols_ok && r.fast) {
    T score[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      score[v] = element<true, kSwitch, kCells>(f, r, c[v], hit(v, c[v]), spilled(v, c[v]));
    store_row<V>(a, n0, dst, score);
  } else {
#pragma unroll 1
    for (int v = 0; v < V && n0 + v < a.n_cols; ++v) {
      const Col<T> cv = col(v);
      Store<Out, T, V>::one(dst + v, element<false, kSwitch, kCells>(
                                         f, r, cv, hit(v, cv), spilled(v, cv)));
    }
  }
}

// The server columns of one tile, read once per block; the request
// scalars of one chunk of rows (one a thread), derived once per row.
template <typename T, int V> struct Tile {
  Col<T> col[kMaxTx * V];
  unsigned long long spill_row[kMaxCells];
};

template <typename In, typename T, typename Out, bool kSwitch, bool kCells>
__global__ void __launch_bounds__(kThreads, 2) route_score_kernel(const Args<In> a) {
  constexpr int V = 16 / sizeof(Out);
  __shared__ Tile<T, V> s;
  __shared__ Row<T> rows[kThreads];

  const Flags f = flags_of(a, kSwitch, kCells);
  Out* out = static_cast<Out*>(a.out);
  if (a.direct) {
    // One score a thread, rows of N in order (B*N < 2**31: checked at the
    // launch): the thread reads its row and its server itself and divides
    // with the IEEE divide. No staging, no barrier.
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (unsigned)a.b_rows * (unsigned)a.n_cols) return;
    const int row = (int)(i / (unsigned)a.n_cols), n = (int)(i % (unsigned)a.n_cols);
    const RowRaw<T> raw = load_row<In, T, kSwitch, kCells>(a, f, row);
    const Col<T> cn = load_col<In, T, kCells, false>(a, f, n);
    const Row<T> r = derive_row<In, T, kSwitch>(a, f, raw);
    Store<Out, T, V>::one(out + i, element<false, kSwitch, kCells>(
                                       f, r, cn, hit_byte(a, f, n, r.m),
                                       spill_byte(a, f, r.rc, cn.cell)));
    return;
  }

  // Strips of many rows: the tile's servers once per block, each chunk's
  // rows once per row, both through shared memory.
  const int tile = blockIdx.x % a.col_tiles;
  const int r0 = (blockIdx.x / a.col_tiles) * a.strip_rows;
  const int r1 = min(r0 + a.strip_rows, a.b_rows);
  const int col0 = tile * a.tx * V;
  const int ncols = min(a.tx * V, a.n_cols - col0);
  const int gx = threadIdx.x % a.tx, gy = threadIdx.x / a.tx;
  const int n0 = col0 + gx * V;
  const bool active = n0 < a.n_cols;     // the thread has servers
  Col<T> c[V];
  bool cols_ok = true;

  const int chunk = blockDim.x;          // rows staged at a time, one a thread
  for (int c0 = r0; c0 < r1; c0 += chunk) {
    // 1. this thread's row of the chunk: the loads go out first, so their
    // latency overlaps the column work and the last chunk's scores
    const int mine = c0 + threadIdx.x;
    RowRaw<T> raw;
    if (mine < r1) raw = load_row<In, T, kSwitch, kCells>(a, f, mine);
    if (c0 == r0) {
      // 2. the tile's server columns into shared memory, once per block
      for (int j = threadIdx.x; j < ncols; j += blockDim.x) {
        const int n = col0 + j;
        Col<T> cn = load_col<In, T, kCells>(a, f, n);
        if (f.res_bits) {
          for (int i = 0; i < a.k; ++i)
            cn.res |= (uint32_t)(a.resident[(long long)n * a.k + i] != 0) << i;
        }
        s.col[j] = cn;
      }
      if (f.spill_bits) {  // row rc: the cells rc spills to, itself excluded
        for (int rc = threadIdx.x; rc < a.c; rc += blockDim.x) {
          unsigned long long bits = 0;
          for (int sc = 0; sc < a.c; ++sc)
            bits |= (unsigned long long)(a.spill[(long long)rc * a.c + sc] != 0) << sc;
          s.spill_row[rc] = bits & ~(1ull << rc);
        }
      }
    } else {
      __syncthreads();                   // the last chunk's rows are read
    }
    // 3. the row's derived scalars into shared memory
    if (mine < r1) rows[threadIdx.x] = derive_row<In, T, kSwitch>(a, f, raw);
    __syncthreads();
    if (!active) continue;
    if (c0 == r0) {  // 4. this thread's V servers into registers, once
#pragma unroll
      for (int v = 0; v < V; ++v) {
        c[v] = gx * V + v < ncols ? s.col[gx * V + v] : inert_col<T>();
        cols_ok = cols_ok && c[v].ok;
      }
    }
    // 5. the thread's rows of the chunk
    const int nrows = min(chunk, r1 - c0);
    for (int i = gy; i < nrows; i += a.ty) {
      const Row<T> r = rows[i];
      const uint32_t mbit = 1u << (r.m & 31);
      const unsigned long long srow =
          f.spill_bits && r.rc >= 0 && r.rc < a.c ? s.spill_row[r.rc] : 0ull;
      row_out<kSwitch, kCells, V>(
          a, f, r, c, cols_ok, n0, out + (long long)(c0 + i) * a.n_cols + n0,
          [&](int v, const Col<T>& cv) {
            return f.res_bits ? (cv.res & mbit) != 0u
                              : n0 + v < a.n_cols && hit_byte(a, f, n0 + v, r.m);
          },
          [&](int, const Col<T>& cv) {
            return f.spill_bits ? ((srow >> cv.cell_bit) & 1ull) != 0ull
                                : spill_byte(a, f, r.rc, cv.cell);
          },
          [&](int v) { return s.col[gx * V + v]; });
    }
  }
}

__global__ void route_score_empty_kernel() {}

template <typename In, typename T, typename Out>
int launch(const long long* x, cudaStream_t stream) {
  Args<In> a;
  a.prompt = (const In*)x[kPrompt];
  a.size = (const In*)x[kSize];
  a.flops_tok = (const In*)x[kFlopsTok];
  a.work = (const In*)x[kWork];
  a.eta = (const In*)x[kEta];
  a.uplink = (const In*)x[kUplink];
  a.backhaul = (const In*)x[kBackhaul];
  a.flops = (const In*)x[kFlops];
  a.queue = (const In*)x[kQueue];
  a.resident = (const uint8_t*)x[kResident];
  a.beta = (const uint8_t*)x[kBeta];
  a.spill = (const uint8_t*)x[kSpill];
  a.model = (const int32_t*)x[kModel];
  a.req_cell = (const int32_t*)x[kReqCell];
  a.srv_cell = (const int32_t*)x[kSrvCell];
  a.out = (void*)x[kOut];
  a.k = (int)x[kK];
  a.c = (int)x[kC];
  a.cloud_cell = (int)x[kCloud];
  a.b_rows = (int)x[kRows];
  a.n_cols = (int)x[kCols];
  a.direct = x[kDirect] != 0;
  a.tx = (int)x[kTx];
  a.ty = (int)x[kTy];
  a.col_tiles = (int)x[kColTiles];
  a.strip_rows = (int)x[kStripRows];
  const unsigned blocks = (unsigned)x[kBlocks];
  const unsigned threads = (unsigned)(a.tx * a.ty);
  const bool sw = a.size != nullptr, cells = a.req_cell != nullptr;
  if (sw && cells)
    route_score_kernel<In, T, Out, true, true><<<blocks, threads, 0, stream>>>(a);
  else if (sw)
    route_score_kernel<In, T, Out, true, false><<<blocks, threads, 0, stream>>>(a);
  else if (cells)
    route_score_kernel<In, T, Out, false, true><<<blocks, threads, 0, stream>>>(a);
  else
    route_score_kernel<In, T, Out, false, false><<<blocks, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Runs fn with `device` current, restoring the caller's device after it.
template <typename Fn> int on_device(int device, Fn fn) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const int rc = fn();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace

// `args` is the packed array of the enum Arg above: dtype codes 0
// float32, 1 float64, 2 bfloat16, with the (in, out) pairs (0, 0),
// (1, 1), (2, 2), (0, 2); the pointers (0 for an absent column; req_cell
// and srv_cell both or neither, spill only with them); K, C, the cloud
// cell, B, N; the plan: direct (one score a thread) or not, blocks, tx,
// ty, column tiles, rows a strip (route_score.py:plan; V is 16 /
// sizeof(out)); the device. Launches on
// `stream` with that device current. Returns a cudaError_t code (0 on
// success), -1 for an unsupported dtype pair or plan.
extern "C" int route_score_launch(const long long* args, void* stream) {
  const long long* x = args;
  const long long scores = x[kRows] * x[kCols], threads = x[kTx] * x[kTy];
  bool ok = x[kTx] >= 1 && x[kTx] <= kMaxTx && x[kTy] >= 1 && threads <= kThreads &&
            x[kBlocks] >= 1 && x[kBlocks] <= 0x7fffffffLL;
  if (x[kDirect])  // one thread a score, 32-bit indices
    ok = ok && scores <= 0x7fffffffLL && x[kBlocks] * threads >= scores;
  else  // column tiles x strips
    ok = ok && x[kColTiles] >= 1 && x[kStripRows] >= 1 &&
         x[kBlocks] == x[kColTiles] * ((x[kRows] + x[kStripRows] - 1) / x[kStripRows]);
  if (!ok) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const long long in = x[kInDtype], out = x[kOutDtype];
  return on_device((int)x[kDevice], [&]() {
    if (in == 0 && out == 0) return launch<float, float, float>(x, st);
    if (in == 1 && out == 1) return launch<double, double, double>(x, st);
    if (in == 2 && out == 2) return launch<__nv_bfloat16, float, __nv_bfloat16>(x, st);
    if (in == 0 && out == 2) return launch<float, float, __nv_bfloat16>(x, st);
    return -1;
  });
}

// An empty kernel at a given grid on a given device: the launch floor
// the scores are timed against (chip_smoke.py).
extern "C" int route_score_empty_launch(int blocks, int threads, int device, void* stream) {
  return on_device(device, [&]() {
    route_score_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
  });
}

extern "C" const char* route_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
