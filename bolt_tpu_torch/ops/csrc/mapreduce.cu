// Map-reduce kernel for Hopper (sm_90a), bound with ctypes through a plain C
// interface (bolt_tpu_torch/ops/_build.py builds this file with nvcc,
// bolt_tpu_torch/ops/kernels.py :: fused_map_reduce and
// fused_map_reduce_cols are the wrappers, with their plain PyTorch version
// beside them).
//
// bolt_fused_map_reduce_full and bolt_fused_map_reduce_cols replace the
// Pallas kernel bolt_tpu/ops/kernels.py :: fused_map_reduce (_mr_kernel):
// sum(fn(x)) with the elementwise map applied inside the reduction, so the
// mapped values never reach device memory.
//   The map.  A CUDA kernel cannot call a Python callable, so the wrapper
//   hands over fn as an expression program (bolt_tpu_torch/ops/mapexpr.py
//   compiles a pointwise chain into it): at most kMaxInstrs instructions
//   (op, dst, a, b, k) over kRegs registers, register 0 holding the element
//   on entry; the result is the last instruction's.  The program is a
//   kernel parameter passed by value (__grid_constant__, read from the
//   constant bank), and every thread runs the same instruction at the same
//   time, so the interpreter's switch does not diverge.  Arithmetic runs in
//   the accumulator type (f32 for f16/bf16) with round-to-nearest
//   intrinsics (no FMA contraction), and f16/bf16 round each arithmetic
//   result to the storage type, as torch does op by op and as the
//   reference's kernel does (tests/test_torch_mapreduce.py holds both to
//   one bf16 element); so + - * / and sqrt give the plain version's values
//   bit for bit.
//   Bound on an H100 SXM: the bytes, the input read once over 3.35 TB/s.
//   What held the first design back was instruction count: it dispatched
//   every instruction (the loop, the Instr read from the constant bank, the
//   operand flag tests, the switch) once per 16-byte pack, four f32 values,
//   and each instruction past the first cost about 1.5-2 ms at the
//   north-star's 2.6e9 elements.
//   The design.
//   * A tile per dispatch.  Each thread holds a tile of ROWS rows (column
//     form) or grid strides (full form) of one 16-byte pack each, 16 values
//     for f32 and f16/bf16 (8 for f64), and runs each instruction once over
//     the whole tile.  Operands that are the previous instruction's result
//     stay in registers; the rest come from a register file in shared
//     memory, which holds ROWS * VEC values a register for every thread
//     (16 KB a register a block at the wide tile, where the f32 kernel
//     takes 123 registers a thread, two blocks an SM).  A file of eight
//     registers would leave room for one block, so the wrapper halves ROWS
//     when the program stores more than seven (80 registers a thread,
//     three blocks an SM).  v + 1 and v * 2 + 1 never touch the file.
//   * A tile's loads in flight together.  All ROWS 16-byte loads of a tile
//     are in flight before the program runs on it, and the warps resident on
//     an SM cover each other's latency.  Registers decide how many warps
//     are resident: a register double buffer of the next tile measured
//     slower than the warps its registers cost, and so did reading the
//     operands 16 bytes at a time (the compiler spilled).
//   * Math-library calls 16 bytes at a time.  A program with sin, cos or
//     a general pow takes the kCalls variant: it loads and computes its
//     tiles like the others, and runs each call over the tile through the
//     register file, one 16-byte unit at a time in a loop the compiler
//     does not unroll, so few registers are live across a call.
//   * A grid of one wave, and a floor of work a block.  The column form is
//     split by rows and columns into as many equal shares as the card holds
//     blocks at once (the wrapper asks the occupancy API): block b takes row
//     units [b*W/P, (b+1)*W/P) of the W = column blocks * n units, in one to
//     a few segments of consecutive column blocks, so no block waits for a
//     second wave.  Each segment writes its partial sums to scratch and a
//     second kernel adds the partials of each column in block order; when
//     every block holds exactly one column block whole, the block writes
//     the output itself and the second kernel is not launched.  The full
//     form is a grid-stride pass over the same number of blocks, one
//     partial a block folded by a fixed-order tree, then one block folds
//     the partials in order; a grid of one block writes the output itself.
//     A small input does not take one wave: the wrapper gives each block a
//     floor of packs a thread (kernels.py :: _MIN_PACKS), so a (128, 32)
//     f32 base is one block that writes its output, one launch and no
//     scratch, where a block a row left 31 of its 32 row lanes idle and
//     needed the second kernel.  At the north-star the floor does not bind.
//   Column form (n, C) -> (C,): within a segment each thread owns VEC
//   neighbouring columns (one 16-byte load a row when the alignment
//   allows); when C is narrower than a block the block's threads also split
//   the rows into row lanes, folded by a fixed tree in shared memory.  An
//   optional uint8 record mask (n,) drops every row whose byte is 0: the
//   row is neither loaded nor added (a tile takes the lane's next kept
//   rows), so a dropped record full of NaN leaves the sum finite
//   (filter(...).sum()).
//   Every column is summed in row order within a lane, and lanes, segments
//   and partials are folded in a fixed order: no atomics, and the result is
//   the same from run to run.
// Accumulator: f32 for f16/bf16/f32, f64 for f64; results are written in
// the input's type.
//
// bolt_fused_map_reduce_cols_lanes and bolt_fused_map_reduce_full_lanes
// (kernels.py :: fused_map_reduce_lanes) replace no further Pallas call:
// they are the batch axis that jax.vmap adds to _mr_kernel
// (bolt_tpu/ops/kernels.py:99, its pallas_call at :129) when the serving
// layer's micro-batching (bolt_tpu/tpu/batched.py) vmaps a terminal over
// W queued requests.  blockIdx.y is the request: each lane reads its own
// base in place (no stacking copy, and each base keeps the 16-byte
// alignment its standalone launch had) and runs the standalone grid, so
// each lane's sum equals its standalone launch bit for bit; only lanes of
// one pack width share a launch.  The lanes' input and output pointers
// travel by value in the launch's parameters (Lanes, __grid_constant__, up
// to kMaxLanes a launch), so a call copies no pointer table to the device;
// the standalone entries pass their one base through the same table.
// Bound: at the serving configuration of 16 requests of (128, 32) f32,
// 256 KB read, some 0.08 us of memory time, so a call there is bound by
// its launch and the host, not by bytes: what the design does about that
// is one kernel and no scratch a call, and a host path the wrapper plans
// once a shape.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;   // threads per block, a multiple of 32
constexpr int kMaxInstrs = 32;  // mapexpr.MAX_INSTRUCTIONS
constexpr int kRegs = 8;        // mapexpr.MAX_REGISTERS
constexpr int kCombineLoads = 16;  // partials a combine thread has in flight

// opcodes, in the order of bolt_tpu_torch/ops/mapexpr.py :: OPS; *C takes
// the constant k as its second operand, RSUBC as its first
enum Op : int {
  MOV, LOADC, ADD, ADDC, SUB, SUBC, RSUBC, MUL, MULC, DIV, DIVC, NEG, ABS, SQRT, RSQRT, EXP,
  LOG, SIN, COS, TANH, SIGMOID, RECIP, POWC, MAX, MIN, CLAMPMINC, CLAMPMAXC, GT, GE, LT, LE,
  EQ, NE, GTC, GEC, LTC, LEC, EQC, NEC, WHERE, kNumOps
};

// Flags of an instruction, set by kernels.py :: _program_struct from the
// program's data flow: which operands it reads (READ_C: WHERE's condition,
// from r[dst]), which of them is the previous instruction's result (kept in
// registers, so it is not read back), and whether its result must be stored
// in the register file (a later instruction past the next one reads it).
enum : int {
  kReadA = 1, kReadB = 2, kReadC = 4, kAPrev = 8, kBPrev = 16, kCPrev = 32, kStore = 64
};
// Program flags: kStoreX stores the element in r[0] before the first
// instruction (an instruction past the first reads it).
enum : int { kStoreX = 1 };

// One instruction: r[dst] = op(r[a], r[b], k); WHERE's condition is r[dst].
// 16 bytes, the layout of kernels.py :: _Instr.
struct Instr {
  int8_t op, dst, a, b;
  int32_t flags;
  double k;
};

// nfile: the registers the program stores (0 .. nfile - 1), which the
// register file in shared memory must hold (the kCalls variant adds one
// more, register nfile, through which it calls the math library).  The
// result is the last instruction's (the element itself for n == 0).
struct Program {
  int32_t n, flags, nfile, pad;
  Instr ins[kMaxInstrs];
};

// The lanes of one launch (blockIdx.y indexes them): each lane's input base
// and its output, a kernel parameter by value beside the Program, so no
// pointer table is copied to the device.  The layout of kernels.py ::
// _Lanes; the standalone entries fill lane 0.
constexpr int kMaxLanes = 64;   // kernels.py :: _MAX_LANES
struct Lanes {
  const void* in[kMaxLanes];
  void* out[kMaxLanes];
};
// Every CUDA 12 toolkit takes 4 KB of kernel parameters: the Program, the
// table and the scalar parameters (at most 64 bytes beside them) fit.
static_assert(sizeof(Program) + sizeof(Lanes) + 64 <= 4096,
              "a launch's parameters must stay within 4 KB");

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_acc(typename Acc<T>::type v);
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_acc<double>(double v) { return v; }
template <> __device__ __forceinline__ __half from_acc<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// An arithmetic result rounded to the storage type T (f16/bf16) and back.
template <typename T> __device__ __forceinline__ typename Acc<T>::type rnd(typename Acc<T>::type v) {
  return v;
}
template <> __device__ __forceinline__ float rnd<__half>(float v) {
  return __half2float(__float2half_rn(v));
}
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// IEEE round-to-nearest arithmetic and the math library, by precision.
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rsqrt_(double a) { return rsqrt(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float log_(float a) { return logf(a); }
__device__ __forceinline__ double log_(double a) { return log(a); }
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ double sin_(double a) { return sin(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float tanh_(float a) { return tanhf(a); }
__device__ __forceinline__ double tanh_(double a) { return tanh(a); }
__device__ __forceinline__ float pow_(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_(double a, double b) { return pow(a, b); }

// NaN-propagating maximum/minimum (torch.maximum); clamp keeps a NaN input.
template <typename A> __device__ __forceinline__ A nan_max(A a, A b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename A> __device__ __forceinline__ A nan_min(A a, A b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// Whether torch's pow computes a ** k by a special case of the exponent
// (pow_tensor_scalar): no call into the math library.
template <typename A> __host__ __device__ __forceinline__ bool pow_special(A k) {
  return k == A(2) || k == A(3) || k == A(0.5) || k == A(-0.5) || k == A(-1) || k == A(-2);
}
template <typename A> __device__ __forceinline__ A pow_by_case(A a, A k) {
  if (k == A(2)) return mul_(a, a);
  if (k == A(3)) return mul_(mul_(a, a), a);
  if (k == A(0.5)) return sqrt_(a);
  if (k == A(-0.5)) return rsqrt_(a);
  if (k == A(-1)) return div_(A(1), a);
  return div_(A(1), mul_(a, a));   // k == -2
}

// ---------------------------------------------------------------------------
// the register file
// ---------------------------------------------------------------------------

// The register file in the block's dynamic shared memory: register r of
// thread t holds the thread's TILE values in 16-byte units (single values
// when TILE values do not fill whole units), unit w at ((r * kUnits + w) *
// kThreads + t), so a warp reads or writes 32 neighbouring units and no two
// threads share a bank.
template <typename A, int TILE>
struct File {
  static constexpr bool kWide = (TILE * sizeof(A)) % 16 == 0;
  static constexpr int kUnitBytes = kWide ? 16 : (int)sizeof(A);
  static constexpr int kUnits = TILE * (int)sizeof(A) / kUnitBytes;
  static constexpr int kPer = kUnitBytes / (int)sizeof(A);   // values a unit
  unsigned char* base;

  __device__ __forceinline__ unsigned char* unit(int r, int w) const {
    return base + ((size_t)(r * kUnits + w) * kThreads + threadIdx.x) * kUnitBytes;
  }
  __device__ __forceinline__ void load_unit(int r, int w, A* u) const {
    if constexpr (kWide) {
      const uint4 raw = *reinterpret_cast<const uint4*>(unit(r, w));
      memcpy(u, &raw, 16);
    } else {
      u[0] = *reinterpret_cast<const A*>(unit(r, w));
    }
  }
  __device__ __forceinline__ void store_unit(int r, int w, const A* u) const {
    if constexpr (kWide) {
      uint4 raw;
      memcpy(&raw, u, 16);
      *reinterpret_cast<uint4*>(unit(r, w)) = raw;
    } else {
      *reinterpret_cast<A*>(unit(r, w)) = u[0];
    }
  }
  __device__ __forceinline__ void load(int r, A (&v)[TILE]) const {
#pragma unroll
    for (int w = 0; w < kUnits; ++w) load_unit(r, w, &v[w * kPer]);
  }
  __device__ __forceinline__ void store(int r, const A (&v)[TILE]) const {
#pragma unroll
    for (int w = 0; w < kUnits; ++w) store_unit(r, w, &v[w * kPer]);
  }
};

// Bytes of dynamic shared memory a register file of nregs registers takes.
template <typename A, int TILE>
size_t file_bytes(int nregs) {
  return sizeof(A) * TILE * kThreads * (size_t)nregs;
}

// ---------------------------------------------------------------------------
// the interpreter
// ---------------------------------------------------------------------------

// fn of a call into the math library over the tile: the TILE values of a
// go through register `scratch` of the file, 16 bytes at a time (a loop
// the compiler does not unroll), and come back in x, so only one unit's
// values and the loop's own registers are live across a call.
template <typename T, int TILE, typename F>
__device__ __forceinline__ void call_each(const File<typename Acc<T>::type, TILE>& file,
                                          int scratch, const typename Acc<T>::type (&a)[TILE],
                                          typename Acc<T>::type (&x)[TILE], F fn) {
  using A = typename Acc<T>::type;
  constexpr int kPer = File<A, TILE>::kPer;
  file.store(scratch, a);
#pragma unroll 1
  for (int w = 0; w < File<A, TILE>::kUnits; ++w) {
    A u[kPer];
    file.load_unit(scratch, w, u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) u[j] = rnd<T>(fn(u[j]));
    file.store_unit(scratch, w, u);
  }
  file.load(scratch, x);
}

// One instruction over the tile: x[v] = op(a[v], b[v], k).  a may be x
// itself (the previous result as the first operand): each value reads its
// operands before it is written.  Not WHERE (run_program does it).
template <typename T, int TILE, bool kCalls>
__device__ __forceinline__ void apply(int op, typename Acc<T>::type k,
                                      const typename Acc<T>::type (&a)[TILE],
                                      const typename Acc<T>::type (&b)[TILE],
                                      typename Acc<T>::type (&x)[TILE],
                                      const File<typename Acc<T>::type, TILE>& file, int scratch) {
  using A = typename Acc<T>::type;
#define BOLT_EACH(expr) \
  _Pragma("unroll") for (int v = 0; v < TILE; ++v) x[v] = (expr); \
  break
#define BOLT_ARITH(expr) BOLT_EACH(rnd<T>(expr))
  switch (op) {
    case MOV: BOLT_EACH(a[v]);
    case LOADC: BOLT_EACH(k);
    case ADD: BOLT_ARITH(add_(a[v], b[v]));
    case ADDC: BOLT_ARITH(add_(a[v], k));
    case SUB: BOLT_ARITH(sub_(a[v], b[v]));
    case SUBC: BOLT_ARITH(sub_(a[v], k));
    case RSUBC: BOLT_ARITH(sub_(k, a[v]));
    case MUL: BOLT_ARITH(mul_(a[v], b[v]));
    case MULC: BOLT_ARITH(mul_(a[v], k));
    case DIV: BOLT_ARITH(div_(a[v], b[v]));
    // torch divides by a number as a product with its reciprocal
    case DIVC: {
      const A inv = div_(A(1), k);
      BOLT_ARITH(mul_(a[v], inv));
    }
    case NEG: BOLT_ARITH(-a[v]);
    case ABS: BOLT_ARITH(abs_(a[v]));
    case SQRT: BOLT_ARITH(sqrt_(a[v]));
    case RSQRT: BOLT_ARITH(rsqrt_(a[v]));
    case EXP: BOLT_ARITH(exp_(a[v]));
    case LOG: BOLT_ARITH(log_(a[v]));
    case SIN:
      if constexpr (kCalls) call_each<T>(file, scratch, a, x, [](A u) { return sin_(u); });
      break;
    case COS:
      if constexpr (kCalls) call_each<T>(file, scratch, a, x, [](A u) { return cos_(u); });
      break;
    case TANH: BOLT_ARITH(tanh_(a[v]));
    case SIGMOID: BOLT_ARITH(div_(A(1), add_(A(1), exp_(-a[v]))));
    case RECIP: BOLT_ARITH(div_(A(1), a[v]));
    case POWC:
      if (pow_special(k)) {
        BOLT_ARITH(pow_by_case(a[v], k));
      }
      if constexpr (kCalls) call_each<T>(file, scratch, a, x, [k](A u) { return pow_(u, k); });
      break;
    case MAX: BOLT_ARITH(nan_max(a[v], b[v]));
    case MIN: BOLT_ARITH(nan_min(a[v], b[v]));
    case CLAMPMINC: BOLT_ARITH(a[v] != a[v] ? a[v] : (a[v] < k ? k : a[v]));
    case CLAMPMAXC: BOLT_ARITH(a[v] != a[v] ? a[v] : (a[v] > k ? k : a[v]));
    case GT: BOLT_EACH(a[v] > b[v] ? A(1) : A(0));
    case GE: BOLT_EACH(a[v] >= b[v] ? A(1) : A(0));
    case LT: BOLT_EACH(a[v] < b[v] ? A(1) : A(0));
    case LE: BOLT_EACH(a[v] <= b[v] ? A(1) : A(0));
    case EQ: BOLT_EACH(a[v] == b[v] ? A(1) : A(0));
    case NE: BOLT_EACH(a[v] != b[v] ? A(1) : A(0));
    case GTC: BOLT_EACH(a[v] > k ? A(1) : A(0));
    case GEC: BOLT_EACH(a[v] >= k ? A(1) : A(0));
    case LTC: BOLT_EACH(a[v] < k ? A(1) : A(0));
    case LEC: BOLT_EACH(a[v] <= k ? A(1) : A(0));
    case EQC: BOLT_EACH(a[v] == k ? A(1) : A(0));
    case NEC: BOLT_EACH(a[v] != k ? A(1) : A(0));
    default: break;
  }
#undef BOLT_ARITH
#undef BOLT_EACH
}

// The program on the tile x (the elements on entry, fn's values on exit),
// one dispatch of each instruction for all TILE values.  Each instruction
// reads its operands from the file, or from the previous result when its
// flags say so, and stores its result only when a later instruction needs
// it; so a chain such as v * 2 + 1 never touches the file.
template <typename T, int TILE, bool kCalls>
__device__ __forceinline__ void run_program(const Program& p,
                                            const File<typename Acc<T>::type, TILE>& file,
                                            typename Acc<T>::type (&x)[TILE]) {
  using A = typename Acc<T>::type;
  if (p.n == 0) return;
  if (p.flags & kStoreX) file.store(0, x);
  const int scratch = p.nfile;
  for (int i = 0; i < p.n; ++i) {
    const Instr in = p.ins[i];
    const int f = in.flags;
    const A k = A(in.k);
    A a[TILE], b[TILE];
    if ((f & kReadA) && !(f & kAPrev)) file.load(in.a, a);
    if (f & kReadB) {
      if (f & kBPrev) {
#pragma unroll
        for (int v = 0; v < TILE; ++v) b[v] = x[v];
      } else {
        file.load(in.b, b);
      }
    }
    if (in.op == WHERE) {
      // the condition r[dst]: the previous result, or from the file (into
      // the array the operand a does not use)
      if (f & kAPrev) {
        if (f & kCPrev) {
#pragma unroll
          for (int v = 0; v < TILE; ++v) x[v] = x[v] != A(0) ? x[v] : b[v];
        } else {
          file.load(in.dst, a);
#pragma unroll
          for (int v = 0; v < TILE; ++v) x[v] = a[v] != A(0) ? x[v] : b[v];
        }
      } else {
        if (!(f & kCPrev)) file.load(in.dst, x);
#pragma unroll
        for (int v = 0; v < TILE; ++v) x[v] = x[v] != A(0) ? a[v] : b[v];
      }
    } else if (f & kAPrev) {
      apply<T, TILE, kCalls>(in.op, k, x, b, x, file, scratch);
    } else {
      apply<T, TILE, kCalls>(in.op, k, a, b, x, file, scratch);
    }
    if (f & kStore) file.store(in.dst, x);
  }
}

// ---------------------------------------------------------------------------
// loading and folding tiles
// ---------------------------------------------------------------------------

// VEC neighbouring elements from p: one 16-byte load when VEC * sizeof(T)
// is 16 (the wrapper guarantees the alignment), else one element.
template <typename T, int VEC>
__device__ __forceinline__ void load_pack(const T* __restrict__ p, T (&out)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "a pack is one element or 16 bytes");
  if constexpr (VEC == 1) {
    out[0] = p[0];
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(out, &raw, sizeof(raw));
  }
}

// Adds fn of `count` packs to acc, pack j at p + j * step, skipping those
// whose mask byte (m0 + j * mstep; null mask: none) is 0: tiles of ROWS
// kept packs, all of a tile's loads in flight before the program runs on it,
// each kept pack added in order.  A tile is filled with the next kept packs
// (a dropped pack is not loaded and takes no slot), so a mask that drops
// half the records still keeps ROWS loads in flight a thread; the slots
// past the last kept pack read zeros and add nothing.  (A register double
// buffer of the next tile measured slower: its registers cost more resident
// warps than its loads in flight bought.)
template <typename T, int VEC, int ROWS, bool kCalls>
__device__ __forceinline__ void fold_packs(const Program& prog,
                                           const File<typename Acc<T>::type, ROWS * VEC>& file,
                                           const T* __restrict__ p, int64_t step,
                                           const uint8_t* __restrict__ mask, int64_t m0,
                                           int64_t mstep, int64_t count,
                                           typename Acc<T>::type (&acc)[VEC]) {
  using A = typename Acc<T>::type;
  constexpr int kTile = ROWS * VEC;
  int64_t j = 0;   // the next pack to look at
  while (j < count) {
    T raw[ROWS][VEC];
    bool keep[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (mask != nullptr)
        while (j < count && mask[m0 + j * mstep] == 0) ++j;
      keep[u] = j < count;
      if (keep[u]) {
        load_pack<T, VEC>(p + j * step, raw[u]);
        ++j;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) raw[u][v] = T(0.0f);
      }
    }
    if (!keep[0]) break;
    A x[kTile];
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[u * VEC + v] = to_acc(raw[u][v]);
    run_program<T, kTile, kCalls>(prog, file, x);
#pragma unroll
    for (int u = 0; u < ROWS; ++u)
      if (keep[u]) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += x[u * VEC + v];
      }
  }
}

// ---------------------------------------------------------------------------
// column form
// ---------------------------------------------------------------------------

// The block's threads form `lanes` row lanes of kThreads / lanes column
// threads each (thread t: column thread t % width, lane t / width).  Adds
// every lane's VEC sums into lane 0 by a tree in a fixed order, through
// dynamic shared memory of VEC * kThreads / 2 accumulators when lanes > 1.
template <typename A, int VEC>
__device__ __forceinline__ void combine_lanes(A (&acc)[VEC], int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* sh = reinterpret_cast<A*>(smem);
  constexpr int kHalf = kThreads / 2;
  const int t = threadIdx.x;
  const int width = kThreads / lanes;
  const int lane = t / width;
  for (int s = lanes / 2; s > 0; s >>= 1) {
    if (lane >= s && lane < 2 * s) {
      const int i = t - s * width;
#pragma unroll
      for (int v = 0; v < VEC; ++v) sh[v * kHalf + i] = acc[v];
    }
    __syncthreads();
    if (lane < s) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += sh[v * kHalf + t];
    }
    __syncthreads();
  }
}

// The block with index b of P holds row units [b * W / P, (b + 1) * W / P)
// of the W = G * n units (unit g * n + r: row r of column block g).
__device__ __forceinline__ int64_t unit_start(int64_t b, int64_t W, int64_t P) {
  return b * W / P;
}

// Column sums of fn over this block's share: for each column block its
// units touch (segment s = 0, 1, ...), rows [ra, rb) of that block's cw =
// width * VEC columns, lane l walking rows ra + l, ra + l + lanes, ....
// With part null every block holds one column block whole and writes out
// in T; otherwise segment s writes its sums, in the accumulator type, to
// part[(blockIdx.x * segs + s) * cw + column within the column block].
//
// blockIdx.y is the batch lane b: its input is io.in[b], its output
// io.out[b] and its scratch the b-th slice of part.  Every lane runs the
// standalone grid over its own base, so each lane's sums are the
// standalone launch's bit for bit (the standalone launch is lane 0 of 1).
template <typename T, int VEC, int ROWS, bool kCalls>
__global__ void __launch_bounds__(kThreads, 2)
mr_cols_kernel(const __grid_constant__ Program prog, const __grid_constant__ Lanes io,
               const uint8_t* __restrict__ mask, typename Acc<T>::type* __restrict__ part,
               int64_t n, int64_t C, int lanes, int segs) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const File<A, ROWS * VEC> file{smem};
  const int width = kThreads / lanes;
  const int lane = threadIdx.x / width;
  const int64_t cw = (int64_t)width * VEC;
  const T* __restrict__ x = static_cast<const T*>(io.in[blockIdx.y]);
  T* __restrict__ out = static_cast<T*>(io.out[blockIdx.y]);
  if (part != nullptr) part += (int64_t)blockIdx.y * gridDim.x * segs * cw;
  const int64_t W = (C + cw - 1) / cw * n;
  const int64_t u0 = unit_start(blockIdx.x, W, gridDim.x);
  const int64_t u1 = unit_start((int64_t)blockIdx.x + 1, W, gridDim.x);
  int s = 0;
  for (int64_t g = u0 / n; g * n < u1; ++g, ++s) {
    const int64_t ra = (u0 > g * n ? u0 : g * n) - g * n;
    const int64_t rb = (u1 < g * n + n ? u1 : g * n + n) - g * n;
    const int64_t col = g * cw + (int64_t)(threadIdx.x % width) * VEC;
    const bool active = col < C;   // idle threads still join combine_lanes
    A acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = A(0);
    const int64_t r = ra + lane;
    if (active && r < rb)
      fold_packs<T, VEC, ROWS, kCalls>(prog, file, x + r * C + col, (int64_t)lanes * C, mask,
                                       r, lanes, (rb - r + lanes - 1) / lanes, acc);
    if (lanes > 1) {
      __syncthreads();   // the lanes' scratch reuses the register file
      combine_lanes<A, VEC>(acc, lanes);
    }
    if (!active || lane != 0) continue;
    if (part == nullptr) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) out[col + v] = from_acc<T>(acc[v]);
    } else {
      A* dst = part + ((int64_t)blockIdx.x * segs + s) * cw + (col - g * cw);
#pragma unroll
      for (int v = 0; v < VEC; ++v) dst[v] = acc[v];
    }
  }
}

// out[c] = the partials of column c, from the blocks whose shares hold its
// column block, added in block order, in T.  blockIdx.y is the batch lane
// (its partials and its output io.out[b], as in mr_cols_kernel).  The
// partials are loaded kCombineLoads at a time, all in flight before they
// are added in order, and only the first block's segment is computed (a
// 64-bit division): a narrow input split by rows gives a column the
// partials of hundreds of blocks, and a division and one load at a time
// left the thread waiting on each (96 us of a (8192, 256) f32 launch's
// 102, PERF.md).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr_cols_combine_kernel(const typename Acc<T>::type* __restrict__ part,
                       const __grid_constant__ Lanes io, int64_t n, int64_t C, int64_t cw,
                       int64_t P, int segs) {
  using A = typename Acc<T>::type;
  part += (int64_t)blockIdx.y * P * segs * cw;
  T* __restrict__ out = static_cast<T*>(io.out[blockIdx.y]);
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t W = (C + cw - 1) / cw * n;
  const int64_t g = c / cw;
  // the block holding unit u is the last b with unit_start(b) <= u
  const int64_t b0 = ((g * n + 1) * P - 1) / W;
  const int64_t b1 = ((g * n + n) * P - 1) / W;
  // block b0 may start in an earlier column block, so this one is its
  // segment g - (its first); every later block of the range starts inside
  // this column block, so this is its segment 0
  const int64_t col = c - g * cw;
  const int64_t stride = (int64_t)segs * cw;   // from one block's partials to the next's
  A s = A(0);
  s += part[(b0 * segs + g - unit_start(b0, W, P) / n) * cw + col];
  const A* __restrict__ p = part + (b0 + 1) * stride + col;
  int64_t left = b1 - b0;
  for (; left >= kCombineLoads; left -= kCombineLoads, p += kCombineLoads * stride) {
    A v[kCombineLoads];
#pragma unroll
    for (int j = 0; j < kCombineLoads; ++j) v[j] = p[j * stride];
#pragma unroll
    for (int j = 0; j < kCombineLoads; ++j) s += v[j];
  }
  for (int64_t j = 0; j < left; ++j) s += p[j * stride];
  out[c] = from_acc<T>(s);
}

// The smem a column-form block takes: the register file, or the lanes'
// scratch when that is larger.
template <typename T, int VEC, int ROWS, bool kCalls>
size_t cols_smem(int nfile, int lanes) {
  using A = typename Acc<T>::type;
  const size_t lane_bytes = lanes > 1 ? sizeof(A) * VEC * (kThreads / 2) : 0;
  return std::max(lane_bytes, file_bytes<A, ROWS * VEC>(nfile + (kCalls ? 1 : 0)));
}

// Lets the kernel take smem bytes of dynamic shared memory: above 48 KB less
// the kernel's own static shared memory (block_sum's, which the full form
// adds), the launch needs the attribute raised first.
template <typename F>
cudaError_t allow_smem(F kernel, size_t smem) {
  if (smem + 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct ColsLaunch {
  template <typename T, int VEC, int ROWS, bool kCalls>
  static cudaError_t run(const Program& prog, const Lanes* io, const void* mask, void* part,
                         int64_t n, int64_t C, int lanes, int blocks, int segs, int nb,
                         cudaStream_t stream) {
    using A = typename Acc<T>::type;
    if (lanes < 1 || lanes > kThreads || kThreads % lanes != 0 || blocks < 1 || segs < 1 ||
        nb < 1 || nb > kMaxLanes)
      return cudaErrorInvalidValue;
    const size_t smem = cols_smem<T, VEC, ROWS, kCalls>(prog.nfile, lanes);
    cudaError_t err = allow_smem(mr_cols_kernel<T, VEC, ROWS, kCalls>, smem);
    if (err != cudaSuccess) return err;
    mr_cols_kernel<T, VEC, ROWS, kCalls><<<dim3(blocks, nb), kThreads, smem, stream>>>(
        prog, *io, static_cast<const uint8_t*>(mask), static_cast<A*>(part), n, C, lanes, segs);
    err = cudaGetLastError();
    if (err != cudaSuccess || part == nullptr) return err;
    const int64_t cw = (int64_t)(kThreads / lanes) * VEC;
    const unsigned cgrid = (unsigned)((C + kThreads - 1) / kThreads);
    mr_cols_combine_kernel<T><<<dim3(cgrid, nb), kThreads, 0, stream>>>(
        static_cast<const A*>(part), *io, n, C, cw, blocks, segs);
    return cudaGetLastError();
  }
};

struct ColsResident {
  template <typename T, int VEC, int ROWS, bool kCalls>
  static cudaError_t run(int nfile, int lanes, int* blocks_per_sm) {
    const size_t smem = cols_smem<T, VEC, ROWS, kCalls>(nfile, lanes);
    const cudaError_t err = allow_smem(mr_cols_kernel<T, VEC, ROWS, kCalls>, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, mr_cols_kernel<T, VEC, ROWS, kCalls>, kThreads, smem);
  }
};

// ---------------------------------------------------------------------------
// full form
// ---------------------------------------------------------------------------

// Deterministic block sum into thread 0: a shuffle tree in each warp, then
// the warps' sums by a shuffle tree in warp 0.
template <typename A>
__device__ __forceinline__ A block_sum(A s) {
  __shared__ A sh[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? sh[lane] : A(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// One partial sum of fn per block over a grid-stride pass (thread i takes
// packs i, i + stride, ..., ROWS of them a tile); part is (gridDim.x,) in
// the accumulator type.  A grid of one block writes its sum to the output
// itself, in T, and takes no scratch (part null).  blockIdx.y is the batch
// lane b: its input is io.in[b], its output io.out[b] and its partials the
// b-th slice of part.
template <typename T, int VEC, int ROWS, bool kCalls>
__global__ void __launch_bounds__(kThreads, 2)
mr_full_partial_kernel(const __grid_constant__ Program prog, const __grid_constant__ Lanes io,
                       typename Acc<T>::type* __restrict__ part, int64_t N) {
  using A = typename Acc<T>::type;
  constexpr int kTile = ROWS * VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  const File<A, kTile> file{smem};
  const T* __restrict__ x = static_cast<const T*>(io.in[blockIdx.y]);
  A acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = A(0);
  const int64_t nvec = N / VEC;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (tid < nvec)
    fold_packs<T, VEC, ROWS, kCalls>(prog, file, x + tid * VEC, stride * VEC, nullptr, 0, 0,
                                     (nvec - tid + stride - 1) / stride, acc);
  A s = A(0);
#pragma unroll
  for (int v = 0; v < VEC; ++v) s += acc[v];
  // the N % VEC elements past the last whole pack, one a thread, run as a
  // tile whose first value counts
  const int64_t tail = nvec * VEC + tid;
  if (tail < N) {
    A t[kTile];
    const A e = to_acc(x[tail]);
#pragma unroll
    for (int j = 0; j < kTile; ++j) t[j] = e;
    run_program<T, kTile, kCalls>(prog, file, t);
    s += t[0];
  }
  s = block_sum(s);
  if (threadIdx.x != 0) return;
  if (part == nullptr)
    *static_cast<T*>(io.out[blockIdx.y]) = from_acc<T>(s);
  else
    part[(int64_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// One block folds the P partials: thread t takes t, t + kThreads, ... in
// order, then the block sum runs in its fixed order.  Block b folds batch
// lane b's partials into io.out[b].
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr_full_combine_kernel(const typename Acc<T>::type* __restrict__ part,
                       const __grid_constant__ Lanes io, int P) {
  using A = typename Acc<T>::type;
  part += (int64_t)blockIdx.x * P;
  T* __restrict__ out = static_cast<T*>(io.out[blockIdx.x]);
  A s = A(0);
  for (int p = threadIdx.x; p < P; p += kThreads) s += part[p];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = from_acc<T>(s);
}

template <typename T, int VEC, int ROWS, bool kCalls>
size_t full_smem(int nfile) {
  return file_bytes<typename Acc<T>::type, ROWS * VEC>(nfile + (kCalls ? 1 : 0));
}

struct FullLaunch {
  template <typename T, int VEC, int ROWS, bool kCalls>
  static cudaError_t run(const Program& prog, const Lanes* io, void* part, int64_t N, int blocks,
                         int nb, cudaStream_t stream) {
    using A = typename Acc<T>::type;
    if (blocks < 1 || nb < 1 || nb > kMaxLanes || (blocks > 1 && part == nullptr))
      return cudaErrorInvalidValue;
    if (blocks == 1) part = nullptr;   // the one block writes the output
    const size_t smem = full_smem<T, VEC, ROWS, kCalls>(prog.nfile);
    cudaError_t err = allow_smem(mr_full_partial_kernel<T, VEC, ROWS, kCalls>, smem);
    if (err != cudaSuccess) return err;
    mr_full_partial_kernel<T, VEC, ROWS, kCalls><<<dim3(blocks, nb), kThreads, smem, stream>>>(
        prog, *io, static_cast<A*>(part), N);
    err = cudaGetLastError();
    if (err != cudaSuccess || part == nullptr) return err;
    mr_full_combine_kernel<T><<<nb, kThreads, 0, stream>>>(static_cast<const A*>(part), *io,
                                                          blocks);
    return cudaGetLastError();
  }
};

struct FullResident {
  template <typename T, int VEC, int ROWS, bool kCalls>
  static cudaError_t run(int nfile, int /*lanes*/, int* blocks_per_sm) {
    const size_t smem = full_smem<T, VEC, ROWS, kCalls>(nfile);
    const cudaError_t err = allow_smem(mr_full_partial_kernel<T, VEC, ROWS, kCalls>, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, mr_full_partial_kernel<T, VEC, ROWS, kCalls>, kThreads, smem);
  }
};

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// A program the interpreter can run without reading outside its registers.
// (every register the program reads from or stores to the file lies below
// nfile).
bool valid(const Program& p) {
  if (p.n < 0 || p.n > kMaxInstrs || p.nfile < 0 || p.nfile > kRegs) return false;
  if ((p.flags & kStoreX) && p.nfile < 1) return false;
  for (int i = 0; i < p.n; ++i) {
    const Instr& in = p.ins[i];
    const int f = in.flags;
    if (in.op < 0 || in.op >= kNumOps) return false;
    if (((f & kReadA) && !(f & kAPrev) && (in.a < 0 || in.a >= p.nfile)) ||
        ((f & kReadB) && !(f & kBPrev) && (in.b < 0 || in.b >= p.nfile)) ||
        (((f & kReadC) && !(f & kCPrev)) || (f & kStore)) && (in.dst < 0 || in.dst >= p.nfile))
      return false;
  }
  return true;
}

// Whether the program calls into the math library (the kCalls variant).
bool calls(const Program& p) {
  for (int i = 0; i < p.n; ++i) {
    const Instr& in = p.ins[i];
    if (in.op == SIN || in.op == COS || (in.op == POWC && !pow_special(in.k))) return true;
  }
  return false;
}

// F::run for the variant the wrapper picked: vec elements a pack (16 bytes'
// worth, or 1) and rows packs a tile.  16-byte packs come in a wide tile
// (4 rows; 2 for f16/bf16, whose packs hold 8 values) and a tile of half
// its rows; single elements in tiles of 4.  A program that calls the math
// library takes the kCalls variant.
template <typename T, typename F, typename... Args>
cudaError_t variant(int vec, int rows, bool calls, Args... args) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kWide = kVec == 8 ? 2 : 4;
#define BOLT_VARIANT(V, R)                                                             \
  return calls ? F::template run<T, V, R, true>(args...)                               \
               : F::template run<T, V, R, false>(args...)
  if (vec == kVec && rows == kWide) { BOLT_VARIANT(kVec, kWide); }
  if (vec == kVec && rows == kWide / 2) { BOLT_VARIANT(kVec, kWide / 2); }
  if (vec == 1 && rows == 4) { BOLT_VARIANT(1, 4); }
#undef BOLT_VARIANT
  return cudaErrorInvalidValue;
}

// dtype codes shared with bolt_tpu_torch/ops/kernels.py :: _DTYPE_CODE
enum : int { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

template <typename F, typename... Args>
cudaError_t by_dtype(int dtype, int vec, int rows, bool calls, Args... args) {
  switch (dtype) {
    case kF32: return variant<float, F>(vec, rows, calls, args...);
    case kF64: return variant<double, F>(vec, rows, calls, args...);
    case kF16: return variant<__half, F>(vec, rows, calls, args...);
    case kBF16: return variant<__nv_bfloat16, F>(vec, rows, calls, args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// prog: the host Program (copied into the launch's parameters); x:
// contiguous (n, C); mask: n uint8 bytes or null; part: (blocks, segs, cw)
// scratch in the accumulator type, or null when blocks equals the number of
// column blocks (each block then holds one whole and writes out itself);
// out: C elements in x's type.  vec/rows: the variant; lanes: row lanes a
// block; blocks: the grid (at most the row units, so no block is empty).
// Returns cudaGetLastError() after the launches (0 on success).
int bolt_fused_map_reduce_cols(const void* prog, const void* x, const void* mask, void* part,
                               void* out, int64_t n, int64_t C, int lanes, int blocks, int segs,
                               int dtype, int vec, int rows, void* stream) {
  const Program& p = *static_cast<const Program*>(prog);
  if (!valid(p)) return cudaErrorInvalidValue;
  Lanes io{};
  io.in[0] = x;
  io.out[0] = out;
  return by_dtype<ColsLaunch>(dtype, vec, rows, calls(p), p, static_cast<const Lanes*>(&io),
                              mask, part, n, C, lanes, blocks, segs, 1,
                              static_cast<cudaStream_t>(stream));
}

// prog: as above; x: N contiguous elements; part: (blocks,) scratch in the
// accumulator type, or null for a grid of one block; out: one element in
// x's type.
int bolt_fused_map_reduce_full(const void* prog, const void* x, void* part, void* out, int64_t N,
                               int blocks, int dtype, int vec, int rows, void* stream) {
  const Program& p = *static_cast<const Program*>(prog);
  if (!valid(p)) return cudaErrorInvalidValue;
  Lanes io{};
  io.in[0] = x;
  io.out[0] = out;
  return by_dtype<FullLaunch>(dtype, vec, rows, calls(p), p, static_cast<const Lanes*>(&io),
                              part, N, blocks, 1, static_cast<cudaStream_t>(stream));
}

// The batched lanes of the two forms: nb (at most kMaxLanes) bases of one
// shape, each summed by the standalone grid (the wrapper passes the
// standalone plan: blocks, segs, vec and rows exactly as for one base),
// blockIdx.y the lane.  table: the host Lanes of the nb lanes' input and
// output pointers (one output element for the full form, C for the column
// form), copied into the launch's parameters; part: nb slices of the
// standalone scratch, lane after lane, or null where the standalone plan
// takes none.  No mask.
int bolt_fused_map_reduce_cols_lanes(const void* prog, const void* table, int nb, void* part,
                                     int64_t n, int64_t C, int lanes, int blocks, int segs,
                                     int dtype, int vec, int rows, void* stream) {
  const Program& p = *static_cast<const Program*>(prog);
  if (!valid(p) || table == nullptr) return cudaErrorInvalidValue;
  return by_dtype<ColsLaunch>(dtype, vec, rows, calls(p), p, static_cast<const Lanes*>(table),
                              static_cast<const void*>(nullptr), part, n, C, lanes, blocks, segs,
                              nb, static_cast<cudaStream_t>(stream));
}

int bolt_fused_map_reduce_full_lanes(const void* prog, const void* table, int nb, void* part,
                                     int64_t N, int blocks, int dtype, int vec, int rows,
                                     void* stream) {
  const Program& p = *static_cast<const Program*>(prog);
  if (!valid(p) || table == nullptr) return cudaErrorInvalidValue;
  return by_dtype<FullLaunch>(dtype, vec, rows, calls(p), p, static_cast<const Lanes*>(table),
                              part, N, blocks, nb, static_cast<cudaStream_t>(stream));
}

// Blocks of a variant's kernel (form 0: the column form with `lanes` row
// lanes, 1: the full form; calls: the kCalls variant; nfile: the registers
// its program stores) that one SM holds at once, into *blocks_per_sm.
int bolt_map_reduce_resident(int form, int lanes, int dtype, int vec, int rows, int calls,
                             int nfile, int* blocks_per_sm) {
  if (nfile < 0 || nfile > kRegs) return cudaErrorInvalidValue;
  if (form == 0)
    return by_dtype<ColsResident>(dtype, vec, rows, calls != 0, nfile, lanes, blocks_per_sm);
  return by_dtype<FullResident>(dtype, vec, rows, calls != 0, nfile, lanes, blocks_per_sm);
}

// sizeof(Program) and sizeof(Lanes), for the wrapper's check of its ctypes
// mirrors.
int bolt_map_program_bytes() { return (int)sizeof(Program); }
int bolt_map_lanes_bytes() { return (int)sizeof(Lanes); }

}  // extern "C"
