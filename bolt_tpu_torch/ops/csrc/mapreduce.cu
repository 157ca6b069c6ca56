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
//   on entry; the result is the last instruction's.  The program is a kernel parameter passed by value
//   (__grid_constant__, so it is read from the constant bank, never copied
//   to local memory), and every thread runs the same instruction at the
//   same time, so the interpreter's switch does not diverge.  Arithmetic
//   runs in the accumulator type (f32 for f16/bf16) with round-to-nearest
//   intrinsics (no FMA contraction), and f16/bf16 round each arithmetic
//   result to the storage type, as torch does op by op; so + - * / and sqrt
//   give the plain version's values bit for bit.
//   Column form (n, C) -> (C,): the sum over the leading key axes of
//   map(fn).sum().  The plan of moments.cu :: fused_welford: each thread
//   owns VEC neighbouring columns (one 16-byte load a row when the
//   alignment allows), four rows loaded before they are used; row lanes
//   when C is narrower than a block, folded by a fixed tree in shared
//   memory; row chunks over blockIdx.y when the columns alone leave the card
//   idle, each writing its partial sums to scratch for a second kernel that
//   adds them in chunk order.  An optional uint8 record mask (n,) skips
//   (does not load, does not add) every row whose byte is 0, so a dropped
//   record full of NaN leaves the sum finite: filter(...).sum().
//   Full form x -> scalar, the reference's function: a grid-stride pass with
//   16-byte loads, one partial per block folded by a fixed-order tree, then
//   one block folds the partials in order.
//   No atomics anywhere: the result is the same from run to run.
//   Bound on an H100 SXM: the bytes, the input read once over 3.35 TB/s;
//   the program's operations per element are few beside that for the chains
//   it takes.  The interpreter addresses its registers through a switch over
//   the register number, so they stay in hardware registers; a program that
//   calls into the math library (sin, cos, a general pow) takes a variant
//   that loads one element at a time, since the registers live across a call
//   are saved to local memory around it.
// Accumulator: f32 for f16/bf16/f32, f64 for f64; results are written in
// the input's type.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;   // threads per block, a multiple of 32
constexpr int kUnroll = 4;      // rows (or grid strides) loaded ahead
constexpr int kMaxInstrs = 32;  // mapexpr.MAX_INSTRUCTIONS
constexpr int kRegs = 8;        // mapexpr.MAX_REGISTERS

// opcodes, in the order of bolt_tpu_torch/ops/mapexpr.py :: OPS; *C takes
// the constant k as its second operand, RSUBC as its first
enum Op : int {
  MOV, LOADC, ADD, ADDC, SUB, SUBC, RSUBC, MUL, MULC, DIV, DIVC, NEG, ABS, SQRT, RSQRT, EXP,
  LOG, SIN, COS, TANH, SIGMOID, RECIP, POWC, MAX, MIN, CLAMPMINC, CLAMPMAXC, GT, GE, LT, LE,
  EQ, NE, GTC, GEC, LTC, LEC, EQC, NEC, WHERE, kNumOps
};

// Flags of an instruction, set by kernels.py :: _encode from the program's
// data flow: which operands it reads (READ_C: WHERE's condition, from
// r[dst]), which of them is the previous instruction's result (kept in
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
// register file in shared memory must hold.  The result is the last
// instruction's (the element itself for n == 0).
struct Program {
  int32_t n, flags, nfile, pad;
  Instr ins[kMaxInstrs];
};

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

// a ** k by torch's special cases of the exponent (pow_tensor_scalar); any
// other exponent calls pow, which only the kCalls variant compiles (the
// wrapper picks that variant for such a program).
template <bool kCalls, typename A> __device__ __forceinline__ A powc(A a, A k) {
  if (k == A(2)) return mul_(a, a);
  if (k == A(3)) return mul_(mul_(a, a), a);
  if (k == A(0.5)) return sqrt_(a);
  if (k == A(-0.5)) return rsqrt_(a);
  if (k == A(-1)) return div_(A(1), a);
  if (k == A(-2)) return div_(A(1), mul_(a, a));
  if constexpr (kCalls) return pow_(a, k);
  return a;
}

// The program on VEC elements of one row (or pack): x holds the elements on
// entry and fn's values on exit.  file is this thread's part of the register
// file in shared memory: register r's VEC values at file + r * kFileStride.
// Each instruction reads its operands from the file, or from the previous
// result when its flags say so, and stores its result only when a later
// instruction needs it; so a chain such as v * 2 + 1 never touches the file.
// kCalls compiles the ops that call into the math library (sin, cos, pow of
// a general exponent): a call makes the compiler save the live registers
// around it, so the variant without them keeps its loop in registers.
constexpr int kFileStride = kThreads;   // packs of VEC values a register

template <typename T, int VEC, bool kCalls>
__device__ __forceinline__ void run_program(const Program& p, typename Acc<T>::type* file,
                                            typename Acc<T>::type (&x)[VEC]) {
  using A = typename Acc<T>::type;
  if (p.n == 0) return;
  if (p.flags & kStoreX) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) file[v] = x[v];
  }
  A prev[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) prev[v] = x[v];
  for (int i = 0; i < p.n; ++i) {
    const Instr in = p.ins[i];
    const int f = in.flags;
    const A k = A(in.k);
    A a[VEC], b[VEC], d[VEC];
#define BOLT_OPERAND(dst, read, fwd, reg)                                         \
  if (f & (read)) {                                                               \
    const A* src = file + (reg) * kFileStride * VEC;                              \
    _Pragma("unroll") for (int v = 0; v < VEC; ++v) dst[v] = (f & (fwd)) ? prev[v] : src[v]; \
  }
    BOLT_OPERAND(a, kReadA, kAPrev, in.a)
    BOLT_OPERAND(b, kReadB, kBPrev, in.b)
    BOLT_OPERAND(d, kReadC, kCPrev, in.dst)
#undef BOLT_OPERAND
#define BOLT_EACH(expr) \
  _Pragma("unroll") for (int v = 0; v < VEC; ++v) d[v] = (expr); \
  break
#define BOLT_ARITH(expr) BOLT_EACH(rnd<T>(expr))
    switch (in.op) {
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
        if constexpr (kCalls) { BOLT_ARITH(sin_(a[v])); }
        break;
      case COS:
        if constexpr (kCalls) { BOLT_ARITH(cos_(a[v])); }
        break;
      case TANH: BOLT_ARITH(tanh_(a[v]));
      case SIGMOID: BOLT_ARITH(div_(A(1), add_(A(1), exp_(-a[v]))));
      case RECIP: BOLT_ARITH(div_(A(1), a[v]));
      case POWC: BOLT_ARITH((powc<kCalls, A>(a[v], k)));
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
      case WHERE: BOLT_EACH(d[v] != A(0) ? a[v] : b[v]);
      default: break;
    }
#undef BOLT_ARITH
#undef BOLT_EACH
    if (f & kStore) {
      A* dst = file + in.dst * kFileStride * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) dst[v] = d[v];
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) prev[v] = d[v];
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) x[v] = prev[v];
}

// This thread's part of the register file, which starts the block's dynamic
// shared memory.
template <typename A, int VEC>
__device__ __forceinline__ A* thread_file() {
  extern __shared__ __align__(16) unsigned char smem[];
  return reinterpret_cast<A*>(smem) + threadIdx.x * VEC;
}

// Bytes of dynamic shared memory the register file of p takes.
template <typename A, int VEC>
size_t file_bytes(const Program& p) {
  return sizeof(A) * VEC * kFileStride * (size_t)p.nfile;
}

__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }

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

// fn applied to a loaded pack, added to acc.
template <typename T, int VEC, bool kCalls>
__device__ __forceinline__ void fold(const Program& p, typename Acc<T>::type* file,
                                     const T (&pack)[VEC], typename Acc<T>::type (&acc)[VEC]) {
  typename Acc<T>::type v[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = to_acc(pack[j]);
  run_program<T, VEC, kCalls>(p, file, v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] += v[j];
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

// Partial column sums of fn over rows [blockIdx.y * rpc, min(n, (blockIdx.y
// + 1) * rpc)), skipping rows whose mask byte is 0 (mask may be null); lane l
// walks rows r0 + l, r0 + l + lanes, ...  part is (R, C) in the accumulator
// type.
template <typename T, int VEC, bool kCalls>
__global__ void __launch_bounds__(kThreads)
mr_cols_partial_kernel(const __grid_constant__ Program prog, const T* __restrict__ x,
                       const uint8_t* __restrict__ mask, typename Acc<T>::type* __restrict__ part,
                       int64_t n, int64_t C, int64_t rpc, int lanes) {
  using A = typename Acc<T>::type;
  const int width = kThreads / lanes;
  const int lane = threadIdx.x / width;
  const int64_t col = ((int64_t)blockIdx.x * width + threadIdx.x % width) * VEC;
  const bool active = col < C;   // idle threads still join combine_lanes
  const int64_t r0 = (int64_t)blockIdx.y * rpc;
  const int64_t r1 = imin64(n, r0 + rpc);
  A* file = thread_file<A, VEC>();

  A acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = A(0);
  if (active) {
    const int64_t step = (int64_t)lanes * C;
    const T* p = x + (r0 + lane) * C + col;
    int64_t r = r0 + lane;
    for (; r + (int64_t)(kUnroll - 1) * lanes < r1; r += (int64_t)kUnroll * lanes) {
      T buf[kUnroll][VEC];
      bool keep[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        keep[u] = mask == nullptr || mask[r + (int64_t)u * lanes] != 0;
        if (keep[u]) load_pack<T, VEC>(p + (int64_t)u * step, buf[u]);
      }
      p += (int64_t)kUnroll * step;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (keep[u]) fold<T, VEC, kCalls>(prog, file, buf[u], acc);
    }
    for (; r < r1; r += lanes) {   // the lane's rows past its last group of kUnroll
      if (mask == nullptr || mask[r] != 0) {
        T b[VEC];
        load_pack<T, VEC>(p, b);
        fold<T, VEC, kCalls>(prog, file, b, acc);
      }
      p += step;
    }
  }
  if (lanes > 1) __syncthreads();   // the lanes' scratch reuses the register file
  combine_lanes<A, VEC>(acc, lanes);
  if (!active || lane != 0) return;
  A* out = part + (int64_t)blockIdx.y * C + col;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out[v] = acc[v];
}

// out[c] = the R partials of column c added in chunk order, in T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr_cols_combine_kernel(const typename Acc<T>::type* __restrict__ part, T* __restrict__ out,
                       int64_t C, int R) {
  using A = typename Acc<T>::type;
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= C) return;
  A s = A(0);
  for (int r = 0; r < R; ++r) s += part[(int64_t)r * C + col];
  out[col] = from_acc<T>(s);
}

template <typename T, int VEC, bool kCalls>
cudaError_t launch_cols(const Program& prog, const void* x, const void* mask, void* part,
                        void* out, int64_t n, int64_t C, int64_t rpc, int R, int lanes,
                        cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (lanes < 1 || lanes > kThreads || kThreads % lanes != 0 || R < 1)
    return cudaErrorInvalidValue;
  const int64_t groups = (C + VEC - 1) / VEC;
  const int64_t width = kThreads / lanes;
  dim3 grid((unsigned)((groups + width - 1) / width), (unsigned)R);
  const size_t lane_bytes = lanes > 1 ? sizeof(A) * VEC * (kThreads / 2) : 0;
  const size_t smem = std::max(lane_bytes, file_bytes<A, VEC>(prog));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(mr_cols_partial_kernel<T, VEC, kCalls>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  mr_cols_partial_kernel<T, VEC, kCalls><<<grid, kThreads, smem, stream>>>(
      prog, static_cast<const T*>(x), static_cast<const uint8_t*>(mask), static_cast<A*>(part),
      n, C, rpc, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned cgrid = (unsigned)((C + kThreads - 1) / kThreads);
  mr_cols_combine_kernel<T><<<cgrid, kThreads, 0, stream>>>(static_cast<const A*>(part),
                                                           static_cast<T*>(out), C, R);
  return cudaGetLastError();
}

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

// One partial sum of fn per block over a grid-stride pass; part is
// (gridDim.x,) in the accumulator type.
template <typename T, int VEC, bool kCalls>
__global__ void __launch_bounds__(kThreads)
mr_full_partial_kernel(const __grid_constant__ Program prog, const T* __restrict__ x,
                       typename Acc<T>::type* __restrict__ part, int64_t N) {
  using A = typename Acc<T>::type;
  A* file = thread_file<A, VEC>();
  A acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = A(0);
  const int64_t nvec = N / VEC;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    T buf[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_pack<T, VEC>(x + (i + u * stride) * VEC, buf[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fold<T, VEC, kCalls>(prog, file, buf[u], acc);
  }
  for (; i < nvec; i += stride) {
    T b[VEC];
    load_pack<T, VEC>(x + i * VEC, b);
    fold<T, VEC, kCalls>(prog, file, b, acc);
  }
  A s = A(0);
#pragma unroll
  for (int v = 0; v < VEC; ++v) s += acc[v];
  // the N % VEC elements past the last whole pack, one a thread, run as a
  // pack whose first value counts
  const int64_t tail = nvec * VEC + tid;
  if (tail < N) {
    T pk[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) pk[j] = x[tail];
    A v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_acc(pk[j]);
    run_program<T, VEC, kCalls>(prog, file, v);
    s += v[0];
  }
  s = block_sum(s);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// One block folds the P partials: thread t takes t, t + kThreads, ... in
// order, then the block sum runs in its fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mr_full_combine_kernel(const typename Acc<T>::type* __restrict__ part, T* __restrict__ out,
                       int P) {
  using A = typename Acc<T>::type;
  A s = A(0);
  for (int p = threadIdx.x; p < P; p += kThreads) s += part[p];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = from_acc<T>(s);
}

template <typename T, int VEC, bool kCalls>
cudaError_t launch_full(const Program& prog, const void* x, void* part, void* out, int64_t N,
                        int blocks, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (blocks < 1) return cudaErrorInvalidValue;
  const size_t smem = file_bytes<A, VEC>(prog);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(mr_full_partial_kernel<T, VEC, kCalls>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  mr_full_partial_kernel<T, VEC, kCalls><<<blocks, kThreads, smem, stream>>>(
      prog, static_cast<const T*>(x), static_cast<A*>(part), N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mr_full_combine_kernel<T><<<1, kThreads, 0, stream>>>(static_cast<const A*>(part),
                                                       static_cast<T*>(out), blocks);
  return cudaGetLastError();
}

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
    if (in.op == SIN || in.op == COS) return true;
    if (in.op == POWC && in.k != 2 && in.k != 3 && in.k != 0.5 && in.k != -0.5 &&
        in.k != -1 && in.k != -2)
      return true;
  }
  return false;
}

// The kCalls variant loads one element at a time (its registers spill
// around the calls anyway), so it is built for vec == 1 only.
template <typename T>
cudaError_t dispatch_cols(int vec, const Program& prog, const void* x, const void* mask,
                          void* part, void* out, int64_t n, int64_t C, int64_t rpc, int R,
                          int lanes, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (calls(prog)) {
    if (vec != 1) return cudaErrorInvalidValue;
    return launch_cols<T, 1, true>(prog, x, mask, part, out, n, C, rpc, R, lanes, s);
  }
  if (vec == kVec)
    return launch_cols<T, kVec, false>(prog, x, mask, part, out, n, C, rpc, R, lanes, s);
  if (vec == 1) return launch_cols<T, 1, false>(prog, x, mask, part, out, n, C, rpc, R, lanes, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_full(int vec, const Program& prog, const void* x, void* part, void* out,
                          int64_t N, int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (calls(prog)) {
    if (vec != 1) return cudaErrorInvalidValue;
    return launch_full<T, 1, true>(prog, x, part, out, N, blocks, s);
  }
  if (vec == kVec) return launch_full<T, kVec, false>(prog, x, part, out, N, blocks, s);
  if (vec == 1) return launch_full<T, 1, false>(prog, x, part, out, N, blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with bolt_tpu_torch/ops/kernels.py :: _DTYPE_CODE
enum : int { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

extern "C" {

// prog: the host Program (copied into the launch's parameters); x:
// contiguous (n, C); mask: n uint8 bytes or null; part: (R, C) scratch in the
// accumulator type; out: C elements in x's type.  Returns cudaGetLastError()
// after the launches (0 on success).
int bolt_fused_map_reduce_cols(const void* prog, const void* x, const void* mask, void* part,
                               void* out, int64_t n, int64_t C, int64_t rpc, int R, int lanes,
                               int dtype, int vec, void* stream) {
  const Program& p = *static_cast<const Program*>(prog);
  if (!valid(p)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_cols<float>(vec, p, x, mask, part, out, n, C, rpc, R, lanes, s);
    case kF64: return dispatch_cols<double>(vec, p, x, mask, part, out, n, C, rpc, R, lanes, s);
    case kF16: return dispatch_cols<__half>(vec, p, x, mask, part, out, n, C, rpc, R, lanes, s);
    case kBF16:
      return dispatch_cols<__nv_bfloat16>(vec, p, x, mask, part, out, n, C, rpc, R, lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// prog: as above; x: N contiguous elements; part: (blocks,) scratch in the
// accumulator type; out: one element in x's type.
int bolt_fused_map_reduce_full(const void* prog, const void* x, void* part, void* out, int64_t N,
                               int blocks, int dtype, int vec, void* stream) {
  const Program& p = *static_cast<const Program*>(prog);
  if (!valid(p)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_full<float>(vec, p, x, part, out, N, blocks, s);
    case kF64: return dispatch_full<double>(vec, p, x, part, out, N, blocks, s);
    case kF16: return dispatch_full<__half>(vec, p, x, part, out, N, blocks, s);
    case kBF16: return dispatch_full<__nv_bfloat16>(vec, p, x, part, out, N, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// sizeof(Program), for the wrapper's check of its ctypes mirror.
int bolt_map_program_bytes() { return (int)sizeof(Program); }

}  // extern "C"
