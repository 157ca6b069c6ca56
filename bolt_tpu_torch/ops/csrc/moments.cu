// One-pass moment kernels for Hopper (sm_90a), bound with ctypes through a
// plain C interface (bolt_tpu_torch/ops/_build.py builds this file with nvcc,
// bolt_tpu_torch/ops/kernels.py holds the wrappers and their plain PyTorch
// versions).
//
// bolt_fused_welford replaces the Pallas kernel bolt_tpu/ops/kernels.py ::
// fused_welford (_welford_kernel, welford_plan).  It computes, for a
// contiguous (n, C) matrix, the column-wise (mean, m2, min, max) with
// m2 = sum of squared deviations, in ONE read of device memory; given a
// sum output it also computes the column sum in the same read (the SUM
// instantiation, a compile-time flag: without it no sum is carried and
// the code is that of the four moments alone).
//   Bound on an H100 SXM: the bytes, n*C*sizeof(T) read once (plus 4*C
//   outputs, 5*C with the sum) over 3.35 TB/s; the arithmetic (8
//   operations an element, 9 with the sum) is far below the 67 TFLOP/s
//   f32 rate.
//   Design: each thread owns VEC neighbouring columns and walks its rows
//   with a Welford update in registers, so neighbouring threads read
//   neighbouring addresses and every load is 16 bytes when the wrapper
//   allows it; four rows are loaded before they are used, which keeps
//   enough bytes in flight to cover the memory latency.  When C is too
//   narrow to fill the card the rows split into R chunks over blockIdx.y;
//   each chunk writes its partial moments to scratch and a second kernel
//   Chan-combines the R partials.  When C is narrower than a block, the
//   block's threads also split the chunk's rows into row lanes, which fold
//   into one state by a tree in shared memory; the combining kernel folds
//   its partials the same way.  No atomics, and every fold has a fixed
//   order: the result is the same from run to run.
//   The sum: each thread adds its lane's rows in row order, kUnroll rows
//   at a time as a pairwise block ((x0 + x1) + (x2 + x3)) and each block
//   into its running sum, so the running sum takes a quarter of the
//   roundings of a row-by-row one at the same adds and registers (a
//   compensated running sum spills at five blocks an SM: 4.86 against
//   3.89 ms at the north-star on an H100); the row lanes fold by the same
//   tree as the moments, and the combining kernel adds the chunks'
//   partial sums with Kahan's compensation in chunk order (lane l takes
//   chunks l, l + lanes, ..., then the tree), so the sum is the same from
//   run to run.  Callers: gpu/stats.py's stats() takes the instantiation without
//   the sum; gpu/array.py :: _chain_stats takes the SUM one for a stat
//   group's (or a lone terminal's) key-axis sum/mean/var/std/min/max of
//   a resident f32/f64 base, one launch for all of them.
//
// bolt_fused_stats replaces bolt_tpu/ops/kernels.py :: fused_stats
// (_stats_kernel).  It computes (sum, sum of squares, min, max) over every
// element.
//   Bound: N*sizeof(T) bytes read once over 3.35 TB/s.
//   Design: a grid-stride pass with 16-byte loads writes one partial per
//   block; a second one-block kernel folds the partials in a fixed order.
//   The grid size is fixed by the wrapper, so the order is too.
//
// Both accumulate in f32 for f32/f16/bf16 and in f64 for f64, and write
// their results in the input's type.  min/max propagate NaN like
// jnp.min/jnp.max (fminf/fmaxf would drop it).

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // threads per block, a multiple of 32
constexpr int kUnroll = 4;      // rows (or grid strides) loaded ahead

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

template <typename A> __device__ __forceinline__ A pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

// NaN-propagating min/max: once either side is NaN the result is NaN.
template <typename A> __device__ __forceinline__ A nan_min(A a, A b) {
  return (b < a || b != b) ? b : a;
}
template <typename A> __device__ __forceinline__ A nan_max(A a, A b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }

// sum <- sum + x with Kahan's compensation comp (the low-order part the
// last additions lost, with the opposite sign).  Where the compensation
// is not finite (an infinity or a NaN met, or the sum overflowed) it is
// dropped, so the sum reads as a plain sum would: inf - inf in the
// compensation must not turn an infinite sum into NaN.
template <typename A>
__device__ __forceinline__ void kahan_add(A& sum, A& comp, A x) {
  const A y = x - comp;
  const A t = sum + y;
  const A c = (t - sum) - y;
  comp = (c < pos_inf<A>() && c > -pos_inf<A>()) ? c : A(0);   // NaN: false
  sum = t;
}

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

// ---------------------------------------------------------------------------
// fused_welford
// ---------------------------------------------------------------------------

// One Welford state: the count of values folded in, their mean, m2 (sum of
// squared deviations), min and max.
template <typename A>
struct Moments {
  A n, mean, m2, mn, mx;
};

template <typename A>
__device__ __forceinline__ Moments<A> empty_moments() {
  return {A(0), A(0), A(0), pos_inf<A>(), -pos_inf<A>()};
}

// Chan's combine a <- a (+) b.  An empty b leaves a's moments as they are;
// an empty a takes b's as they are (so d * d, which overflows once |d|
// passes sqrt of the largest finite value, never meets a zero weight:
// inf * 0 would make m2 NaN).
template <typename A>
__device__ __forceinline__ void chan(Moments<A>& a, const Moments<A>& b) {
  if (b.n > A(0) && a.n == A(0)) {
    a.n = b.n;
    a.mean = b.mean;
    a.m2 = b.m2;
  } else if (b.n > A(0)) {
    const A tot = a.n + b.n;
    const A d = b.mean - a.mean;
    a.mean += d * (b.n / tot);
    a.m2 += b.m2 + d * d * (a.n * b.n / tot);
    a.n = tot;
  }
  a.mn = nan_min(a.mn, b.mn);
  a.mx = nan_max(a.mx, b.mx);
}

// The block's threads form `lanes` row lanes of kThreads / lanes column
// threads each (thread t: column thread t % (kThreads / lanes), lane
// t / (kThreads / lanes)).  Folds every lane's VEC states into lane 0 by a
// tree in a fixed order, so the result is the same from run to run.  At
// each step the upper half of the remaining lanes hands its states to the
// lower half through dynamic shared memory of combine_smem<A, VEC, SUM>(lanes)
// bytes.  With SUM the lanes' VEC sums tot fold by the same tree.
template <typename A, int VEC, bool SUM>
constexpr size_t combine_smem(int lanes) {
  return lanes > 1 ? size_t(SUM ? 6 : 5) * VEC * (kThreads / 2) * sizeof(A) : 0;
}

template <typename A, int VEC, bool SUM>
__device__ __forceinline__ void combine_lanes(Moments<A> (&m)[VEC], A (&tot)[VEC], int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  A* sh = reinterpret_cast<A*>(smem);
  constexpr int kHalf = kThreads / 2;
  constexpr int kFields = SUM ? 6 : 5;
  const int t = threadIdx.x;
  const int width = kThreads / lanes;
  const int lane = t / width;
  for (int s = lanes / 2; s > 0; s >>= 1) {
    if (lane >= s && lane < 2 * s) {
      const int i = t - s * width;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        A* q = sh + v * kFields * kHalf + i;
        q[0] = m[v].n;
        q[kHalf] = m[v].mean;
        q[2 * kHalf] = m[v].m2;
        q[3 * kHalf] = m[v].mn;
        q[4 * kHalf] = m[v].mx;
        if constexpr (SUM) q[5 * kHalf] = tot[v];
      }
    }
    __syncthreads();
    if (lane < s) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const A* q = sh + v * kFields * kHalf + t;
        const Moments<A> b = {q[0], q[kHalf], q[2 * kHalf], q[3 * kHalf], q[4 * kHalf]};
        chan(m[v], b);
        if constexpr (SUM) tot[v] += q[5 * kHalf];
      }
    }
    __syncthreads();
  }
}

// Blocks an SM the f32 SUM instantiation is held to.  Its sum's extra
// registers (58 unbounded) would leave four blocks an SM where the
// instantiation without the sum holds five (48): 4.18 against 3.77 ms at
// the north-star's (3200, 819200) on an H100.  The bound spills a few
// registers, which costs more than it saves only on narrow plans with row
// lanes ((8388608, 64): 0.81 against 0.76 ms).  0 leaves every other
// instantiation unbounded: the one without the sum compiles to the same
// code as with no minimum named.
template <typename T, bool SUM>
constexpr int partial_min_blocks() {
  return SUM && std::is_same<T, float>::value ? 5 : 0;
}

// Partial moments of rows [blockIdx.y * rpc, min(n, (blockIdx.y + 1) * rpc))
// for VEC columns per column thread; lane l of the block walks rows
// r0 + l, r0 + l + lanes, ..., so a warp reads whole neighbouring rows when
// C is narrow.  part is (R, 4, C) in the accumulator type, (R, 5, C) with
// SUM (the chunk's column sums last).
template <typename T, int VEC, bool SUM>
__global__ void __launch_bounds__(kThreads, (partial_min_blocks<T, SUM>()))
welford_partial_kernel(const T* __restrict__ x, typename Acc<T>::type* __restrict__ part,
                       int64_t n, int64_t C, int64_t rpc, int lanes) {
  using A = typename Acc<T>::type;
  constexpr int kFields = SUM ? 5 : 4;
  const int width = kThreads / lanes;
  const int lane = threadIdx.x / width;
  const int64_t col = ((int64_t)blockIdx.x * width + threadIdx.x % width) * VEC;
  const bool active = col < C;   // idle threads still join combine_lanes
  const int64_t r0 = (int64_t)blockIdx.y * rpc;
  const int64_t r1 = imin64(n, r0 + rpc);

  A mean[VEC], m2[VEC], mn[VEC], mx[VEC], tot[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mean[v] = A(0);
    m2[v] = A(0);
    mn[v] = pos_inf<A>();
    mx[v] = -pos_inf<A>();
    tot[v] = A(0);
  }
  int64_t k = 0;   // rows folded in so far
  if (active) {
    const int64_t step = (int64_t)lanes * C;
    const T* p = x + (r0 + lane) * C + col;
    int64_t r = r0 + lane;
    for (; r + (int64_t)(kUnroll - 1) * lanes < r1; r += (int64_t)kUnroll * lanes) {
      T buf[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_pack<T, VEC>(p + (int64_t)u * step, buf[u]);
      p += (int64_t)kUnroll * step;
      if constexpr (SUM) {
        // first, so no row's registers live on for the sum's sake
        static_assert(kUnroll == 4, "the sum's block is a pairwise sum of four rows");
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          tot[v] += (to_acc(buf[0][v]) + to_acc(buf[1][v])) +
                    (to_acc(buf[2][v]) + to_acc(buf[3][v]));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ++k;
        const A inv = A(1) / A(k);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const A xv = to_acc(buf[u][v]);
          const A d = xv - mean[v];
          mean[v] += d * inv;
          m2[v] += d * (xv - mean[v]);
          mn[v] = nan_min(mn[v], xv);
          mx[v] = nan_max(mx[v], xv);
        }
      }
    }
    for (; r < r1; r += lanes) {   // the lane's rows past its last group of kUnroll
      T b[VEC];
      load_pack<T, VEC>(p, b);
      p += step;
      ++k;
      const A inv = A(1) / A(k);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const A xv = to_acc(b[v]);
        const A d = xv - mean[v];
        mean[v] += d * inv;
        m2[v] += d * (xv - mean[v]);
        mn[v] = nan_min(mn[v], xv);
        mx[v] = nan_max(mx[v], xv);
        if constexpr (SUM) tot[v] += xv;
      }
    }
  }
  Moments<A> m[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) m[v] = {A(k), mean[v], m2[v], mn[v], mx[v]};
  combine_lanes<A, VEC, SUM>(m, tot, lanes);
  if (!active || lane != 0) return;
  A* out = part + (int64_t)blockIdx.y * kFields * C + col;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    out[v] = m[v].mean;
    out[C + v] = m[v].m2;
    out[2 * C + v] = m[v].mn;
    out[3 * C + v] = m[v].mx;
    if constexpr (SUM) out[4 * C + v] = tot[v];
  }
}

// Chan combine of the R partials of each column (chunk r holds
// min(rpc, n - r * rpc) rows): lane l folds chunks l, l + lanes, ... in
// order, then the lanes fold into lane 0 by the fixed tree; with SUM the
// chunks' sums are added in the same order, compensated.  sum_out comes last so that
// the instantiation without SUM keeps its parameters where they were.
template <typename T, bool SUM>
__global__ void __launch_bounds__(kThreads)
welford_combine_kernel(const typename Acc<T>::type* __restrict__ part, T* __restrict__ mu_out,
                       T* __restrict__ m2_out, T* __restrict__ mn_out, T* __restrict__ mx_out,
                       int64_t n, int64_t C, int64_t rpc, int R, int lanes,
                       T* __restrict__ sum_out) {
  using A = typename Acc<T>::type;
  constexpr int kFields = SUM ? 5 : 4;
  const int width = kThreads / lanes;
  const int lane = threadIdx.x / width;
  const int64_t col = (int64_t)blockIdx.x * width + threadIdx.x % width;
  const bool active = col < C;
  Moments<A> m[1] = {empty_moments<A>()};
  A tot[1] = {A(0)};
  A comp = A(0);
  if (active) {
    for (int r = lane; r < R; r += lanes) {
      const A* q = part + (int64_t)r * kFields * C + col;
      const Moments<A> b = {A(imin64(rpc, n - (int64_t)r * rpc)), q[0], q[C], q[2 * C],
                            q[3 * C]};
      chan(m[0], b);
      if constexpr (SUM) kahan_add(tot[0], comp, q[4 * C]);
    }
    if constexpr (SUM) tot[0] -= comp;
  }
  combine_lanes<A, 1, SUM>(m, tot, lanes);
  if (!active || lane != 0) return;
  mu_out[col] = from_acc<T>(m[0].mean);
  m2_out[col] = from_acc<T>(m[0].m2);
  mn_out[col] = from_acc<T>(m[0].mn);
  mx_out[col] = from_acc<T>(m[0].mx);
  if constexpr (SUM) sum_out[col] = from_acc<T>(tot[0]);
}

// Row lanes of the combining kernel: enough that no lane folds more than a
// few partials, while a warp still spans 8 columns.
inline int combine_lanes_for(int R) {
  int lanes = 1;
  while (lanes < R && lanes < kThreads / 8) lanes <<= 1;
  return lanes;
}

template <typename T, int VEC, bool SUM>
cudaError_t launch_welford(const void* x, void* part, void* mu, void* m2, void* mn, void* mx,
                           void* sum, int64_t n, int64_t C, int64_t rpc, int R, int lanes,
                           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (lanes < 1 || lanes > kThreads || kThreads % lanes != 0) return cudaErrorInvalidValue;
  const int64_t groups = (C + VEC - 1) / VEC;
  const int64_t width = kThreads / lanes;
  dim3 grid((unsigned)((groups + width - 1) / width), (unsigned)R);
  welford_partial_kernel<T, VEC, SUM><<<grid, kThreads, combine_smem<A, VEC, SUM>(lanes),
                                        stream>>>(
      static_cast<const T*>(x), static_cast<A*>(part), n, C, rpc, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int clanes = combine_lanes_for(R);
  const int64_t cwidth = kThreads / clanes;
  const unsigned cgrid = (unsigned)((C + cwidth - 1) / cwidth);
  welford_combine_kernel<T, SUM><<<cgrid, kThreads, combine_smem<A, 1, SUM>(clanes), stream>>>(
      static_cast<const A*>(part), static_cast<T*>(mu), static_cast<T*>(m2),
      static_cast<T*>(mn), static_cast<T*>(mx), n, C, rpc, R, clanes, static_cast<T*>(sum));
  return cudaGetLastError();
}

// The SUM instantiation when a sum output is given, else the one without.
template <typename T>
cudaError_t dispatch_welford(int vec, const void* x, void* part, void* mu, void* m2, void* mn,
                             void* mx, void* sum, int64_t n, int64_t C, int64_t rpc, int R,
                             int lanes, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec != kVec && vec != 1) return cudaErrorInvalidValue;
  if (sum != nullptr) {
    return vec == kVec
        ? launch_welford<T, kVec, true>(x, part, mu, m2, mn, mx, sum, n, C, rpc, R, lanes, s)
        : launch_welford<T, 1, true>(x, part, mu, m2, mn, mx, sum, n, C, rpc, R, lanes, s);
  }
  return vec == kVec
      ? launch_welford<T, kVec, false>(x, part, mu, m2, mn, mx, sum, n, C, rpc, R, lanes, s)
      : launch_welford<T, 1, false>(x, part, mu, m2, mn, mx, sum, n, C, rpc, R, lanes, s);
}

// ---------------------------------------------------------------------------
// fused_stats
// ---------------------------------------------------------------------------

// Deterministic block reduction of (sum, sumsq, min, max) into thread 0.
template <typename A>
__device__ __forceinline__ void block_reduce4(A& s, A& sq, A& mn, A& mx) {
  __shared__ A sh[4][kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    sq += __shfl_down_sync(0xffffffffu, sq, off);
    mn = nan_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][warp] = s;
    sh[1][warp] = sq;
    sh[2][warp] = mn;
    sh[3][warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    const bool live = lane < nwarps;
    s = live ? sh[0][lane] : A(0);
    sq = live ? sh[1][lane] : A(0);
    mn = live ? sh[2][lane] : pos_inf<A>();
    mx = live ? sh[3][lane] : -pos_inf<A>();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
      sq += __shfl_down_sync(0xffffffffu, sq, off);
      mn = nan_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
      mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    }
  }
}

template <typename A>
__device__ __forceinline__ void fold(A xv, A& s, A& sq, A& mn, A& mx) {
  s += xv;
  sq += xv * xv;
  mn = nan_min(mn, xv);
  mx = nan_max(mx, xv);
}

// One partial (sum, sumsq, min, max) per block; part is (gridDim.x, 4).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const T* __restrict__ x, typename Acc<T>::type* __restrict__ part,
                     int64_t N) {
  using A = typename Acc<T>::type;
  A s = A(0), sq = A(0), mn = pos_inf<A>(), mx = -pos_inf<A>();
  const int64_t nvec = N / VEC;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    T buf[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_pack<T, VEC>(x + (i + u * stride) * VEC, buf[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) fold(to_acc(buf[u][v]), s, sq, mn, mx);
  }
  for (; i < nvec; i += stride) {
    T b[VEC];
    load_pack<T, VEC>(x + i * VEC, b);
#pragma unroll
    for (int v = 0; v < VEC; ++v) fold(to_acc(b[v]), s, sq, mn, mx);
  }
  // the N % VEC elements past the last whole pack
  const int64_t tail = nvec * VEC + tid;
  if (tail < N) fold(to_acc(x[tail]), s, sq, mn, mx);
  block_reduce4(s, sq, mn, mx);
  if (threadIdx.x == 0) {
    A* out = part + (int64_t)blockIdx.x * 4;
    out[0] = s;
    out[1] = sq;
    out[2] = mn;
    out[3] = mx;
  }
}

// One block folds the P partials: thread t takes t, t + kThreads, ... in
// order, then the block reduction runs in its fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_combine_kernel(const typename Acc<T>::type* __restrict__ part, T* __restrict__ out,
                     int P) {
  using A = typename Acc<T>::type;
  A s = A(0), sq = A(0), mn = pos_inf<A>(), mx = -pos_inf<A>();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const A* q = part + (int64_t)p * 4;
    s += q[0];
    sq += q[1];
    mn = nan_min(mn, q[2]);
    mx = nan_max(mx, q[3]);
  }
  block_reduce4(s, sq, mn, mx);
  if (threadIdx.x == 0) {
    out[0] = from_acc<T>(s);
    out[1] = from_acc<T>(sq);
    out[2] = from_acc<T>(mn);
    out[3] = from_acc<T>(mx);
  }
}

template <typename T, int VEC>
cudaError_t launch_stats(const void* x, void* part, void* out, int64_t N, int blocks,
                         cudaStream_t stream) {
  using A = typename Acc<T>::type;
  stats_partial_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<A*>(part), N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_combine_kernel<T><<<1, kThreads, 0, stream>>>(static_cast<const A*>(part),
                                                      static_cast<T*>(out), blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_stats(int vec, const void* x, void* part, void* out, int64_t N,
                           int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) return launch_stats<T, kVec>(x, part, out, N, blocks, s);
  if (vec == 1) return launch_stats<T, 1>(x, part, out, N, blocks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes shared with bolt_tpu_torch/ops/kernels.py :: _DTYPE_CODE
enum : int { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

extern "C" {

// x: contiguous (n, C); part: (R, 4, C) scratch in the accumulator type,
// (R, 5, C) when sum is given; mu/m2/mn/mx: C outputs in x's type; sum: C
// outputs in x's type, or null for none.  Returns cudaGetLastError() after
// the launches (0 on success).
int bolt_fused_welford(const void* x, void* part, void* mu, void* m2, void* mn, void* mx,
                       void* sum, int64_t n, int64_t C, int64_t rpc, int R, int lanes,
                       int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_welford<float>(vec, x, part, mu, m2, mn, mx, sum, n, C, rpc, R, lanes, s);
    case kF64:
      return dispatch_welford<double>(vec, x, part, mu, m2, mn, mx, sum, n, C, rpc, R, lanes,
                                      s);
    case kF16:
      return dispatch_welford<__half>(vec, x, part, mu, m2, mn, mx, sum, n, C, rpc, R, lanes,
                                      s);
    case kBF16:
      return dispatch_welford<__nv_bfloat16>(vec, x, part, mu, m2, mn, mx, sum, n, C, rpc, R,
                                             lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: N contiguous elements; part: (blocks, 4) scratch in the accumulator
// type; out: 4 elements (sum, sumsq, min, max) in x's type.
int bolt_fused_stats(const void* x, void* part, void* out, int64_t N, int blocks, int dtype,
                     int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_stats<float>(vec, x, part, out, N, blocks, s);
    case kF64: return dispatch_stats<double>(vec, x, part, out, N, blocks, s);
    case kF16: return dispatch_stats<__half>(vec, x, part, out, N, blocks, s);
    case kBF16: return dispatch_stats<__nv_bfloat16>(vec, x, part, out, N, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
