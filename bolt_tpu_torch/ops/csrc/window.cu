// Window (1-d correlation) kernels for Hopper (sm_90a), bound with ctypes
// through a plain C interface (bolt_tpu_torch/ops/_build.py builds this file
// with nvcc, bolt_tpu_torch/ops/kernels.py holds the wrappers and their plain
// PyTorch versions).
//
// Both compute y[i] = sum_k x[i - r + k] * taps[k] along one axis of a
// contiguous tensor ('same' size, r = w / 2), with the positions outside
// [0, n) read through numpy.pad's boundary rule (pad_source below):
//
// bolt_window_strided replaces the Pallas kernel bolt_tpu/ops/kernels.py ::
// sepfilter1d (_sep1d_kernel, sepfilter_plan) for any axis but the last.
// The tensor is viewed as (outer, n, inner) with the filtered axis in the
// middle.
//   Bound on an H100 SXM: the bytes, the tensor read once and written once
//   over 3.35 TB/s; the 2w operations an element stay far below the
//   67 TFLOP/s f32 rate at the widths filters use.
//   Design: a block stages a tile of kTileS + w - 1 rows by kColsS
//   contiguous columns in shared memory, rows outside [0, n) already
//   resolved by the boundary rule, with 16-byte loads where the wrapper
//   allows them (a staged row is kColsS / VEC vectors, and four times the
//   bytes of a 4-byte load stay in flight per instruction).  Each thread
//   then computes kRows consecutive outputs of one column, sliding a window
//   of kRows values through registers: one shared-memory read and one tap
//   read per tap step serve kRows outputs.  With 16-byte loads the outputs
//   go back through shared memory and leave as 16-byte stores too.
//
// bolt_window_lane replaces bolt_tpu/ops/kernels.py :: lane_band_pallas
// (_band_kernel) and the transpose detour sepfilter1d takes for wide
// non-constant windows on the last axis: the last-axis kernel serves every
// mode and radius.  The tensor is viewed as (rows, L).
//   Bound: the same bytes.
//   Design: a block stages a segment of kSegL outputs plus its w - 1 halo
//   of one row in shared memory (16-byte loads over the aligned cover of
//   the span where the wrapper allows them), de-interleaved (position p at
//   (p % kRows) * stride + p / kRows) so that thread t, which computes
//   outputs t*kRows .. t*kRows + kRows - 1 with the same register window,
//   reads a different bank from its neighbours at every step.  The
//   results go back through the same layout and leave as coalesced rows,
//   16 bytes a store where the loads were.
//
// A radius too wide for the staged tile in 48 KB of shared memory takes
// window_direct_kernel, which reads every tap's input from global memory
// (cached in L1/L2): any radius works.
//
// Arithmetic, as the reference's overlap._filter1d: acc = x[i-r] * t0, then
// acc = acc + x[i-r+k] * tk in tap order, each product and sum rounded on
// its own (__fmul_rn/__fadd_rn, no FMA contraction), every tap multiplied
// (constant-mode zero pads and zero taps too, which keeps signed zeros,
// inf * 0 = NaN and NaN positions).  f32 and f64 compute in their own
// type, so the kernels equal their plain versions bit for bit; f16/bf16
// load into f32, accumulate there and round once on the store.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 8;                    // outputs per thread (register window)
constexpr int kColsS = 32;                  // strided: columns per tile (one warp)
constexpr int kWarpsS = 8;                  // strided: warps per block
constexpr int kTileS = kWarpsS * kRows;     // strided: output rows per tile
constexpr int kThreadsL = 256;              // lane: threads per block
constexpr int kSegL = kThreadsL * kRows;    // lane: outputs per tile
constexpr int kThreadsD = 256;              // direct: threads per block
constexpr size_t kSmemMax = 48 * 1024;      // staged tiles up to this size

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

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// boundary-mode codes shared with bolt_tpu_torch/ops/kernels.py :: _MODE_CODE
enum : int { kConstant = 0, kReflect = 1, kEdge = 2, kSymmetric = 3 };

// The index that padded position i (any integer) of an axis of length n
// reads under numpy.pad's rule, or -1 for constant mode's zero
// (bolt_tpu_torch/ops/kernels.py :: pad_index is the same rule).
__device__ __forceinline__ int64_t pad_source(int64_t i, int64_t n, int mode) {
  if (i >= 0 && i < n) return i;
  if (mode == kConstant) return -1;
  if (mode == kEdge) return i < 0 ? 0 : n - 1;
  if (mode == kReflect) {
    if (n == 1) return 0;
    const int64_t p = 2 * (n - 1);
    const int64_t j = (i < 0 ? -i : i) % p;
    return j < n ? j : p - j;
  }
  const int64_t p = 2 * n;                  // symmetric
  int64_t j = i % p;
  if (j < 0) j += p;
  return j < n ? j : p - 1 - j;
}

template <typename T>
__device__ __forceinline__ typename Acc<T>::type load_padded(const T* __restrict__ x,
                                                             int64_t i, int64_t n,
                                                             int64_t stride, int mode) {
  using A = typename Acc<T>::type;
  const int64_t src = pad_source(i, n, mode);
  return src >= 0 ? to_acc(x[src * stride]) : A(0);
}

// V = 16 / sizeof(T) neighbouring elements from p in one 16-byte load (the
// wrapper guarantees the alignment), widened to the accumulator type.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         typename Acc<T>::type (&out)[V]) {
  static_assert(V * sizeof(T) == 16, "one 16-byte load");
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  T e[V];
  memcpy(e, &raw, 16);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_acc(e[i]);
}

// V accumulator values to 16-byte aligned shared memory, 16 bytes a store.
template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int V>
__device__ __forceinline__ void store_vec(double* dst, const double (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 2)
    *reinterpret_cast<double2*>(dst + i) = make_double2(v[i], v[i + 1]);
}

// V accumulator values to global memory as one 16-byte store of T (the
// wrapper guarantees the alignment), each rounded once.
template <typename T, int V>
__device__ __forceinline__ void store_out(T* __restrict__ dst,
                                          const typename Acc<T>::type (&v)[V]) {
  static_assert(V * sizeof(T) == 16, "one 16-byte store");
  T e[V];
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_acc<T>(v[i]);
  uint4 raw;
  memcpy(&raw, e, 16);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// kRows outputs from a window of values get(m), m = 0 .. kRows + w - 2:
// out[j] = get(j) * t0 + get(j + 1) * t1 + ... in tap order.
template <typename A, typename Get>
__device__ __forceinline__ void slide(Get get, const A* __restrict__ taps, int w,
                                      A (&acc)[kRows]) {
  A win[kRows];
  const A t0 = taps[0];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    win[j] = get(j);
    acc[j] = mul_rn(win[j], t0);
  }
  for (int k = 1; k < w; ++k) {
    const A tk = taps[k];
#pragma unroll
    for (int j = 0; j < kRows - 1; ++j) win[j] = win[j + 1];
    win[kRows - 1] = get(k + kRows - 1);
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = add_rn(acc[j], mul_rn(win[j], tk));
  }
}

// ---------------------------------------------------------------------------
// strided axis: x viewed as (outer, n, inner)
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kColsS * kWarpsS)
window_strided_kernel(const T* __restrict__ x, T* __restrict__ y,
                      const typename Acc<T>::type* __restrict__ taps, int64_t n,
                      int64_t inner, int w, int mode, int64_t tiles_n, int64_t tiles_c,
                      int64_t tiles) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* s = reinterpret_cast<A*>(smem_raw);    // (kTileS + w - 1) rows x kColsS
  const int r = w / 2;
  const int halo_rows = kTileS + w - 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t tc = tile % tiles_c;
    const int64_t rest = tile / tiles_c;
    const int64_t row0 = (rest % tiles_n) * kTileS;
    const int64_t o = rest / tiles_n;
    const int64_t c = tc * kColsS + tx;
    const T* xo = x + o * n * inner + c;
    __syncthreads();                        // the previous tile's reads are done
    if constexpr (VEC > 1) {
      // 16-byte loads: kColsS / VEC vectors a staged row (inner % VEC == 0,
      // so a vector lies wholly inside or wholly outside the columns)
      constexpr int kVecRow = kColsS / VEC;
      const T* xt = x + o * n * inner + tc * kColsS;
#pragma unroll 2
      for (int q = ty * kColsS + tx; q < halo_rows * kVecRow; q += kColsS * kWarpsS) {
        const int p = q / kVecRow, v = q % kVecRow;
        const int64_t src = pad_source(row0 - r + p, n, mode);
        A vals[VEC];
        if (src >= 0 && tc * kColsS + v * VEC < inner) {
          load_vec<T, VEC>(xt + src * inner + v * VEC, vals);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vals[e] = A(0);
        }
        store_vec<VEC>(s + p * kColsS + v * VEC, vals);
      }
    } else {
#pragma unroll 4
      for (int p = ty; p < halo_rows; p += kWarpsS)
        s[p * kColsS + tx] = c < inner ? load_padded(xo, row0 - r + p, n, inner, mode) : A(0);
    }
    __syncthreads();
    const int j0 = ty * kRows;
    A acc[kRows];
    slide<A>([&](int m) { return s[(j0 + m) * kColsS + tx]; }, taps, w, acc);
    if constexpr (VEC > 1) {
      // the tile's outputs go back through shared memory and leave as
      // 16-byte stores
      constexpr int kVecRow = kColsS / VEC;
      __syncthreads();                      // every window read is done
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[(j0 + j) * kColsS + tx] = acc[j];
      __syncthreads();
      T* yt = y + o * n * inner + tc * kColsS;
#pragma unroll 2
      for (int q = ty * kColsS + tx; q < kTileS * kVecRow; q += kColsS * kWarpsS) {
        const int p = q / kVecRow, v = q % kVecRow;
        const int64_t row = row0 + p;
        if (row < n && tc * kColsS + v * VEC < inner) {
          A vals[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) vals[e] = s[p * kColsS + v * VEC + e];
          store_out<T, VEC>(yt + row * inner + v * VEC, vals);
        }
      }
    } else if (c < inner) {
      T* yo = y + o * n * inner + c;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int64_t row = row0 + j0 + j;
        if (row < n) yo[row * inner] = from_acc<T>(acc[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// last axis: x viewed as (rows, L)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int64_t cdiv_dev(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ int lane_slot(int p, int stride) {
  return (p % kRows) * stride + p / kRows;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreadsL)
window_lane_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const typename Acc<T>::type* __restrict__ taps, int64_t L, int w,
                   int mode, int64_t segs, int64_t tiles, int stride) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* s = reinterpret_cast<A*>(smem_raw);    // kRows x stride, de-interleaved
  const int r = w / 2;
  const int span = kSegL + w - 1;
  const int t = threadIdx.x;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row = tile / segs;
    const int64_t seg0 = (tile % segs) * kSegL;
    const T* xr = x + row * L;
    __syncthreads();                        // the previous tile's reads are done
    if constexpr (VEC > 1) {
      // 16-byte loads over the VEC-aligned cover of [seg0 - r, seg0 - r +
      // span) (L % VEC == 0, so a vector lies wholly inside or outside the
      // row); positions outside the row go through the boundary rule
      const int64_t start = seg0 - r;
      const int64_t a0 = start >= 0 ? start / VEC * VEC : -((-start + VEC - 1) / VEC) * VEC;
      const int nvec = static_cast<int>(cdiv_dev(start + span - a0, VEC));
#pragma unroll 2
      for (int q = t; q < nvec; q += kThreadsL) {
        const int64_t pos = a0 + static_cast<int64_t>(q) * VEC;
        A vals[VEC];
        if (pos >= 0 && pos < L) {
          load_vec<T, VEC>(xr + pos, vals);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vals[e] = load_padded(xr, pos + e, L, 1, mode);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int64_t p = pos + e - start;
          if (p >= 0 && p < span) s[lane_slot(static_cast<int>(p), stride)] = vals[e];
        }
      }
    } else {
#pragma unroll 4
      for (int p = t; p < span; p += kThreadsL)
        s[lane_slot(p, stride)] = load_padded(xr, seg0 - r + p, L, 1, mode);
    }
    __syncthreads();
    const int base = t * kRows;
    A acc[kRows];
    slide<A>([&](int m) { return s[(m % kRows) * stride + t + m / kRows]; }, taps, w, acc);
    __syncthreads();                        // every window read before the overwrite
#pragma unroll
    for (int j = 0; j < kRows; ++j) s[lane_slot(base + j, stride)] = acc[j];
    __syncthreads();
    T* yr = y + row * L;
    if constexpr (VEC > 1) {
      // 16-byte stores (L and seg0 are multiples of VEC)
      for (int q = t; q < kSegL / VEC; q += kThreadsL) {
        const int p0 = q * VEC;
        if (seg0 + p0 < L) {
          A vals[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) vals[e] = s[lane_slot(p0 + e, stride)];
          store_out<T, VEC>(yr + seg0 + p0, vals);
        }
      }
    } else {
      for (int p = t; p < kSegL; p += kThreadsL) {
        const int64_t col = seg0 + p;
        if (col < L) yr[col] = from_acc<T>(s[lane_slot(p, stride)]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// any radius: every tap's input read from global memory
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreadsD)
window_direct_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const typename Acc<T>::type* __restrict__ taps, int64_t n,
                     int64_t inner, int w, int mode, int64_t total) {
  using A = typename Acc<T>::type;
  const int r = w / 2;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t c = e % inner;
    const int64_t rest = e / inner;
    const int64_t i = rest % n;
    const T* xo = x + (rest / n) * n * inner + c;
    A acc = mul_rn(load_padded(xo, i - r, n, inner, mode), taps[0]);
    for (int k = 1; k < w; ++k)
      acc = add_rn(acc, mul_rn(load_padded(xo, i - r + k, n, inner, mode), taps[k]));
    y[e] = from_acc<T>(acc);
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

unsigned int grid_of(int64_t blocks) {
  return static_cast<unsigned int>(blocks < 0x7fffffff ? blocks : 0x7fffffff);
}

template <typename T>
cudaError_t launch_direct(const void* x, void* y, const void* taps, int64_t outer, int64_t n,
                          int64_t inner, int w, int mode, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t total = outer * n * inner;
  const int64_t blocks = cdiv(total, kThreadsD);
  window_direct_kernel<T><<<grid_of(blocks < (1 << 20) ? blocks : (1 << 20)), kThreadsD, 0,
                            stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                      static_cast<const A*>(taps), n, inner, w, mode, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_strided(const void* x, void* y, const void* taps, int64_t outer, int64_t n,
                           int64_t inner, int w, int mode, int vec, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  const size_t smem = static_cast<size_t>(kTileS + w - 1) * kColsS * sizeof(A);
  if (smem > kSmemMax) return launch_direct<T>(x, y, taps, outer, n, inner, w, mode, stream);
  const int64_t tiles_n = cdiv(n, kTileS);
  const int64_t tiles_c = cdiv(inner, kColsS);
  const int64_t tiles = outer * tiles_n * tiles_c;
  const dim3 block(kColsS, kWarpsS);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const A* tp = static_cast<const A*>(taps);
  if (vec == kVec)
    window_strided_kernel<T, kVec><<<grid_of(tiles), block, smem, stream>>>(
        xt, yt, tp, n, inner, w, mode, tiles_n, tiles_c, tiles);
  else if (vec == 1)
    window_strided_kernel<T, 1><<<grid_of(tiles), block, smem, stream>>>(
        xt, yt, tp, n, inner, w, mode, tiles_n, tiles_c, tiles);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lane(const void* x, void* y, const void* taps, int64_t rows, int64_t L, int w,
                        int mode, int vec, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  // the de-interleaved rows hold span = kSegL + w - 1 positions; a row
  // stride of 4 mod 32 words keeps the staging writes off shared banks
  int stride = static_cast<int>(cdiv(kSegL + w - 1, kRows));
  stride += ((4 - stride % 32) + 32) % 32;
  const size_t smem = static_cast<size_t>(kRows) * stride * sizeof(A);
  if (smem > kSmemMax) return launch_direct<T>(x, y, taps, rows, L, 1, w, mode, stream);
  constexpr int kVec = 16 / sizeof(T);
  const int64_t segs = cdiv(L, kSegL);
  const int64_t tiles = rows * segs;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const A* tp = static_cast<const A*>(taps);
  if (vec == kVec)
    window_lane_kernel<T, kVec><<<grid_of(tiles), kThreadsL, smem, stream>>>(
        xt, yt, tp, L, w, mode, segs, tiles, stride);
  else if (vec == 1)
    window_lane_kernel<T, 1><<<grid_of(tiles), kThreadsL, smem, stream>>>(
        xt, yt, tp, L, w, mode, segs, tiles, stride);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// dtype codes shared with bolt_tpu_torch/ops/kernels.py :: _DTYPE_CODE
enum : int { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

bool valid(int w, int mode) { return w >= 1 && mode >= kConstant && mode <= kSymmetric; }

}  // namespace

extern "C" {

// x, y: contiguous (outer, n, inner) in one of the four float types; taps:
// w values in the accumulator type (f64 for f64 input, else f32); vec:
// 16 / sizeof(T) when x is 16-byte aligned and the filtered rows (inner, or
// L below) are a multiple of it, so staging loads 16 bytes at a time, else 1.
// Returns cudaGetLastError() after the launch (0 on success).
int bolt_window_strided(const void* x, void* y, const void* taps, int64_t outer, int64_t n,
                        int64_t inner, int w, int mode, int dtype, int vec, void* stream) {
  if (!valid(w, mode)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_strided<float>(x, y, taps, outer, n, inner, w, mode, vec, s);
    case kF64: return launch_strided<double>(x, y, taps, outer, n, inner, w, mode, vec, s);
    case kF16: return launch_strided<__half>(x, y, taps, outer, n, inner, w, mode, vec, s);
    case kBF16:
      return launch_strided<__nv_bfloat16>(x, y, taps, outer, n, inner, w, mode, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

// x, y: contiguous (rows, L); taps and vec as above.
int bolt_window_lane(const void* x, void* y, const void* taps, int64_t rows, int64_t L, int w,
                     int mode, int dtype, int vec, void* stream) {
  if (!valid(w, mode)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_lane<float>(x, y, taps, rows, L, w, mode, vec, s);
    case kF64: return launch_lane<double>(x, y, taps, rows, L, w, mode, vec, s);
    case kF16: return launch_lane<__half>(x, y, taps, rows, L, w, mode, vec, s);
    case kBF16: return launch_lane<__nv_bfloat16>(x, y, taps, rows, L, w, mode, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
