// Decode-and-reduce kernel for Hopper (sm_90a), bound with ctypes through a
// plain C interface (bolt_tpu_torch/ops/_build.py builds this file with nvcc,
// bolt_tpu_torch/ops/kernels.py :: fused_decode_sum is the wrapper, with its
// plain PyTorch version beside it).
//
// bolt_fused_decode_sum replaces the Pallas kernel bolt_tpu/ops/kernels.py ::
// fused_decode_sum (_decode_sum_kernel).  For a contiguous (n, C) matrix q of
// uint8 or int8 (an int8-codec slab, bolt_tpu_torch/gpu/codec.py) and the
// slab's f32 sidecar (scale, zp), it computes
//     out[c] = sum over r of (float(q[r, c]) * scale + zp)
// in f32, decoding each element as the reference does: the multiply rounded,
// then the add rounded (__fmul_rn / __fadd_rn, so nvcc cannot contract an
// FMA), then added to the column's sum.  The decoded values never reach
// device memory.
//   Bound on an H100 SXM: the bytes, n*C read once and 4*C written, over
//   3.35 TB/s; the arithmetic is 3 operations an element, but the byte to
//   f32 conversion issues at a quarter of the f32 rate, so on a large wire
//   (2.6e9 elements) it costs about as much time as the bytes do.
//   Design (the column-parallel plan of moments.cu :: fused_welford): each
//   thread owns VEC neighbouring columns (16 through one 16-byte load a row
//   when the alignment and C allow it, else 8, 4 or 1) and folds its rows
//   into VEC f32 registers, four rows loaded before they are used.  When C
//   is narrower than a block, the block's threads also split the rows into
//   row lanes, folded into one sum by a fixed tree in shared memory.  When
//   the columns alone leave the card idle, the rows split into R chunks over
//   blockIdx.y; each chunk writes its partial sums to scratch and a second
//   kernel adds the R partials of each column in chunk order.  No atomics:
//   the result is the same from run to run.
//   scale and zp are read from device memory (the sidecar the uploader
//   copied beside the wire), so the launch needs no host synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;   // threads per block, a multiple of 32
constexpr int kUnroll = 4;      // rows loaded ahead

__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }

// VEC neighbouring bytes from p in one load (the wrapper guarantees that p
// is VEC-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_bytes(const uint8_t* __restrict__ p, uint8_t (&out)[VEC]) {
  if constexpr (VEC == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(out, &raw, sizeof(raw));
  } else if constexpr (VEC == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    memcpy(out, &raw, sizeof(raw));
  } else if constexpr (VEC == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    memcpy(out, &raw, sizeof(raw));
  } else {
    static_assert(VEC == 1, "a load is 1, 4, 8 or 16 bytes");
    out[0] = p[0];
  }
}

// The decoded value of one wire byte (SIGNED: int8, else uint8).
template <bool SIGNED>
__device__ __forceinline__ float decode(uint8_t b, float scale, float zp) {
  const float v = SIGNED ? (float)(int8_t)b : (float)b;
  return __fadd_rn(__fmul_rn(v, scale), zp);
}

// The block's threads form `lanes` row lanes of kThreads / lanes column
// threads each (thread t: column thread t % width, lane t / width).  Adds
// every lane's VEC sums into lane 0 by a tree in a fixed order, through
// dynamic shared memory of VEC * kThreads / 2 floats when lanes > 1.
template <int VEC>
__device__ __forceinline__ void combine_lanes(float (&acc)[VEC], int lanes) {
  extern __shared__ __align__(16) float sh[];
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

// Partial column sums of rows [blockIdx.y * rpc, min(n, (blockIdx.y + 1) *
// rpc)); lane l walks rows r0 + l, r0 + l + lanes, ..., so a warp reads whole
// neighbouring rows when C is narrow.  part is (R, C) f32 (the output itself
// when R == 1).
template <bool SIGNED, int VEC>
__global__ void __launch_bounds__(kThreads)
decode_sum_partial_kernel(const uint8_t* __restrict__ q, float* __restrict__ part,
                          const float* __restrict__ scale_p, const float* __restrict__ zp_p,
                          int64_t n, int64_t C, int64_t rpc, int lanes) {
  const int width = kThreads / lanes;
  const int lane = threadIdx.x / width;
  const int64_t col = ((int64_t)blockIdx.x * width + threadIdx.x % width) * VEC;
  const bool active = col < C;   // idle threads still join combine_lanes
  const int64_t r0 = (int64_t)blockIdx.y * rpc;
  const int64_t r1 = imin64(n, r0 + rpc);
  const float scale = *scale_p;
  const float zp = *zp_p;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  if (active) {
    const int64_t step = (int64_t)lanes * C;
    const uint8_t* p = q + (r0 + lane) * C + col;
    int64_t r = r0 + lane;
    for (; r + (int64_t)(kUnroll - 1) * lanes < r1; r += (int64_t)kUnroll * lanes) {
      uint8_t buf[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_bytes<VEC>(p + (int64_t)u * step, buf[u]);
      p += (int64_t)kUnroll * step;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += decode<SIGNED>(buf[u][v], scale, zp);
    }
    for (; r < r1; r += lanes) {   // the lane's rows past its last group of kUnroll
      uint8_t b[VEC];
      load_bytes<VEC>(p, b);
      p += step;
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += decode<SIGNED>(b[v], scale, zp);
    }
  }
  combine_lanes<VEC>(acc, lanes);
  if (!active || lane != 0) return;
  float* out = part + (int64_t)blockIdx.y * C + col;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out[v] = acc[v];
}

// out[c] = the R partials of column c added in chunk order.
__global__ void __launch_bounds__(kThreads)
decode_sum_combine_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t C,
                          int R) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= C) return;
  float s = 0.0f;
  for (int r = 0; r < R; ++r) s += part[(int64_t)r * C + col];
  out[col] = s;
}

template <bool SIGNED, int VEC>
cudaError_t launch_decode_sum(const void* q, void* part, void* out, const void* scale,
                              const void* zp, int64_t n, int64_t C, int64_t rpc, int R,
                              int lanes, cudaStream_t stream) {
  if (lanes < 1 || lanes > kThreads || kThreads % lanes != 0 || R < 1)
    return cudaErrorInvalidValue;
  const int64_t groups = (C + VEC - 1) / VEC;
  const int64_t width = kThreads / lanes;
  dim3 grid((unsigned)((groups + width - 1) / width), (unsigned)R);
  const size_t smem = lanes > 1 ? sizeof(float) * VEC * (kThreads / 2) : 0;
  float* dst = static_cast<float*>(R == 1 ? out : part);
  decode_sum_partial_kernel<SIGNED, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(q), dst, static_cast<const float*>(scale),
      static_cast<const float*>(zp), n, C, rpc, lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || R == 1) return err;
  const unsigned cgrid = (unsigned)((C + kThreads - 1) / kThreads);
  decode_sum_combine_kernel<<<cgrid, kThreads, 0, stream>>>(static_cast<const float*>(part),
                                                            static_cast<float*>(out), C, R);
  return cudaGetLastError();
}

template <bool SIGNED>
cudaError_t dispatch_decode_sum(int vec, const void* q, void* part, void* out, const void* scale,
                                const void* zp, int64_t n, int64_t C, int64_t rpc, int R,
                                int lanes, cudaStream_t s) {
  switch (vec) {
    case 16: return launch_decode_sum<SIGNED, 16>(q, part, out, scale, zp, n, C, rpc, R, lanes, s);
    case 8: return launch_decode_sum<SIGNED, 8>(q, part, out, scale, zp, n, C, rpc, R, lanes, s);
    case 4: return launch_decode_sum<SIGNED, 4>(q, part, out, scale, zp, n, C, rpc, R, lanes, s);
    case 1: return launch_decode_sum<SIGNED, 1>(q, part, out, scale, zp, n, C, rpc, R, lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: contiguous (n, C) uint8 (is_signed == 0) or int8 (is_signed == 1);
// part: (R, C) f32 scratch (unused when R == 1); out: C f32; scale, zp: one
// f32 each in device memory.  vec: bytes a thread loads a row (16, 8, 4 or
// 1; q and C must keep that alignment).  Returns cudaGetLastError() after
// the launches (0 on success).
int bolt_fused_decode_sum(const void* q, void* part, void* out, const void* scale,
                          const void* zp, int64_t n, int64_t C, int64_t rpc, int R, int lanes,
                          int is_signed, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_signed) return dispatch_decode_sum<true>(vec, q, part, out, scale, zp, n, C, rpc, R,
                                                  lanes, s);
  return dispatch_decode_sum<false>(vec, q, part, out, scale, zp, n, C, rpc, R, lanes, s);
}

}  // extern "C"
