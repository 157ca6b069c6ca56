// Decode-and-reduce kernel for Hopper (sm_90a), bound with ctypes through a
// plain C interface (bolt_tpu_torch/ops/_build.py builds this file with nvcc,
// bolt_tpu_torch/ops/kernels.py :: fused_decode_sum is the wrapper, with its
// plain PyTorch version beside it).
//
// bolt_fused_decode_sum and bolt_fused_decode_sum_rows replace the Pallas
// kernel bolt_tpu/ops/kernels.py :: fused_decode_sum (_decode_sum_kernel).
// For a contiguous (n, C) matrix q of uint8 or int8 (an int8-codec slab,
// bolt_tpu_torch/gpu/codec.py) and the slab's f32 sidecar (scale, zp), they
// compute
//     out[c] = sum over r of (float(q[r, c]) * scale + zp)
// in f32, decoding each element as the reference does: the multiply rounded,
// then the add rounded (__fmul_rn / __fadd_rn, so nvcc cannot contract an
// FMA), then added to the column's sum in row order.  The decoded values
// never reach device memory.
//   Bound on an H100 SXM: the bytes, n*C read once and 4*C written, over
//   3.35 TB/s.  Two things kept the first design from it.
//   * The conversion.  (float)b compiles to I2F, which runs at a quarter
//     of the f32 rate.  Here each byte is placed under the exponent of
//     2^23 by one __byte_perm (0x4B0000bb is the float 2^23 + b) and one
//     full-rate __fsub_rn of 2^23 gives (float)b exactly; int8 bytes are
//     XORed with 0x80 first and 2^23 + 128 subtracted.  The values are
//     exact, so the decode gives the same floats as before.
//   * The grid at the streamed slab, (20, 819200): 200 blocks on 132 SMs, so
//     the SMs that took a second block set the time, and each thread walked
//     its 20 rows four loads at a time.  For such short, wide slabs
//     (bolt_fused_decode_sum_rows) the grid is a multiple of the SM count
//     with equal column ranges, and each thread starts every row's 16-byte
//     load before the first is used.
//   Design for taller or narrower inputs (bolt_fused_decode_sum; the
//   column-parallel plan of moments.cu :: fused_welford): each thread owns
//   VEC neighbouring columns (16 through one 16-byte load a row when the
//   alignment and C allow it, else 8, 4 or 1) and folds its rows into VEC
//   f32 registers, four rows loaded before they are used.  When C is
//   narrower than a block, the block's threads also split the rows into row
//   lanes, folded into one sum by a fixed tree in shared memory.  When the
//   columns alone leave the card idle, the rows split into R chunks over
//   blockIdx.y, as many as the card holds in one wave (rounded up, as
//   before, the whole wire's 1200 blocks ran a second wave of 144, which
//   cost it more than the conversion did); each chunk writes
//   its partial sums to scratch and a second kernel adds the R partials of
//   each column in chunk order.  No atomics:
//   the result is the same from run to run.  The plans are
//   kernels.py :: decode_sum_plan.
//   scale and zp are read from device memory (the sidecar the uploader
//   copied beside the wire), so the launch needs no host synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;   // threads per block, a multiple of 32
constexpr int kUnroll = 4;      // rows loaded ahead
constexpr int kRowsAhead = 24;  // kernels.py :: _ROWS_AHEAD

__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }

// The decode of a slab's bytes, SIGNED: int8, else uint8.  Each byte is
// placed under the exponent of 2^23 (0x4B0000bb is the float 2^23 + b);
// for int8 the byte is XORed with 0x80 first, so the float is 2^23 + b +
// 128.  The exact subtraction of 2^23 (+ 128) gives (float)b, and the
// result is __fadd_rn(__fmul_rn((float)b, scale), zp).
template <bool SIGNED>
struct Decoder {
  float scale, zp;

  __device__ __forceinline__ void operator()(uint32_t w, float (&v)[4]) const {
    constexpr float kBias = SIGNED ? 8388736.0f : 8388608.0f;   // 2^23 (+ 128)
    if (SIGNED) w ^= 0x80808080u;
    const uint32_t sel[4] = {0x7440u, 0x7441u, 0x7442u, 0x7443u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = __uint_as_float(__byte_perm(w, 0x4B000000u, sel[i]));
      v[i] = __fadd_rn(__fmul_rn(__fsub_rn(f, kBias), scale), zp);
    }
  }
};

// VEC neighbouring bytes from p in one load, as VEC / 4 words (one word
// holding the byte when VEC is 1); the wrapper guarantees that p is
// VEC-byte aligned.
template <int VEC>
struct Pack {
  static constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;
  uint32_t w[kWords];
};

template <int VEC>
__device__ __forceinline__ Pack<VEC> load_bytes(const uint8_t* __restrict__ p) {
  Pack<VEC> out;
  if constexpr (VEC == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(out.w, &raw, sizeof(raw));
  } else if constexpr (VEC == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    memcpy(out.w, &raw, sizeof(raw));
  } else if constexpr (VEC == 4) {
    out.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(VEC == 1, "a load is 1, 4, 8 or 16 bytes");
    out.w[0] = p[0];
  }
  return out;
}

// acc[v] += the decoded value of byte v of the pack.
template <int VEC, bool SIGNED>
__device__ __forceinline__ void add_pack(const Pack<VEC>& pk, const Decoder<SIGNED>& dec,
                                         float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < Pack<VEC>::kWords; ++i) {
    float d[4];
    dec(pk.w[i], d);
#pragma unroll
    for (int j = 0; j < 4 && i * 4 + j < VEC; ++j) acc[i * 4 + j] += d[j];
  }
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

// ---------------------------------------------------------------------------
// short, wide slabs: every row ahead, equal column ranges
// ---------------------------------------------------------------------------

// Thread t of block b sums the n <= kRowsAhead rows of the 16 columns of
// group b * span + t, loading every row before the first is added.
template <bool SIGNED>
__global__ void __launch_bounds__(kThreads, 2)
decode_sum_rows_kernel(const uint8_t* __restrict__ q, float* __restrict__ out,
                       const float* __restrict__ scale_p, const float* __restrict__ zp_p,
                       int n, int64_t C, int span) {
  const int64_t grp = (int64_t)blockIdx.x * span + threadIdx.x;
  if ((int)threadIdx.x >= span || grp * 16 >= C) return;
  const uint8_t* p = q + grp * 16;
  Pack<16> rows[kRowsAhead];
#pragma unroll
  for (int r = 0; r < kRowsAhead; ++r)
    if (r < n) rows[r] = load_bytes<16>(p + (int64_t)r * C);
  float acc[16];
#pragma unroll
  for (int v = 0; v < 16; ++v) acc[v] = 0.0f;
  const Decoder<SIGNED> dec{*scale_p, *zp_p};
#pragma unroll
  for (int r = 0; r < kRowsAhead; ++r)
    if (r < n) add_pack<16>(rows[r], dec, acc);
  float4* dst = reinterpret_cast<float4*>(out + grp * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
}

// ---------------------------------------------------------------------------
// taller or narrower inputs: row lanes and row chunks
// ---------------------------------------------------------------------------

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
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  if (active) {
    const Decoder<SIGNED> dec{*scale_p, *zp_p};
    const int64_t step = (int64_t)lanes * C;
    const uint8_t* p = q + (r0 + lane) * C + col;
    int64_t r = r0 + lane;
    for (; r + (int64_t)(kUnroll - 1) * lanes < r1; r += (int64_t)kUnroll * lanes) {
      Pack<VEC> buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) buf[u] = load_bytes<VEC>(p + (int64_t)u * step);
      p += (int64_t)kUnroll * step;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_pack<VEC>(buf[u], dec, acc);
    }
    for (; r < r1; r += lanes) {   // the lane's rows past its last group of kUnroll
      add_pack<VEC>(load_bytes<VEC>(p), dec, acc);
      p += step;
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

// The short-slab form: q contiguous (n, C) with n <= kRowsAhead rows, q and
// C 16-byte aligned; out: C f32; blocks * span >= C / 16 column groups,
// threads >= span a block (a multiple of 32, at most kThreads).
int bolt_fused_decode_sum_rows(const void* q, void* out, const void* scale, const void* zp,
                               int n, int64_t C, int blocks, int threads, int span,
                               int is_signed, void* stream) {
  if (n < 1 || n > kRowsAhead || C % 16 != 0 || blocks < 1 || threads < span ||
      threads > kThreads || threads % 32 != 0 || (int64_t)blocks * span * 16 < C)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  float* o = static_cast<float*>(out);
  const float* sc = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(zp);
  if (is_signed)
    decode_sum_rows_kernel<true><<<blocks, threads, 0, s>>>(qb, o, sc, z, n, C, span);
  else
    decode_sum_rows_kernel<false><<<blocks, threads, 0, s>>>(qb, o, sc, z, n, C, span);
  return cudaGetLastError();
}

}  // extern "C"
