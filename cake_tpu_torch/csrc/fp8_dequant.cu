// FP8 (e4m3) block-wise dequantization for Hopper (sm_90a), plain C entry
// point.
//
// Replaces what the reference does in XLA: cake_tpu/ops/fp8.py:17
// dequant_fp8_blockwise, a cast and a broadcast multiply that XLA fuses
// into the consuming einsum (cake_tpu/ops/linear.py:12-24). Same function:
//   out[o, i] = RNE_out(float(w[o, i]) * scale_inv[o / 128, i / 128])
// for w [O, I] float8_e4m3fn row-major (any O and I: edge blocks are
// cropped), scale_inv [ceil(O/128), ceil(I/128)] float32, out [O, I]
// bfloat16, float16 or float32 (one rounding from the float32 product on
// every route).
//
// What bounds it on an H100: bytes. One multiply per parameter against 1
// byte read and 2 (bf16, f16) or 4 (f32) bytes written, so the least time is
// those bytes over 3.35 TB/s. The design is one pass that keeps the
// memory system busy:
//  a. One thread per 16 consecutive values of a row: one 16-byte load of
//     the fp8 bytes, two or four 16-byte stores of the output. 16 divides
//     128, so a thread's run lies in one scale block and reads one scale.
//     The flattened (row, run) index is 64-bit: O may be a vocabulary.
//  b. Exact conversion: cvt.rn.f16x2.e4m3x2 (through
//     __nv_cvt_fp8x2_to_halfraw2) turns two e4m3 values into two halves,
//     which hold every e4m3 value exactly (NaN stays NaN), then f32. One
//     float32 multiply, then one round to nearest even into the output
//     type: the plain version's bits (ops/fp8.py), NaN positions included.
//  c. A scalar path for a run that is cut by the row's end (I not a
//     multiple of 16) or whose bytes are not 16-byte aligned (a row start
//     at I not a multiple of 16), value by value.
//  d. No host sync, no allocation, nothing kept between launches: the
//     launch goes into a CUDA graph. A fused dequant-GEMM that never
//     writes the weight (e4m3 into wgmma) is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;     // FP8_BLOCK
constexpr int kRun = 16;        // values per thread: one 16-byte load
constexpr int kThreads = 256;

__device__ __forceinline__ float2 e4m3x2_to_float2(uint16_t pair) {
  __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3);
  return __half22float2(__half2(h));
}

__device__ __forceinline__ float e4m3_to_float(uint8_t b) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ void store_run(float* out, const float* v) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < kRun / 4; ++k)
    o[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

__device__ __forceinline__ void store_run(__nv_bfloat16* out,
                                          const float* v) {
  uint32_t packed[kRun / 2];
#pragma unroll
  for (int k = 0; k < kRun / 2; ++k) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    packed[k] = *reinterpret_cast<uint32_t*>(&b);
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  o[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

__device__ __forceinline__ void store_run(__half* out, const float* v) {
  uint32_t packed[kRun / 2];
#pragma unroll
  for (int k = 0; k < kRun / 2; ++k) {
    __half2 h = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
    packed[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  o[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

__device__ __forceinline__ void store_one(float* out, float v) { *out = v; }

__device__ __forceinline__ void store_one(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_one(__half* out, float v) {
  *out = __float2half_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
fp8_dequant_kernel(const uint8_t* __restrict__ w,
                   const float* __restrict__ scale_inv,
                   OutT* __restrict__ out, int rows, int cols, int runs,
                   int scale_cols) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * runs) return;
  const int o = static_cast<int>(idx / runs);
  const int i0 = static_cast<int>(idx - static_cast<long long>(o) * runs) *
                 kRun;
  const float s =
      scale_inv[static_cast<size_t>(o / kBlock) * scale_cols + i0 / kBlock];
  const size_t base = static_cast<size_t>(o) * cols + i0;
  const uint8_t* src = w + base;
  OutT* dst = out + base;
  const bool whole = i0 + kRun <= cols &&
                     (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  if (whole) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    float v[kRun];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 lo = e4m3x2_to_float2(words[k] & 0xffffu);
      const float2 hi = e4m3x2_to_float2(words[k] >> 16);
      v[4 * k] = __fmul_rn(lo.x, s);
      v[4 * k + 1] = __fmul_rn(lo.y, s);
      v[4 * k + 2] = __fmul_rn(hi.x, s);
      v[4 * k + 3] = __fmul_rn(hi.y, s);
    }
    store_run(dst, v);
  } else {
    const int n = min(kRun, cols - i0);
    for (int k = 0; k < n; ++k)
      store_one(dst + k, __fmul_rn(e4m3_to_float(src[k]), s));
  }
}

}  // namespace

// out_kind: 0 float32, 1 bfloat16, 2 float16. Returns the launch's
// cudaError_t.
extern "C" int cake_fp8_dequant(const void* w, const void* scale_inv,
                                void* out, int rows, int cols, int out_kind,
                                void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const int runs = (cols + kRun - 1) / kRun;
  const int scale_cols = (cols + kBlock - 1) / kBlock;
  const long long threads = static_cast<long long>(rows) * runs;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* s = static_cast<const float*>(scale_inv);
  if (out_kind == 1) {
    fp8_dequant_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks),
                                        kThreads, 0, st>>>(
        wb, s, static_cast<__nv_bfloat16*>(out), rows, cols, runs,
        scale_cols);
  } else if (out_kind == 2) {
    fp8_dequant_kernel<__half><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 st>>>(wb, s, static_cast<__half*>(out), rows,
                                       cols, runs, scale_cols);
  } else if (out_kind == 0) {
    fp8_dequant_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(wb, s, static_cast<float*>(out), rows,
                                      cols, runs, scale_cols);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
