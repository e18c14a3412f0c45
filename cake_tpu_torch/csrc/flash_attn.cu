// Flash prefill attention for Hopper (sm_90a), float32, plain C entry point.
//
// Replaces cake_tpu/ops/flash.py:_flash_kernel (the Pallas TPU kernel) on
// the float32 route; bfloat16 takes csrc/flash_attn_wgmma.cu (tensor
// cores). TF32 tensor cores would keep about three decimal digits, which
// breaks the float32 tolerance (1e-4), so this route stays on FMA.
// Computes causal GQA attention over [B, S, H, D] tensors given by their
// strides (last dimension contiguous), with the reference's masks:
//   key valid   iff k_pos < limit        (limit = q_offset + valid_len)
//   causal      iff k_pos <= q_pos       (q_pos = q_offset + row)
//   window      iff k_pos >  q_pos - window   (window > 0 only)
// Scores, the running max/sum and the output accumulator are float32.
//
// Bound on an H100: ~4*Sq*Skv_visible*Hq*D FLOPs against 67 TFLOP/s of
// float32 FMA, or the K/V rows below `limit` against HBM in append mode.
// Plain FMA from shared memory, far from either bound: the checked
// float32 baseline.
//
// Layout of one block (one 32-row query tile of one head of one batch row):
//   shared: Q tile [32][D+1], K and V tiles [64][D+1], P tile [32][65]
//   (rows padded by one float so column walks hit distinct banks):
//   173,056 bytes at D = 256, 91,136 at D = 128;
//   128 threads; thread t owns score rows 4*(t/16)+i and columns
//   (t%16)+16*j, and the same rows of the output accumulator.
// K/V tiles stream through shared memory from `lo` to `hi`, the first and
// last tile any row of the block can see, so tiles wholly above the
// diagonal, below the window or past the limit are never read.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 128;   // threads per block
constexpr int PLD = BK + 1;
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int sq, skv, group;
  float scale;
  int causal, window, q_offset, limit;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + 2 * size_t(BK) * (D + 1) + BQ * PLD + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd(Params p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sAlpha = sP + BQ * PLD;
  float* sL = sAlpha + BQ;

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* v = p.v + b * p.v_sb + kvh * p.v_sh;
  float* o = p.o + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int qr = q_start + r;
    sQ[r * LD + c] = qr < p.sq ? q[qr * p.q_ss + c] * p.scale : 0.f;
  }

  // tile range: keys past the limit are invisible to every row; under
  // the causal mask the block's last real row sees keys up to its
  // position; under the window its first row sees keys above
  // q_pos - window.
  int hi_key = min(p.limit, p.skv);
  const int last_row = min(q_start + BQ, p.sq) - 1;
  if (p.causal) hi_key = min(hi_key, p.q_offset + last_row + 1);
  const int hi = hi_key > 0 ? (hi_key + BK - 1) / BK : 0;
  int lo = 0;
  if (p.window > 0) {
    const int first = p.q_offset + q_start - p.window + 1;
    lo = first > 0 ? first / BK : 0;
  }

  const int rg = tid / 16;        // score/output rows 4*rg .. 4*rg+3
  const int cg = tid % 16;        // columns cg + 16*j
  const int srow = tid >> 2;      // softmax: row owned by 4 threads
  const int spart = tid & 3;      // ... each over 16 columns
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // previous tile fully consumed (and Q stored)
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool ok = kr < p.skv;
      sK[r * LD + c] = ok ? k[kr * p.k_ss + c] : 0.f;
      sV[r * LD + c] = ok ? v[kr * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int q_pos = p.q_offset + q_start + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const int k_pos = k0 + c;
        bool vis = k_pos < p.limit && k_pos < p.skv;
        if (p.causal) vis = vis && k_pos <= q_pos;
        if (p.window > 0) vis = vis && k_pos > q_pos - p.window;
        sP[r * PLD + c] = vis ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    {   // online softmax over this tile, 4 lanes per row
      float* row = sP + srow * PLD + spart * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);   // 0 on the first tile
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (spart == 0) sAlpha[srow] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sV[c * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) sL[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int qr = q_start + r;
    if (qr >= p.sq) continue;
    const float inv = 1.f / fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) o[qr * p.o_ss + cg + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch, int hq, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // once per instantiation, not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  dim3 grid((p.sq + BQ - 1) / BQ, hq, batch);
  flash_fwd<D><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// float32 only. Strides are in elements, in the order (batch, seq, head)
// for each of q, k, v, o. window <= 0 means none. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int cake_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int batch, int sq, int skv, int hq, int hkv, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, int q_offset, int limit,
    void* stream) {
  if (batch <= 0 || sq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = sq; p.skv = skv; p.group = hq / hkv;
  p.scale = scale;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.limit = limit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {   // each head dimension its own instantiation; no other
    case 64:
      return static_cast<int>(launch<64>(p, batch, hq, s));
    case 128:
      return static_cast<int>(launch<128>(p, batch, hq, s));
    case 256:
      return static_cast<int>(launch<256>(p, batch, hq, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
