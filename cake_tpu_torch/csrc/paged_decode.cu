// Paged decode attention for Hopper (sm_90a), bf16 and float32, plain C
// entry point.
//
// Replaces what the reference's paged decode step does in XLA:
// cake_tpu/models/common/cache.py:383 paged_gather_layer (materialize each
// slot's whole logical row from the block pool) followed by
// cake_tpu/ops/attention.py:40 multi_head_attention over it
// (models/common/text_model.py:578-641). Same function, per row b:
//   key at table entry j, index i is visible iff the entry is mapped
//   (id != null_id), pos // bt == j, and 0 <= pos <= p, p = frontier[b]
//   (the step's own entry at p is already in the pool);
//   GQA head h reads kv head h / (Hq / Hkv); scale 1/sqrt(D); scores,
//   softmax and the accumulator in float32; output in q's dtype. A row
//   with no visible key is don't-care (written as zeros).
//
// What bounds it on an H100: bytes. A decode row reads every live K/V
// entry once for one query (about one FLOP per byte against the card's
// ~295 bf16 FLOPs per byte), so the least time is the live K/V bytes over
// 3.35 TB/s. The design spends no tensor cores (one query row per head)
// and aims at the memory system:
//   * it reads only live blocks: each CTA loads its own table entries and
//     stops at p, never touching NULL entries or blocks past p // bt, so
//     the 4096-row logical row of the gather costs nothing beyond p;
//   * it keeps few latencies in series: a CTA resolves all its table
//     entries in one parallel step, then puts every one of its K/V tiles
//     in flight at once (16-byte cp.async copies into shared memory, one
//     copy group per tile; NULL entries are zero-filled, not read) while
//     it loads the keys' positions, and scores tile 0 while tile 1 lands;
//   * the key range is split across CTAs in fixed pieces of NTILE tiles
//     (128 keys in bf16, 64 in float32), so a 4-row decode batch fills the
//     132 SMs (B x Hkv is only 32); a second small kernel merges the
//     pieces' (max, sum, accumulator). The split and the merge order
//     depend only on the row's own p, never on B or the other rows, so a
//     row's result is the same alone or in company and before or after a
//     swap to other physical blocks.
// Grid (splits, Hkv, B), 128 threads. One CTA serves the G = Hq / Hkv
// query heads that share its KV head, so each K/V byte is read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;            // threads per CTA
constexpr int NTILE = 2;           // K/V tiles per CTA, all in flight
constexpr int MAX_G = 8;           // query heads per KV head

// keys per tile; a CTA's split is NTILE tiles
// (ops/paged_attention.py: SPLIT_KEYS)
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int TK = 64; };
template <> struct Tile<float> { static constexpr int TK = 32; };

struct Params {
  const void* q;          // [B, 1, Hq, D]
  const void* k;          // [null_id + 1, bt, Hkv, D]
  const void* v;
  const int* pos;         // [null_id + 1, bt]
  const int* tables;      // [B, M]
  const int* frontier;    // [B]
  void* o;                // [B, 1, Hq, D]
  float* part_o;          // [B, Hq, splits, D]
  float* part_ml;         // [B, Hq, splits, 2]: running max, sum
  int max_blocks, bt, null_id, hq, hkv, group, splits;
  float scale_log2;       // 1/sqrt(D) * log2(e): scores in base 2
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// keys of the row that attention can see: 0 .. p, cut at the row's end
__device__ __forceinline__ int live_keys(int p, int row_len) {
  return p < 0 ? 0 : min(p + 1, row_len);
}

// 16-byte global -> shared copy; zero-fills (reads nothing) when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// q (float, pre-scaled) . one K row in shared memory, sequential over D
template <int D>
__device__ __forceinline__ float dot_row(const float* q,
                                         const __nv_bfloat16* row) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 u = r[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      s = fmaf(q[c * 8 + 2 * e], f.x, s);
      s = fmaf(q[c * 8 + 2 * e + 1], f.y, s);
    }
  }
  return s;
}
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 f = r[c];
    s = fmaf(q[c * 4], f.x, s);
    s = fmaf(q[c * 4 + 1], f.y, s);
    s = fmaf(q[c * 4 + 2], f.z, s);
    s = fmaf(q[c * 4 + 3], f.w, s);
  }
  return s;
}

template <typename T, int D>
struct Layout {
  static constexpr int TK = Tile<T>::TK;
  static constexpr int SPLIT = NTILE * TK;        // keys per CTA
  static constexpr int LD = D + 16 / sizeof(T);   // row pad: 16 bytes
  static constexpr int CH = D * sizeof(T) / 16;   // 16-byte chunks a row
  static constexpr size_t kv_tile = size_t(TK) * LD * sizeof(T);
  // K and V, NTILE tiles each; then floats: q [G][D], scores [G][TK],
  // m, l, alpha [MAX_G]; then ints: pid [SPLIT], visible [SPLIT]
  static constexpr size_t bytes(int g) {
    return 2 * NTILE * kv_tile +
           sizeof(float) * (size_t(g) * D + size_t(g) * TK + 3 * MAX_G) +
           sizeof(int) * 2 * SPLIT;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_split(Params p) {
  using L = Layout<T, D>;
  constexpr int TK = L::TK, LD = L::LD, CH = L::CH, SK = L::SPLIT;
  constexpr int RMAX = MAX_G * D / NT;   // (head, column) pairs a thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                  // [NTILE][TK][LD]
  T* sV = sK + NTILE * TK * LD;                        // [NTILE][TK][LD]
  float* sQ = reinterpret_cast<float*>(sV + NTILE * TK * LD);   // [G][D]
  float* sS = sQ + p.group * D;                        // [G][TK]
  float* sM = sS + p.group * TK;                       // [MAX_G]
  float* sL = sM + MAX_G;
  float* sAlpha = sL + MAX_G;
  int* sPid = reinterpret_cast<int*>(sAlpha + MAX_G);  // [SK]
  int* sVis = sPid + SK;                               // [SK]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.group;
  const int frontier = p.frontier[b];
  const int n_keys = live_keys(frontier, p.max_blocks * p.bt);
  const int k_begin = split * SK;
  const int k_end = min(k_begin + SK, n_keys);
  if (k_begin >= k_end) return;   // the merge reads only live splits
  const int ntiles = (k_end - k_begin + TK - 1) / TK;
  const int64_t row_stride = int64_t(p.hkv) * D;      // elements per key

  // 1. the split's table entries, once, all keys in parallel (a key
  // outside the split or on an unmapped entry gets pid -1), and q
  for (int i = tid; i < SK; i += NT) {
    const int kk = k_begin + i;
    int pid = -1;
    if (kk < k_end) {
      const int id = p.tables[int64_t(b) * p.max_blocks + kk / p.bt];
      if (id >= 0 && id < p.null_id) pid = id;
    }
    sPid[i] = pid;
  }
  const T* q = static_cast<const T*>(p.q) + (int64_t(b) * p.hq + kvh * G) * D;
  for (int e = tid; e < G * D; e += NT) sQ[e] = to_f(q[e]) * p.scale_log2;
  if (tid < MAX_G) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  __syncthreads();

  // 2. every tile's K and V rows in flight at once, one copy group per
  // tile (16 bytes a copy; unmapped keys zero-filled, not read) ...
  const T* kbase = static_cast<const T*>(p.k) + int64_t(kvh) * D;
  const T* vbase = static_cast<const T*>(p.v) + int64_t(kvh) * D;
  for (int t = 0; t < NTILE; ++t) {
    if (t < ntiles) {
      for (int c = tid; c < 2 * TK * CH; c += NT) {
        const int which = c / (TK * CH);          // 0: K, 1: V
        const int r = (c / CH) % TK;
        const int ch = c % CH;
        const int i = t * TK + r;
        const int pid = sPid[i];
        const T* src = which ? vbase : kbase;
        if (pid >= 0)
          src += (int64_t(pid) * p.bt + (k_begin + i) % p.bt) * row_stride +
                 ch * (16 / sizeof(T));
        T* dst = (which ? sV : sK) + (t * TK + r) * LD + ch * (16 / sizeof(T));
        cp_async16(dst, src, pid >= 0);
      }
    }
    cp_async_commit();                  // an empty group past ntiles
  }
  // ... while the positions load: the visibility rule of each key
  for (int i = tid; i < SK; i += NT) {
    const int pid = sPid[i];
    int vis = 0;
    if (pid >= 0) {
      const int kk = k_begin + i;
      const int ps = p.pos[int64_t(pid) * p.bt + kk % p.bt];
      vis = ps >= 0 && ps / p.bt == kk / p.bt && ps <= frontier;
    }
    sVis[i] = vis;
  }

  float acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t == 0) cp_async_wait<NTILE - 1>(); else cp_async_wait<0>();
    __syncthreads();                 // tile t (and sVis) visible to all

    for (int e = tid; e < TK * G; e += NT) {
      const int i = e % TK, g = e / TK;
      sS[g * TK + i] = sVis[t * TK + i]
                           ? dot_row<D>(sQ + g * D, sK + (t * TK + i) * LD)
                           : -INFINITY;
    }
    __syncthreads();

    // online softmax (base 2), one warp per head
    for (int g = warp; g < G; g += NT / 32) {
      float* srow = sS + g * TK;
      float mx = -INFINITY;
      for (int i = lane; i < TK; i += 32) mx = fmaxf(mx, srow[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f, alpha = 1.f;
      if (m_new == -INFINITY) {      // nothing visible yet
        for (int i = lane; i < TK; i += 32) srow[i] = 0.f;
      } else {
        for (int i = lane; i < TK; i += 32) {
          const float e = exp2f(srow[i] - m_new);   // masked: 0
          srow[i] = e;
          sum += e;
        }
        alpha = exp2f(m_old - m_new);                // first: 0
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        sM[g] = m_new;
        sL[g] = sL[g] * alpha + sum;
        sAlpha[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int e = tid + r * NT;
      if (e < G * D) {
        const int g = e / D, c = e % D;
        const float* prow = sS + g * TK;
        const T* vcol = sV + t * TK * LD + c;
        float a = acc[r] * sAlpha[g];
#pragma unroll 8
        for (int i = 0; i < TK; ++i) a = fmaf(prow[i], to_f(vcol[i * LD]), a);
        acc[r] = a;
      }
    }
    // the next tile's barrier orders these reads of sS before its writes
  }

  const int64_t part = (int64_t(b) * p.hq + kvh * G) * p.splits + split;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int e = tid + r * NT;
    if (e < G * D) {
      const int g = e / D, c = e % D;
      p.part_o[(part + int64_t(g) * p.splits) * D + c] = acc[r];
    }
  }
  if (tid < G) {
    p.part_ml[(part + int64_t(tid) * p.splits) * 2] = sM[tid];
    p.part_ml[(part + int64_t(tid) * p.splits) * 2 + 1] = sL[tid];
  }
}

// one CTA per (row, head), one thread per column: merge the row's live
// splits in order 0, 1, ... (a count set by its own p alone)
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_decode_merge(Params p) {
  const int bh = blockIdx.x;
  const int b = bh / p.hq;
  const int c = threadIdx.x;
  const int n_keys = live_keys(p.frontier[b], p.max_blocks * p.bt);
  const int n = (n_keys + Layout<T, D>::SPLIT - 1) / Layout<T, D>::SPLIT;
  const float* ml = p.part_ml + int64_t(bh) * p.splits * 2;
  const float* po = p.part_o + int64_t(bh) * p.splits * D;
  float m = -INFINITY;
  for (int s = 0; s < n; ++s) m = fmaxf(m, ml[2 * s]);
  float out = 0.f;
  if (m != -INFINITY) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = exp2f(ml[2 * s] - m);
      l = fmaf(ml[2 * s + 1], w, l);
      a = fmaf(po[int64_t(s) * D + c], w, a);
    }
    out = l > 0.f ? a / l : 0.f;
  }
  store(static_cast<T*>(p.o) + int64_t(bh) * D + c, out);
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<T, D>;
  if (p.splits != (p.max_blocks * p.bt + L::SPLIT - 1) / L::SPLIT)
    return cudaErrorInvalidValue;
  // once per instantiation: room for the largest group
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes(MAX_G)));
  if (attr != cudaSuccess) return attr;
  dim3 grid(p.splits, p.hkv, batch);
  paged_decode_split<T, D><<<grid, NT, L::bytes(p.group), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_merge<T, D><<<batch * p.hq, D, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launches (0 on success). All tensors
// contiguous; `splits` must be ceil(max_blocks * bt / keys per CTA) (128
// in bf16, 64 in float32), the size of the partial buffers' split axis.
// is_bf16: 1 for bfloat16, 0 for float32.
extern "C" int cake_paged_decode_fwd(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* frontier, void* o, void* part_o,
    void* part_ml, int batch, int max_blocks, int bt, int null_id, int hq,
    int hkv, int d, int splits, float scale_log2, int is_bf16,
    void* stream) {
  if (batch <= 0 || max_blocks <= 0 || bt <= 0 || null_id <= 0 ||
      hkv <= 0 || hq % hkv || hq / hkv > MAX_G)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.pos = static_cast<const int*>(pos);
  p.tables = static_cast<const int*>(tables);
  p.frontier = static_cast<const int*>(frontier);
  p.o = o;
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.max_blocks = max_blocks; p.bt = bt; p.null_id = null_id;
  p.hq = hq; p.hkv = hkv; p.group = hq / hkv; p.splits = splits;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d == 128) return static_cast<int>(launch<__nv_bfloat16, 128>(p, batch, s));
    if (d == 64) return static_cast<int>(launch<__nv_bfloat16, 64>(p, batch, s));
  } else {
    if (d == 128) return static_cast<int>(launch<float, 128>(p, batch, s));
    if (d == 64) return static_cast<int>(launch<float, 64>(p, batch, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
