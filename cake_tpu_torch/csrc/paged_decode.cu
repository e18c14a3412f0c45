// Paged decode attention for Hopper (sm_90a), bf16, f16 and float32,
// plain C entry point.
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
// entry once for one query per head, about one FLOP per byte against the
// card's ~295 bf16 FLOPs per byte, so the least time is the live K/V bytes
// over 3.35 TB/s. No tensor cores: with one query row per head a wgmma
// tile would be 1/64 full and buy nothing the FMA pipes lack. The design
// aims at keeping the memory system busy from one launch:
//  a. One launch, a thread-block cluster per (row, KV head). Grid
//     (C, Hkv, B), clusters of C CTAs along x (C = 8, the portable size).
//     CTA rank r walks the row's live page blocks j = r, r + C, r + 2C, ...
//     (j < ceil((p + 1) / bt)) in ascending order with one online softmax
//     state per query head. At the end every rank pushes its (max, sum,
//     accumulator) into rank 0's shared memory (distributed shared memory)
//     and rank 0 merges them in rank order 0..C-1 and writes o. No partial
//     buffer in device memory, no second kernel, no atomic, no counter:
//     nothing survives a launch, so the launch can go into a CUDA graph.
//     Which keys a rank takes and the order of every sum depend only on
//     the row's own p, on bt and on C: a row's result is bit-identical
//     alone or in a batch, after its blocks move to other physical ids,
//     and from run to run.
//  b. A ring of page blocks fed by TMA. The K and V pools are 2-D tensor
//     maps [(NB + 1) * bt, Hkv * D]; one block of one KV head is one box
//     of bt rows x D columns, its bt positions one plain bulk copy. One
//     producer warp resolves the rank's table entries 32 at a time, ahead
//     of use, and keeps up to S blocks in flight (an mbarrier per stage,
//     completed by the copies' bytes) while the consumer warps compute.
//     Unmapped or NULL entries are never loaded: the producer flags the
//     stage empty and the consumers skip it.
//  c. Warps over keys, lanes over channels. Each lane owns 16 contiguous
//     bytes of a key row (8 bf16 or 4 float channels), or two such runs
//     512 bytes apart where a row is wider than a warp's load (float32 at
//     D = 256), each read with one 16-byte shared-memory load; a warp load
//     covers 1-4 whole rows or half of one, a
//     contiguous run of shared memory, so no swizzle is needed for
//     conflict-free reads (the boxes land unswizzled). q.k reduces over a
//     row's lanes with shuffles. Each consumer warp takes 4 keys of a
//     block per step, loads their K and V rows together, keeps its own
//     online softmax per head (exp2 on the MUFU unit, scale folded with
//     log2(e) into q), accumulates P.V in lane registers, and the warps
//     merge in warp order at the end, in float32 throughout.
//  d. No host sync: the kernel reads the frontier itself and the grid does
//     not depend on it. The launch plan (cluster size, stages, shared
//     memory bytes, grid) is computed in Python by PagedPlan
//     (ops/paged_attention.py) and checked here against the same layout.
// Where the time goes (PERF.md; bench/paged_timing.py --sweep): about
// 6.2 us fixed (the launch, the serial chain of frontier, table entries
// and first copies, and the merge), then about 0.75 us per block a rank
// walks, set by the consumers' chain of dependent steps up to p ~ 2000;
// at p = 4000 the copies take about as long as the compute.
// The visibility rule compares a position with the block's first one:
// an integer division per key there is a long dependent chain.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 4;                 // consumer warps
constexpr int NT = 32 * (NW + 1);     // + one producer warp
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int MAX_STAGES = 8;
constexpr int MAX_G = 8;              // query heads per KV head
constexpr int STEP_KEYS = 4;          // keys a warp takes per step
constexpr int SMEM_LIMIT = 232448;    // bytes a block may use on an H100
constexpr unsigned FULL = 0xffffffffu;

// A lane owns NV vectors of VEC channels (16 bytes each) of a key row:
// LPR lanes hold a row, one warp load covers KPL rows, a step is U loads
// = STEP_KEYS keys. A row wider than a warp's 512-byte load (float32 at
// D = 256: 1 KB) gives each lane NV = 2 vectors, STRIDE channels apart,
// so each of the lane's loads is still one contiguous warp-wide run.
template <typename T, int D>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LPR = D / VEC < 32 ? D / VEC : 32;
  static constexpr int NV = D / (VEC * LPR);
  static constexpr int CH = NV * VEC;        // channels a lane owns
  static constexpr int STRIDE = LPR * VEC;   // channels between its vectors
  static constexpr int KPL = 32 / LPR;
  static constexpr int U = STEP_KEYS / KPL;
  static_assert(NV * STRIDE == D && KPL * LPR == 32 && U * KPL == STEP_KEYS,
                "a row is whole lanes and a step whole loads");
};

// Channel of a lane's register e: vector e / VEC, lane slot cs.
template <typename LN>
__device__ __forceinline__ int lane_channel(int cs, int e) {
  return (e / LN::VEC) * LN::STRIDE + cs * LN::VEC + e % LN::VEC;
}

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Shared-memory layout, in bytes from a 128-aligned base (PagedPlan's
// smem_bytes mirrors it): the ring of S stages [K box | V box | positions],
// then full[S] and empty[S] mbarriers and a mapped flag per stage, then
// the consumer warps' states (m, l [NW][G], acc [NW][G][D]), then the
// cluster's slots in rank 0 (m, l [C][G], acc [C][G][D]); 128 bytes of
// slack let the kernel align the base.
struct Smem {
  int kv, pos, stage, bars, warps, slots, total;
};

__host__ __device__ inline Smem smem_layout(int stages, int bt, int d,
                                            int elem, int g, int cluster) {
  Smem s;
  s.kv = align128(bt * d * elem);
  s.pos = align128(bt * 4);
  s.stage = 2 * s.kv + s.pos;
  s.bars = stages * s.stage;
  s.warps = s.bars + align128(stages * (8 + 8 + 4));
  s.slots = s.warps + align128(NW * g * (d + 2) * 4);
  s.total = s.slots + cluster * g * (d + 2) * 4 + 128;
  return s;
}

struct Params {
  const void* q;          // [B, 1, Hq, D]
  const int* pos;         // [null_id + 1, bt]
  const int* tables;      // [B, M]
  const int* frontier;    // [B]
  void* o;                // [B, 1, Hq, D]
  int max_blocks, bt, null_id, hq, hkv, group, cluster, stages;
  float scale_log2;       // 1/sqrt(D) * log2(e): scores in base 2
};

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}
__device__ __forceinline__ void load_vec(const __half* src, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __half22float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}
__device__ __forceinline__ void load_vec(const float* src, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
// The lane's NV vectors of a row (src already at the lane's first channel).
template <typename LN, typename T>
__device__ __forceinline__ void load_lane(const T* src,
                                          float (&f)[LN::CH]) {
#pragma unroll
  for (int n = 0; n < LN::NV; ++n) {
    float x[LN::VEC];
    load_vec(src + n * LN::STRIDE, x);
#pragma unroll
    for (int e = 0; e < LN::VEC; ++e) f[n * LN::VEC + e] = x[e];
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// 2^x on the MUFU unit. Flushes results below 2^-126 to zero: such a
// weight vanishes beside the running sum, which is at least 1 (the
// largest score's own weight).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Merge n online-softmax states (m, l, acc) in order 0..n-1; a state with
// m = -inf (nothing seen) weighs 0. Returns (m, l, acc).
__device__ __forceinline__ float3 merge_states(const float* m, const float* l,
                                               const float* a, int n,
                                               int stride_ml, int stride_a) {
  float mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, m[i * stride_ml]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float ls = 0.f, as = 0.f;
  for (int i = 0; i < n; ++i) {
    const float w = fast_exp2(m[i * stride_ml] - mu);
    ls = fmaf(l[i * stride_ml], w, ls);
    as = fmaf(a[i * stride_a], w, as);
  }
  return make_float3(mx, ls, as);
}

// GM: a compile-time bound on the group size G (2, 4 or 8).
template <typename T, int D, int GM>
__global__ void __launch_bounds__(NT) paged_decode(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using LN = Lanes<T, D>;
  constexpr int VEC = LN::VEC, LPR = LN::LPR, KPL = LN::KPL, U = LN::U;
  constexpr int CH = LN::CH;
  constexpr int EPT = (GM * D + 32 * NW - 1) / (32 * NW);  // merge elements
  // aligned by an offset from the shared pointer, not by integer casts,
  // so the compiler keeps every access below a shared-memory one (LDS)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);

  cluster_arrive_relaxed();     // paired with the wait before the push

  const int G = p.group, bt = p.bt, S = p.stages, C = p.cluster;
  const Smem L = smem_layout(S, bt, D, sizeof(T), G, C);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + S;
  int* mapped = reinterpret_cast<int*>(empty + S);
  float* wm = reinterpret_cast<float*>(smem + L.warps);    // [NW][G]
  float* wl = wm + NW * G;
  float* wacc = wl + NW * G;                               // [NW][G][D]
  float* cm = reinterpret_cast<float*>(smem + L.slots);    // [C][G]
  float* cl = cm + C * G;
  float* cacc = cl + C * G;                                // [C][G][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the row's live blocks (set by its own p) and this rank's share
  const int front = p.frontier[b];
  const int nkeys = front < 0 ? 0 : min(front + 1, p.max_blocks * bt);
  const int nblk = (nkeys + bt - 1) / bt;
  const int mine = nblk > rank ? (nblk - rank + C - 1) / C : 0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float res_m[EPT], res_l[EPT], res_a[EPT];   // this CTA's merged state

  if (warp == NW) {
    // producer: table entries 32 at a time, one per lane, ahead of use;
    // lane 0 issues each block's copies once its stage is free
    const int* trow = p.tables + int64_t(b) * p.max_blocks;
    const int kv_bytes = bt * D * int(sizeof(T));
    for (int t0 = 0; t0 < mine; t0 += 32) {
      const int id = t0 + lane < mine ? trow[rank + (t0 + lane) * C] : -1;
      const int n = min(32, mine - t0);
      for (int i = 0; i < n; ++i) {
        const int pid = __shfl_sync(FULL, id, i);
        const int t = t0 + i, s = t % S;
        mbar_wait(smem_u32(empty + s), ((t / S) & 1) ^ 1);
        if (lane == 0) {
          const bool live = pid >= 0 && pid < p.null_id;
          const uint32_t bar = smem_u32(full + s);
          mapped[s] = live;
          if (live) {
            unsigned char* st = smem + s * L.stage;
            mbar_expect_tx(bar, 2 * kv_bytes + bt * 4);
            tma_load_2d(smem_u32(st), &tm_k, bar, kvh * D, pid * bt);
            tma_load_2d(smem_u32(st + L.kv), &tm_v, bar, kvh * D, pid * bt);
            bulk_load(smem_u32(st + 2 * L.kv), p.pos + int64_t(pid) * bt,
                      bt * 4, bar);
          } else {
            mbar_arrive(bar);
          }
        }
        __syncwarp();
      }
    }
  } else {
    // consumers: lane (kg, cs) holds channels cs * VEC + [0, VEC) of
    // each of its NV vectors (STRIDE apart) of key group kg; q for the
    // group's heads, pre-scaled, in registers
    const int cs = lane % LPR, kg = lane / LPR;
    const T* qrow = static_cast<const T*>(p.q) +
                    (int64_t(b) * p.hq + kvh * G) * D + cs * VEC;
    float qf[GM][CH], acc[GM][CH], m[GM], l[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        load_lane<LN>(qrow + g * D, qf[g]);
      } else {
#pragma unroll
        for (int e = 0; e < CH; ++e) qf[g][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        qf[g][e] *= p.scale_log2;
        acc[g][e] = 0.f;
      }
      m[g] = -INFINITY;
      l[g] = 0.f;
    }

    for (int t = 0; t < mine; ++t) {
      const int s = t % S;
      mbar_wait(smem_u32(full + s), (t / S) & 1);
      if (mapped[s]) {
        const int k0 = (rank + t * C) * bt;   // visible: k0 <= pos < k0 + bt
        const T* sk = reinterpret_cast<const T*>(smem + s * L.stage);
        const T* sv = reinterpret_cast<const T*>(smem + s * L.stage + L.kv);
        const int* sp =
            reinterpret_cast<const int*>(smem + s * L.stage + 2 * L.kv);
        for (int chunk = warp; chunk < bt / STEP_KEYS; chunk += NW) {
          // the step's K and V rows at once (V of a key that is not
          // visible as zeros), so the V loads overlap the score chain
          float sc[U][GM], vf[U][CH];
          bool vis[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = chunk * STEP_KEYS + u * KPL + kg;
            const int ps = sp[i];
            vis[u] = ps >= k0 && ps < k0 + bt && ps <= front;
            float kf[CH];
            load_lane<LN>(sk + i * D + cs * VEC, kf);
            load_lane<LN>(sv + i * D + cs * VEC, vf[u]);
#pragma unroll
            for (int e = 0; e < CH; ++e) vf[u][e] = vis[u] ? vf[u][e] : 0.f;
#pragma unroll
            for (int g = 0; g < GM; ++g) {
              float a0 = 0.f, a1 = 0.f;     // two chains of CH / 2
#pragma unroll
              for (int e = 0; e < CH; e += 2) {
                a0 = fmaf(qf[g][e], kf[e], a0);
                a1 = fmaf(qf[g][e + 1], kf[e + 1], a1);
              }
              sc[u][g] = a0 + a1;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int g = 0; g < GM; ++g) {
#pragma unroll
              for (int o = LPR / 2; o > 0; o >>= 1)
                sc[u][g] += __shfl_xor_sync(FULL, sc[u][g], o);
              if (!vis[u]) sc[u][g] = -INFINITY;
            }
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            float mx = sc[0][g];
#pragma unroll
            for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u][g]);
#pragma unroll
            for (int o = 16; o >= LPR; o >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
            const float mn = fmaxf(m[g], mx);
            const float mu = mn == -INFINITY ? 0.f : mn;
            const float alpha = fast_exp2(m[g] - mu);   // first keys: 0
            m[g] = mn;
            l[g] *= alpha;
#pragma unroll
            for (int e = 0; e < CH; ++e) acc[g][e] *= alpha;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              sc[u][g] = fast_exp2(sc[u][g] - mu);      // masked: 0
              l[g] += sc[u][g];
#pragma unroll
              for (int e = 0; e < CH; ++e)
                acc[g][e] = fmaf(sc[u][g], vf[u][e], acc[g][e]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + s));
    }

    // the warp's state: sum l and acc over its key groups, then publish
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1) {
        l[g] += __shfl_xor_sync(FULL, l[g], o);
#pragma unroll
        for (int e = 0; e < CH; ++e)
          acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
      }
      if (g < G && kg == 0) {
#pragma unroll
        for (int e = 0; e < CH; ++e)
          wacc[(warp * G + g) * D + lane_channel<LN>(cs, e)] = acc[g][e];
        if (cs == 0) {
          wm[warp * G + g] = m[g];
          wl[warp * G + g] = l[g];
        }
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(32 * NW) : "memory");
    // the CTA's state: the warps merged in warp order, one (g, c) each
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int e = tid + r * 32 * NW;
      if (e < G * D) {
        const int g = e / D, c = e % D;
        const float3 st = merge_states(wm + g, wl + g, wacc + g * D + c, NW,
                                       G, G * D);
        res_m[r] = st.x;
        res_l[r] = st.y;
        res_a[r] = st.z;
      }
    }
  }

  // every CTA of the cluster has started (its shared memory exists): push
  // this rank's state into rank 0's slot, then let rank 0 merge
  cluster_wait();
  if (warp < NW) {
    float* dm = cluster.map_shared_rank(cm, 0);
    float* dl = cluster.map_shared_rank(cl, 0);
    float* da = cluster.map_shared_rank(cacc, 0);
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int e = tid + r * 32 * NW;
      if (e < G * D) {
        const int g = e / D, c = e % D;
        da[(rank * G + g) * D + c] = res_a[r];
        if (c == 0) {
          dm[rank * G + g] = res_m[r];
          dl[rank * G + g] = res_l[r];
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();
  if (rank == 0 && warp < NW) {
    T* orow = static_cast<T*>(p.o) + (int64_t(b) * p.hq + kvh * G) * D;
#pragma unroll
    for (int r = 0; r < EPT; ++r) {
      const int e = tid + r * 32 * NW;
      if (e < G * D) {
        const int g = e / D, c = e % D;
        const float3 st = merge_states(cm + g, cl + g, cacc + g * D + c, C,
                                       G, G * D);
        store(orow + e, st.y > 0.f ? st.z / st.y : 0.f);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

// The element types by dtype code: 0 float32, 1 bfloat16, 2 float16.
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// One pool ([rows = (null_id + 1) * bt, Hkv * D], row-major) as a 2-D
// tensor map whose box is one page block of one KV head: D columns x bt
// rows, unswizzled.
CUresult encode_pool(CUtensorMap* map, const void* ptr, int dtype, int rows,
                     int hkv, int d, int bt) {
  const int elem = dtype == kF32 ? 4 : 2;
  const cuuint64_t dims[2] = {cuuint64_t(hkv) * d, cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(hkv) * d * elem};
  const cuuint32_t box[2] = {cuuint32_t(d), cuuint32_t(bt)};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(
      map, dtype == kBF16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
           : dtype == kF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Launch, or with `clusters` set only ask how many clusters of this launch
// can be resident at once (cudaOccupancyMaxActiveClusters).
template <typename T, int D, int GM>
cudaError_t launch(const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int batch, int smem, cudaStream_t stream,
                   int* clusters) {
  auto kernel = paged_decode<T, D, GM>;
  static int smem_set = 0;     // the largest size granted so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.hkv, batch);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, tk, tv, p);
}

template <typename T, int D>
cudaError_t launch_group(const CUtensorMap& tk, const CUtensorMap& tv,
                         const Params& p, int batch, int smem,
                         cudaStream_t stream, int* clusters) {
  if (p.group <= 2) return launch<T, D, 2>(tk, tv, p, batch, smem, stream, clusters);
  if (p.group <= 4) return launch<T, D, 4>(tk, tv, p, batch, smem, stream, clusters);
  return launch<T, D, 8>(tk, tv, p, batch, smem, stream, clusters);
}

// Each head dimension its own instantiation; any other is refused.
template <typename T>
cudaError_t launch_dim(int d, const CUtensorMap& tk, const CUtensorMap& tv,
                       const Params& p, int batch, int smem,
                       cudaStream_t stream, int* clusters) {
  switch (d) {
    case 64:
      return launch_group<T, 64>(tk, tv, p, batch, smem, stream, clusters);
    case 128:
      return launch_group<T, 128>(tk, tv, p, batch, smem, stream, clusters);
    case 256:
      return launch_group<T, 256>(tk, tv, p, batch, smem, stream, clusters);
  }
  return cudaErrorInvalidValue;
}

// Error codes beyond the CUDA runtime's: the encoder entry point was not
// found, or it refused a pool (kErrEncode + the CUresult).
constexpr int kErrNoEncoder = 20000;
constexpr int kErrEncode = 30000;

int run(const void* q, const void* k, const void* v, const void* pos,
        const void* tables, const void* frontier, void* o, int batch,
        int max_blocks, int bt, int null_id, int hq, int hkv, int d,
        int cluster, int stages, int smem_bytes, float scale_log2,
        int dtype, void* stream, int* clusters) {
  const int elem = dtype == kF32 ? 4 : 2;
  if (dtype < kF32 || dtype > kF16 || batch <= 0 || max_blocks <= 0 || bt <= 0 || bt % STEP_KEYS ||
      bt > 256 || null_id <= 0 || hkv <= 0 || hq % hkv ||
      hq / hkv > MAX_G || cluster < 1 ||
      cluster > MAX_CLUSTER || stages < 2 || stages > MAX_STAGES ||
      smem_bytes > SMEM_LIMIT ||
      smem_bytes != smem_layout(stages, bt, d, elem, hq / hkv, cluster).total)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  const int rows = (null_id + 1) * bt;
  CUtensorMap tk, tv;
  CUresult r = encode_pool(&tk, k, dtype, rows, hkv, d, bt);
  if (r == CUDA_SUCCESS) r = encode_pool(&tv, v, dtype, rows, hkv, d, bt);
  if (r != CUDA_SUCCESS) return kErrEncode + static_cast<int>(r);
  Params p;
  p.q = q;
  p.pos = static_cast<const int*>(pos);
  p.tables = static_cast<const int*>(tables);
  p.frontier = static_cast<const int*>(frontier);
  p.o = o;
  p.max_blocks = max_blocks; p.bt = bt; p.null_id = null_id;
  p.hq = hq; p.hkv = hkv; p.group = hq / hkv;
  p.cluster = cluster; p.stages = stages;
  p.scale_log2 = scale_log2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kBF16  ? launch_dim<__nv_bfloat16>(d, tk, tv, p, batch,
                                                  smem_bytes, s, clusters)
      : dtype == kF16 ? launch_dim<__half>(d, tk, tv, p, batch, smem_bytes, s,
                                           clusters)
                      : launch_dim<float>(d, tk, tv, p, batch, smem_bytes, s,
                                          clusters);
  return static_cast<int>(err);
}

}  // namespace

// Returns 0 on success, else the CUDA error code of the launch (or of the
// checks: cudaErrorInvalidValue) or one of the codes above. All tensors
// contiguous; k and v are [null_id + 1, bt, Hkv, D] pools, 16-byte
// aligned. cluster, stages and smem_bytes come from PagedPlan: smem_bytes
// must equal the kernel's own layout for them. dtype: 0 for float32, 1
// for bfloat16, 2 for float16 (q, the pools and o all of it).
extern "C" int cake_paged_decode_fwd(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* frontier, void* o, int batch,
    int max_blocks, int bt, int null_id, int hq, int hkv, int d, int cluster,
    int stages, int smem_bytes, float scale_log2, int dtype, void* stream) {
  return run(q, k, v, pos, tables, frontier, o, batch, max_blocks, bt,
             null_id, hq, hkv, d, cluster, stages, smem_bytes, scale_log2,
             dtype, stream, nullptr);
}

// The same arguments, no launch: writes the clusters of that launch that
// can be resident at once to *clusters.
extern "C" int cake_paged_decode_clusters(
    const void* q, const void* k, const void* v, const void* pos,
    const void* tables, const void* frontier, void* o, int batch,
    int max_blocks, int bt, int null_id, int hq, int hkv, int d, int cluster,
    int stages, int smem_bytes, float scale_log2, int dtype, void* stream,
    int* clusters) {
  return run(q, k, v, pos, tables, frontier, o, batch, max_blocks, bt,
             null_id, hq, hkv, d, cluster, stages, smem_bytes, scale_log2,
             dtype, stream, clusters);
}
