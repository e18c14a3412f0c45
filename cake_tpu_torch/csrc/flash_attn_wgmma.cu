// Flash prefill attention for Hopper (sm_90a), bfloat16, on the tensor
// cores. Plain C entry point, bound with ctypes by ops/flash.py.
//
// Replaces cake_tpu/ops/flash.py:_flash_kernel (the Pallas TPU kernel) on
// the bfloat16 route; csrc/flash_attn.cu (3xTF32) is the float32 route.
// Same function: causal GQA attention over [B, S, H, D] tensors given by
// their strides, with the reference's masks
//   key valid   iff k_pos < kv_len       (kv_len = min(q_offset + valid_len, Skv))
//   causal      iff k_pos <= q_pos       (q_pos = q_offset + query index)
//   window      iff k_pos >  q_pos - window   (window > 0 only)
// scale 1/sqrt(D) (folded with log2(e) into exp2f), scores, running max and
// sum and the output accumulator in float32, output in bfloat16.
//
// What bounds it on an H100: at the flagship chunk (Sq = 256, Hq/Hkv =
// 16/8, D = 128) the least time is set by bytes (q and o once, K/V rows
// below the limit once: ~1 us at 3.35 TB/s); the FLOPs (4 * visible pairs *
// Hq * D, ~0.3 us at 989 TFLOP/s of bf16 wgmma) come second. What it
// really pays is latency: one CTA walks at most 8 K/V tiles in append
// mode, each a serial chain of S = Q.K^T, softmax and P.V on one SM.
//
// Design, against the five limits of the FMA kernel:
//  1. Tensor cores. S = Q.K^T is wgmma m64n64k16 with Q and the K tile both
//     read from shared memory K-major (rows contiguous in D, no transpose).
//     O += P.V takes P from registers: the float32 S accumulator, rescaled
//     and rounded to bf16, is already a 16-bit A-register fragment
//     (registers d[8kk..8kk+7] are the A operand of k-step kk); V is an
//     MN-major B operand (trans-b). Rounding P to bf16 is the one numeric
//     change from the reference, which keeps P in float32: a relative error
//     of at most 2^-9 per weight, well inside the bf16 output tolerance.
//  2. Asynchronous, overlapped copies. One producer warp (a warpgroup at
//     D = 256, see Layout) issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, D / 64 boxes of 64 columns
//     per row) of K and V tiles into a ring of NSTAGE slots completed
//     on mbarriers; the consumer warpgroup that read a slot releases it
//     when its two products are done. K and V have their own barriers, so
//     Q.K^T starts while V is still in flight.
//  3. bf16 tiles, no padding, and more warps: Q 16 KB, each K or V tile
//     16 KB at D = 128, 178 KB in all with 4 stages and the merge buffer;
//     at D = 256 (Gemma3) Q and each tile are 32 KB, the ring has 2 stages
//     and the merge buffer reuses it (Layout below), 161 KB in all, and a
//     consumer thread holds a 64 x 256 f32 accumulator fragment (128
//     registers) beside S (32) and P (16), in the 240 registers that
//     setmaxnreg gives it.
//     Swizzling instead of padding keeps wgmma reads free of bank
//     conflicts. Two consumer warpgroups own the same 64 rows and take
//     alternate tiles, each with its own running max, sum and accumulator,
//     merged through shared memory at the end: one group's softmax runs
//     while the other's wgmma does, and the serial chain per CTA halves.
//  4. Packed GQA rows. One CTA owns one KV head and 64 packed rows, row r =
//     (query index pos0 + r / G, head kvh * G + r % G), so each K/V tile is
//     read once for all G query heads of the group. With contiguous heads a
//     3-D box (64 columns, G heads, 64 / G positions) loads the packed Q
//     tile directly, and the same box stores O from shared memory.
//     At the flagship there are 4096 packed rows: 64 CTAs of 64 rows on
//     132 SMs, one CTA per SM. The K range is split inside the CTA (the
//     two warpgroups of 3.), not across CTAs: a second pass to combine
//     CTAs would cost a launch, about as long as the kernel (PERF.md).
//  5. One-time set-up: the shared-memory attribute is set once per
//     instantiation (a function-local static), not on every launch. The
//     tensor maps are encoded per call on the host (a few hundred ns).
//
// Tile range (mirrors FlashPlan in ops/flash.py, whose CPU tests check that
// it covers every visible pair): tiles wholly above the diagonal, below the
// window or past kv_len are never loaded; masks are computed from fragment
// coordinates only on tiles that cross one of those edges.

#include <cuda_bf16.h>

#include "tma.cuh"

namespace {

constexpr int BM = 64;                  // packed rows per CTA (wgmma M)
constexpr int BN = 64;                  // keys per K/V tile
constexpr int NWG = 2;                  // consumer warpgroups, alternate tiles
constexpr int NCONSUMER = 128 * NWG;
constexpr int SMEM_LIMIT = 232448;         // bytes a block may use (H100)
// D = 256: registers the producer warpgroup keeps and each consumer
// thread gets (setmaxnreg; 128 x 24 + 256 x 240 <= 65,536)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float kNeg = -1e30f;

// Shared memory of one CTA at head dimension D. The K/V ring holds NSTAGE
// slots (a multiple of NWG, so each slot is read by one warpgroup only and
// its barrier phases follow that group's tiles in order). At D = 256 a
// 4-slot ring alone (256 KB) exceeds a block's shared memory, so the ring
// has 2 slots and the merge buffer lives in the ring, which is drained
// once both warpgroups are past their last tile: 161 KB in all (ops/
// flash.py: FlashPlan.smem_bytes and .threads mirror this, and the entry
// point refuses a plan that does not).
template <int D>
struct Layout {
  static constexpr int NSTAGE = D == 256 ? 2 : 4;   // K/V ring depth
  static constexpr bool MERGE_IN_RING = D == 256;
  // At D = 256 a consumer thread holds a 64 x 256 f32 accumulator
  // fragment (128 registers) beside S, P and the softmax state. With a
  // producer warp the CTA has 9 warps, 3 of them on one of the SM's four
  // register-file quarters, so ptxas may give each thread only 168
  // registers and spills. A producer warpgroup instead hands its
  // registers to the consumers with setmaxnreg.
  static constexpr bool REG_SPLIT = D == 256;
  static constexpr int THREADS = NCONSUMER + (REG_SPLIT ? 128 : 32);
  static constexpr int HALVES = D / 64;        // 128-byte column blocks
  static constexpr int Q_HALF = BM * 128;      // bytes of one Q column block
  static constexpr int KV_HALF = BN * 128;
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int KV_BYTES = HALVES * KV_HALF;   // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + NSTAGE * KV_BYTES;
  static constexpr int RING_END = V_OFF + NSTAGE * KV_BYTES;
  // warpgroup 1's o, m and l for the merge, [register][thread] in f32
  static constexpr int MERGE_REGS = HALVES * 32 + 4;
  static constexpr int MERGE_BYTES = MERGE_REGS * 128 * 4;
  static constexpr int MERGE_OFF = MERGE_IN_RING ? K_OFF : RING_END;
  static constexpr int BAR_OFF =
      MERGE_IN_RING ? RING_END : RING_END + MERGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * NSTAGE);
  static constexpr int ALLOC = BYTES + 1024;   // base aligned up to 1024
  static_assert(NSTAGE % NWG == 0, "each ring slot belongs to one group");
  static_assert(!MERGE_IN_RING || MERGE_BYTES <= RING_END - K_OFF,
                "the merge buffer must fit in the ring");
  static_assert(ALLOC <= SMEM_LIMIT, "shared memory of one block");
};

struct Params {
  int sq, group, positions;   // positions: query indices per CTA (BM / G)
  int causal, window, q_offset, kv_len;
  float scale_log2;           // scale * log2(e)
};

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. Byte offsets are
// stored in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// MN-major operand (V, 64 columns of D per instruction): one swizzle atom
// along N, 8-key groups 1024 bytes apart along K.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return smem_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accumulator reads across the wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define WG_OUT32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64x64] (+)= A[64x16] . B[16x64], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_OUT32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64x64] += A[64x16] (registers) . B[16x64] (shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- the kernel --------------------------------------------------------------

// Accumulator fragment of wgmma m64nN (f32): thread t of the warpgroup owns,
// for i in [0, N/2), row 16*(t/32) + (t%32)/4 + 8*((i>>1)&1) and column
// 8*(i/4) + 2*(t%4) + (i&1).

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
    flash_wgmma(__grid_constant__ const CUtensorMap tm_q,
                __grid_constant__ const CUtensorMap tm_k,
                __grid_constant__ const CUtensorMap tm_v,
                __grid_constant__ const CUtensorMap tm_o, const Params p) {
  using L = Layout<D>;
  constexpr int NSTAGE = L::NSTAGE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + NSTAGE + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * NSTAGE + s); };

  const int tid = threadIdx.x;
  const int pos0 = blockIdx.x * p.positions;   // first query index
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int last = min(pos0 + p.positions, p.sq) - 1;

  // tile range [lo, hi): FlashPlan.tile_range
  int hi_key = p.kv_len;
  if (p.causal) hi_key = min(hi_key, p.q_offset + last + 1);
  const int hi = hi_key > 0 ? (hi_key + BN - 1) / BN : 0;
  int lo = 0;
  if (p.window > 0) {
    const int first = p.q_offset + pos0 - p.window + 1;
    lo = first > 0 ? first / BN : 0;
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128);   // the warpgroup that read the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONSUMER) {   // producer warp(group): one lane issues every copy
    if constexpr (L::REG_SPLIT)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == NCONSUMER) {
      mbar_expect_tx(q_full, L::HALVES * 128 * p.group * p.positions);
      for (int h = 0; h < L::HALVES; ++h)
        tma_load_4d(sQ + h * L::Q_HALF, &tm_q, q_full, 64 * h,
                    kvh * p.group, pos0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = lo; kt < hi; ++kt) {
        mbar_wait(empty(stage), phase ^ 1u);
        const uint32_t k_dst = sK + stage * L::KV_BYTES;
        const uint32_t v_dst = sV + stage * L::KV_BYTES;
        mbar_expect_tx(k_full(stage), L::KV_BYTES);
        for (int h = 0; h < L::HALVES; ++h)
          tma_load_4d(k_dst + h * L::KV_HALF, &tm_k, k_full(stage), 64 * h,
                      kvh, kt * BN, b);
        mbar_expect_tx(v_full(stage), L::KV_BYTES);
        for (int h = 0; h < L::HALVES; ++h)
          tma_load_4d(v_dst + h * L::KV_HALF, &tm_v, v_full(stage), 64 * h,
                      kvh, kt * BN, b);
        if (++stage == NSTAGE) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  if constexpr (L::REG_SPLIT)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  // consumer warpgroups: both own the same 64 rows; group wg takes tiles
  // lo + wg, lo + wg + 2, ..., and group 1 hands its o, m, l to group 0
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = p.q_offset + pos0 + (16 * warp + g8 + 8 * h) / p.group;

  float o[L::HALVES][32];
#pragma unroll
  for (int hd = 0; hd < L::HALVES; ++hd)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hd][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this thread's part

  mbar_wait(q_full, 0);
  for (int kt = lo + wg; kt < hi; kt += NWG) {
    const int k0 = kt * BN;
    const int stage = (kt - lo) % NSTAGE;
    const uint32_t phase = ((kt - lo) / NSTAGE) & 1;
    const uint32_t k_src = sK + stage * L::KV_BYTES;
    const uint32_t v_src = sV + stage * L::KV_BYTES;

    // S = Q . K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(k_full(stage), phase);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < L::HALVES; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_kmajor(sQ + h * L::Q_HALF + 32 * kk),
                 desc_kmajor(k_src + h * L::KV_HALF + 32 * kk), h | kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // masks, only on tiles that cross the diagonal, window or limit
    // (FlashPlan.tile_masked)
    const bool full = k0 + BN <= p.kv_len &&
                      (!p.causal || k0 + BN - 1 <= p.q_offset + pos0) &&
                      (p.window <= 0 || k0 > p.q_offset + last - p.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= p.scale_log2;
    if (!full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        const int qp = qpos[(i >> 1) & 1];
        const bool vis = kp < p.kv_len && (!p.causal || kp <= qp) &&
                         (p.window <= 0 || kp > qp - p.window);
        if (!vis) s[i] = kNeg;
      }
    }

    // online softmax on the fragment; each row lives in one quad of lanes
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
    uint32_t pa[16];   // P in bf16: pa[4kk..4kk+3] is k-step kk's A operand
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int h = j & 1;
      const float e0 = exp2f(s[2 * j] - m[h]);
      const float e1 = exp2f(s[2 * j + 1] - m[h]);
      rs[h] += e0 + e1;
      pa[j] = pack_bf16(e0, e1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int hd = 0; hd < L::HALVES; ++hd)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hd][i] *= alpha[(i >> 1) & 1];

    // O += P . V
    mbar_wait(v_full(stage), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hd = 0; hd < L::HALVES; ++hd)
        wgmma_rs(o[hd], pa + 4 * kk,
                 desc_mnmajor(v_src + hd * L::KV_HALF + 16 * 128 * kk));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int hd = 0; hd < L::HALVES; ++hd) fence_regs(o[hd]);
    mbar_arrive(empty(stage));
  }

  // merge: group 1's partial state through shared memory into group 0's
  float* merge = reinterpret_cast<float*>(sbase + L::MERGE_OFF) + tid % 128;
  if constexpr (L::MERGE_IN_RING) {
    // the buffer is the ring: wait until both groups are past their last
    // tile (every copy landed and was read, no wgmma in flight)
    asm volatile("bar.sync 1, %0;" ::"n"(NCONSUMER) : "memory");
  }
  if (wg == 1) {
#pragma unroll
    for (int hd = 0; hd < L::HALVES; ++hd)
#pragma unroll
      for (int i = 0; i < 32; ++i) merge[128 * (32 * hd + i)] = o[hd][i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      merge[128 * (L::MERGE_REGS - 4 + h)] = m[h];
      merge[128 * (L::MERGE_REGS - 2 + h)] = l[h];
    }
  }
  // both groups are past their last read of Q and group 1's state is in
  asm volatile("bar.sync 1, %0;" ::"n"(NCONSUMER) : "memory");
  if (wg == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = merge[128 * (L::MERGE_REGS - 4 + h)];
    const float mm = fmaxf(m[h], m1);
    a0[h] = exp2f(m[h] - mm);
    a1[h] = exp2f(m1 - mm);
    l[h] = l[h] * a0[h] + merge[128 * (L::MERGE_REGS - 2 + h)] * a1[h];
  }
#pragma unroll
  for (int hd = 0; hd < L::HALVES; ++hd)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      o[hd][i] = o[hd][i] * a0[h] + merge[128 * (32 * hd + i)] * a1[h];
    }

  // epilogue: O / l in bf16 into the Q buffer (same swizzled layout), then
  // one TMA store of the packed box; rows past Sq are clipped by TMA.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int hd = 0; hd < L::HALVES; ++hd)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g8 + 8 * h;
        const int off = hd * L::Q_HALF + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(sbase + off) =
            pack_bf16(o[hd][4 * j + 2 * h] * inv[h],
                      o[hd][4 * j + 2 * h + 1] * inv[h]);
      }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 2, 128;" ::: "memory");
  if (tid == 0) {
    for (int hd = 0; hd < L::HALVES; ++hd)
      tma_store(&tm_o, sQ + hd * L::Q_HALF, 64 * hd, kvh * p.group, pos0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// -- host side ---------------------------------------------------------------

// A [batch, seq, heads, D] bf16 view as a 4-D tensor map (D innermost),
// strides in bytes; boxes of 64 columns x box_heads x box_rows x 1.
CUresult encode(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
                int batch, long long sh, long long ss, long long sb,
                int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sh), cuuint64_t(ss),
                                 cuuint64_t(sb)};
  const cuuint32_t box[4] = {64, cuuint32_t(box_heads), cuuint32_t(box_rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, dim3 grid,
                   int threads, int smem_bytes, cudaStream_t stream) {
  // the caller's plan must be this instantiation's layout
  if (threads != Layout<D>::THREADS || smem_bytes != Layout<D>::ALLOC)
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<D>::ALLOC);
  if (attr != cudaSuccess) return attr;
  flash_wgmma<D><<<grid, Layout<D>::THREADS, Layout<D>::ALLOC, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// Error codes beyond the CUDA runtime's: the encoder entry point was not
// found, or it refused a view (kErrEncode + the CUresult).
constexpr int kErrNoEncoder = 20000;
constexpr int kErrEncode = 30000;

// bf16 only. Strides are in BYTES, in the order (head, seq, batch) for each
// of q, k, v, o, and every one a multiple of 16 (TMA); positions is the
// number of query indices per CTA (64 / group); kv_len = min(q_offset +
// valid_len, skv); window <= 0 means none. Returns 0 on success.
extern "C" int cake_flash_wgmma_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int sq,
    int skv, int hq, int hkv, int d, long long q_sh, long long q_ss,
    long long q_sb, long long k_sh, long long k_ss, long long k_sb,
    long long v_sh, long long v_ss, long long v_sb, long long o_sh,
    long long o_ss, long long o_sb, int positions, int threads,
    int smem_bytes, float scale_log2, int causal, int window, int q_offset,
    int kv_len, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 ||
      hq % hkv || positions <= 0 || positions * (hq / hkv) > BM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  const int group = hq / hkv;
  CUtensorMap maps[4];
  CUresult r = encode(&maps[0], q, d, hq, sq, batch, q_sh, q_ss, q_sb, group,
                      positions);
  if (r == CUDA_SUCCESS)
    r = encode(&maps[1], k, d, hkv, skv, batch, k_sh, k_ss, k_sb, 1, BN);
  if (r == CUDA_SUCCESS)
    r = encode(&maps[2], v, d, hkv, skv, batch, v_sh, v_ss, v_sb, 1, BN);
  if (r == CUDA_SUCCESS)
    r = encode(&maps[3], o, d, hq, sq, batch, o_sh, o_ss, o_sb, group,
               positions);
  if (r != CUDA_SUCCESS) return kErrEncode + static_cast<int>(r);
  Params p;
  p.sq = sq;
  p.group = group;
  p.positions = positions;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.scale_log2 = scale_log2;
  const dim3 grid((sq + positions - 1) / positions, hkv, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {   // each head dimension its own instantiation; no other
    case 64:
      return static_cast<int>(launch<64>(maps, p, grid, threads, smem_bytes, s));
    case 128:
      return static_cast<int>(launch<128>(maps, p, grid, threads, smem_bytes, s));
    case 256:
      return static_cast<int>(launch<256>(maps, p, grid, threads, smem_bytes, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
