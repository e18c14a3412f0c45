// Flash prefill attention for Hopper (sm_90a), float32, on the tensor
// cores in 3xTF32. Plain C entry point, bound with ctypes by ops/flash.py.
//
// Replaces cake_tpu/ops/flash.py:_flash_kernel (the Pallas TPU kernel) on
// the float32 route; bfloat16 takes csrc/flash_attn_wgmma.cu. Same
// function: causal GQA attention over [B, S, H, D] tensors given by their
// strides, with the reference's masks
//   key valid   iff k_pos < kv_len       (kv_len = min(q_offset + valid_len, Skv))
//   causal      iff k_pos <= q_pos       (q_pos = q_offset + query index)
//   window      iff k_pos >  q_pos - window   (window > 0 only)
// scale folded with log2(e) into Q (exp2f), scores, running max and sum and
// the output accumulator in float32, output in float32.
//
// Float32 accuracy on TF32 tensor cores (3xTF32). One TF32 product keeps
// about three decimal digits, too few for the float32 tolerance (1e-4).
// Each operand is split as x = hi + lo, hi = x cut to TF32 (its top 19
// bits), lo = (x - hi) cut to TF32, and a product is taken as hi.hi +
// hi.lo + lo.hi with a float32 accumulator. The dropped lo.lo term and the
// cut of lo are each at most 2^-20 of the product, far inside the
// tolerance. Both products run so: S = Q.K^T and O += P.V.
//
// What bounds it on an H100: operations at the served shapes. A float32-
// accurate product costs three TF32 products, so the least time is
// 3 * 4 * visible pairs * Hq * D FLOPs over 495 TFLOP/s of TF32, against
// q, o and the K/V rows below the limit once each over 3.35 TB/s. mma.sync
// reaches about two thirds of that TF32 rate (bench/flash_variants.py
// measures it). What the kernel pays is one CTA's serial chain: a fixed
// prologue (Q) and merge, then a cost per tile its longest warp walks
// (bench/flash_sweep.py --dtype f32; PERF.md).
//
// Design:
//  1. Packed GQA rows. A CTA owns one KV head and ROWS = 16 packed rows
//     (one mma M): packed row R of KV head kvh is query index R / G and
//     head kvh * G + R % G, rows R = 16 * blockIdx.x .. + 15, so each K/V
//     tile is read once for all G heads of the group, any G fits, and no
//     row is padding except past Sq * G. 16 rows keep the grid wide:
//     Gemma-3-1B's chunk (Sq 256, 4/1) is 64 CTAs, the flagship's 256.
//  2. Split K inside the CTA, and over a cluster. NWARP = 4 warps own the
//     same 16 rows; warp w takes tiles lo + w, lo + w + 4, ..., each with
//     its own running max, sum and accumulator, merged in warp order
//     through shared memory at the end (a fixed order: two launches give
//     the same bits). Where the grid leaves SMs idle (Gemma-3-1B's 64 row
//     groups on 132 SMs) the plan gives each row group a cluster of two
//     CTAs: warp w of rank r takes every eighth tile from lo + 4r + w,
//     and rank 1 pushes its merged state into rank 0's shared memory
//     (distributed shared memory), which merges the two in rank order.
//  3. K/V tiles by TMA into per-warp rings. Each warp loads its own tiles
//     (lane x copies box x) into its own NSLOT slots, completed on one
//     mbarrier per slot, and reloads a slot as soon as its lanes are past
//     their reads (after S for K, after P.V for V), so the next tile's
//     copies overlap this one's products. A ring shared by the warps would
//     let a warp wait on a slot's phase two laps ahead, where a parity
//     wait cannot tell the phases apart; a ring per warp keeps each
//     barrier's phases in one warp's order. A tile is D / 32 boxes of 32
//     floats (128 bytes, 128-byte swizzle) by BK keys: at D 256, 3 slots
//     of 16 KB (BK 16) and one CTA per SM (230,496 bytes); below, 2 slots
//     of 8 KB (BK 16 at D 128, 32 at D 64), so that two CTAs share an SM.
//  4. Both products on mma.sync m16n8k8 TF32 (wgmma at TF32 wants both
//     operands K-major, and V as TMA lands it, [keys][D], is not for P.V).
//     Fragments are loaded by the threads, and the swizzle keeps every
//     fragment load free of bank conflicts: a K fragment reads 8 rows x 4
//     columns, a V fragment 4 row pairs x 8 columns, each 32 distinct
//     banks. Q is read from device memory once per CTA, scaled, split and
//     stored as A fragments (hi and lo, one 16-byte load each per k-step).
//     P goes from the S accumulator to an A fragment in registers: the
//     keys of a k-step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so
//     that thread (g, t) already holds its P fragment (c0, c2, c1, c3), and
//     V's fragment rows follow the same order. The softmax stays in
//     registers, one row per quad of lanes. S keeps separate accumulators
//     for the big and small products (and, for one or two n-tiles, for
//     alternate k-steps), so the tensor pipe has independent chains.
//  5. Occupancy: 4 warps per CTA, one per SM sub-partition, and no spills
//     (ptxas's report is printed by chip_smoke.py). 8 warps with 8 KB tiles
//     (shared memory cannot hold 16 KB tiles for 8 warps at D 256) re-read
//     Q per 8 keys and were no faster (bench/flash_variants.py); at
//     Gemma-3-1B's width the grid is smaller than the card, so more rows
//     per CTA would only lengthen each CTA's chain.
//
// Tile range (mirrors F32FlashPlan in ops/flash.py, whose CPU tests check
// that it covers every visible pair of every packed row): tiles wholly
// above the diagonal, below the window or past kv_len are never loaded;
// masks are applied only on tiles that cross one of those edges.

#include <cooperative_groups.h>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ROWS = 16;                 // packed rows per CTA (mma M)
constexpr int NWARP = 4;                 // warps, split K
constexpr int THREADS = 32 * NWARP;
constexpr int MAX_SPLIT = 2;             // CTAs (a cluster) per row group
constexpr int SMEM_LIMIT = 232448;       // bytes a block may use (H100)
constexpr float kNeg = -1e30f;

// Shared memory of one CTA at head dimension D (ops/flash.py:
// F32FlashPlan.smem_bytes and .threads mirror this; the entry point
// refuses a plan that does not).
template <int D>
struct Layout {
  // K/V tile slots of each warp and floats per tile: at D 256 three 16 KB
  // slots (one CTA per SM); below, two 8 KB slots, so that two CTAs share
  // an SM and one's prologue and merge overlap the other's tiles
  static constexpr int NSLOT = D == 256 ? 3 : 2;
  static constexpr int TILE_FLOATS = D == 256 ? 4096 : 2048;
  static constexpr int BK = TILE_FLOATS / D;   // keys per K/V tile
  static constexpr int BOXES = D / 32;         // 128-byte column blocks
  static constexpr int BOX_BYTES = BK * 128;
  static constexpr int TILE_BYTES = BOXES * BOX_BYTES;   // one K or V tile
  static constexpr int RING_BYTES = NWARP * NSLOT * TILE_BYTES;
  static constexpr int Q_BYTES = ROWS * D * 4;   // Q's hi or lo fragments
  static constexpr int QHI_OFF = RING_BYTES;
  static constexpr int QLO_OFF = QHI_OFF + Q_BYTES;
  static constexpr int BAR_OFF = QLO_OFF + Q_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * NWARP * NSLOT;
  static constexpr int ALLOC = BYTES + 1024;     // base aligned up to 1024
  // the merge buffer, in the drained ring and Q: each warp's o [16][D + 8]
  // (rows padded so the fragment stores hit distinct banks), then its
  // (m, l) per row
  static constexpr int MERGE_LD = D + 8;
  static constexpr int MERGE_BYTES = NWARP * ROWS * (MERGE_LD + 2) * 4;
  // rank 0's slots for the cluster's CTAs: o [rank][16][D], then m and l
  // [rank][16], after the merge buffer
  static constexpr int CB_OFF = MERGE_BYTES;
  static constexpr int CB_BYTES = MAX_SPLIT * ROWS * (D + 2) * 4;
  static constexpr int NT_S = BK / 8;       // n-tiles of S (keys)
  static constexpr int KS = D / 8;          // k-steps of S (channels)
  static constexpr int NT_O = D / 8;        // n-tiles of O (channels)
  static constexpr int KP = BK / 8;         // k-steps of P.V (keys)
  static constexpr int QTASK = 8 * KS;      // Q fragment tasks (g, kk)
  static constexpr int QT = (QTASK + THREADS - 1) / THREADS;   // per thread
  static constexpr int OV = ROWS * D / 4 / THREADS;   // output items per thread
  // S accumulator chains per n-tile and product size (at least 8 chains
  // in all, so the tensor pipe is not waiting on one accumulator)
  static constexpr int SPLIT = NT_S >= 4 ? 1 : 4 / NT_S;
  static_assert(BOX_BYTES % 1024 == 0, "boxes keep the swizzle's alignment");
  static_assert(CB_OFF + CB_BYTES <= BAR_OFF, "merge buffers fit ring and Q");
  static_assert(OV * THREADS * 4 == ROWS * D, "output items split evenly");
  static_assert(ALLOC <= SMEM_LIMIT, "shared memory of one block");
};

struct Params {
  const uint8_t* q;
  uint8_t* o;
  long long q_sh, q_ss, q_sb, o_sh, o_ss, o_sb;   // bytes
  int sq, group, causal, window, q_offset, kv_len;
  int split;          // CTAs (a cluster) per row group: 1 or 2
  float scale_log2;   // scale * log2(e)
};

// -- 3xTF32 ------------------------------------------------------------------

// x = hi + lo, both TF32 (the top 19 bits of a float32): hi is x cut to
// TF32, x - hi is exact in float32, lo is that cut to TF32. One LOP3 each:
// cvt.rna.tf32.f32 rounds instead, at about five instructions on sm_90a
// (it checks for NaN and infinity), which made the kernel markedly slower
// (bench/flash_variants.py) for half the split error, far below the
// tolerance either way.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t kTf32 = 0xffffe000u;
  hi = __float_as_uint(x) & kTf32;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32;
}

// d[16x8] += a[16x8] . b[8x8], TF32 in, float32 accumulator. Fragments
// (PTX ISA, m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   b0 (k t, n g), b1 (k t + 4, n g);
//   d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float lds(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// -- the kernel --------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tf32(__grid_constant__ const CUtensorMap tm_k,
               __grid_constant__ const CUtensorMap tm_v, const Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // the cluster's CTAs share a row group and split its tiles: warp w of
  // rank r is the (r * NWARP + w)-th of split * NWARP
  const int rank = blockIdx.x % p.split;
  const int vw = rank * NWARP + warp, nvw = p.split * NWARP;
  const int row0 = blockIdx.x / p.split * ROWS;   // first packed row
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nrows = p.sq * p.group;        // packed rows of this KV head
  const int first = row0 / p.group;
  const int last = min((row0 + ROWS - 1) / p.group, p.sq - 1);

  // tile range [lo, hi): F32FlashPlan.tile_range
  int hi_key = p.kv_len;
  if (p.causal) hi_key = min(hi_key, p.q_offset + last + 1);
  const int hi = hi_key > 0 ? (hi_key + L::BK - 1) / L::BK : 0;
  int lo = 0;
  if (p.window > 0) {
    const int start = p.q_offset + first - p.window + 1;
    lo = start > 0 ? start / L::BK : 0;
  }
  const int ntiles = hi - lo;

  // This warp's ring: items 2m and 2m + 1 are K and V of its m-th tile
  // lo + vw + nvw * m, item n in slot n % NSLOT, completed on that
  // slot's barrier in phase n / NSLOT. Only this warp loads, waits on and
  // frees its slots, in item order, so each barrier's phases are waited on
  // in turn and a slot is reloaded only after the warp is past its reads.
  const uint32_t slots = base + warp * L::NSLOT * L::TILE_BYTES;
  const uint8_t* ring = sbase + (slots - base);
  const uint32_t bars = base + L::BAR_OFF + 8u * L::NSLOT * warp;
  auto issue = [&](int n) {   // the whole warp, once the slot is free:
    const int j = vw + nvw * (n / 2);   // lane x copies box x
    if (j >= ntiles) return;
    const uint32_t bar = bars + 8u * (n % L::NSLOT);
    const uint32_t dst = slots + (n % L::NSLOT) * L::TILE_BYTES;
    if (lane == 0) mbar_expect_tx(bar, L::TILE_BYTES);
    if (lane < L::BOXES)
      tma_load_4d(dst + lane * L::BOX_BYTES, n % 2 ? &tm_v : &tm_k, bar,
                  32 * lane, kvh, (lo + j) * L::BK, b);
  };
  auto wait = [&](int n) {
    mbar_wait(bars + 8u * (n % L::NSLOT), (n / L::NSLOT) & 1);
  };
  // Q, once per CTA: scaled, split, stored as A fragments. Fragment kk of
  // lane (g, t) is 16 bytes at (kk * 32 + lane) * 16 holding a0..a3. Task
  // (g, kk) loads rows g and g + 8, columns 8kk .. 8kk + 7 (four 16-byte
  // loads, all in flight before the first split) and stores the k-step kk
  // fragments of lanes 4g .. 4g + 3, each 16 bytes, in an order rotated by
  // g / 2 so that each quarter warp's stores fill all 32 banks.
  float4 xq[L::QT][2][2];   // [task][row g, g + 8][columns +0, +4]
#pragma unroll
  for (int u = 0; u < L::QT; ++u) {
    const int task = tid + u * THREADS, g8 = task % 8, kk = task / 8;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + g8 + 8 * hr;
      xq[u][hr][0] = xq[u][hr][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (task < L::QTASK && row < nrows) {
        const int i = row / p.group, h = kvh * p.group + row % p.group;
        const float4* src = reinterpret_cast<const float4*>(
            p.q + b * p.q_sb + i * p.q_ss + h * p.q_sh + 32 * kk);
        xq[u][hr][0] = src[0];
        xq[u][hr][1] = src[1];
      }
    }
  }
  // while Q is in flight: this warp's barriers, and its first NSLOT items
  if (lane == 0) {
    for (int s = 0; s < L::NSLOT; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int n = 0; n < L::NSLOT; ++n) issue(n);
#pragma unroll
  for (int u = 0; u < L::QT; ++u) {
    const int task = tid + u * THREADS, g8 = task % 8, kk = task / 8;
    if (task >= L::QTASK) continue;
    uint4 fh[4], fl[4];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const float a[4] = {lane_of(xq[u][0][0], tt), lane_of(xq[u][1][0], tt),
                          lane_of(xq[u][0][1], tt), lane_of(xq[u][1][1], tt)};
      uint32_t hh[4], ll[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split(a[r] * p.scale_log2, hh[r], ll[r]);
      fh[tt] = make_uint4(hh[0], hh[1], hh[2], hh[3]);
      fl[tt] = make_uint4(ll[0], ll[1], ll[2], ll[3]);
    }
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int tr = (tt + g8 / 2) % 4;
      const int off = (kk * 32 + 4 * g8 + tr) * 16;
      *reinterpret_cast<uint4*>(sbase + L::QHI_OFF + off) =
          tr == 0 ? fh[0] : tr == 1 ? fh[1] : tr == 2 ? fh[2] : fh[3];
      *reinterpret_cast<uint4*>(sbase + L::QLO_OFF + off) =
          tr == 0 ? fl[0] : tr == 1 ? fl[1] : tr == 2 ? fl[2] : fl[3];
    }
  }
  __syncthreads();   // Q stored; each warp's barriers initialized

  int qpos[2];   // positions of this thread's rows g and g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = p.q_offset + (row0 + g + 8 * h) / p.group;

  float o[L::NT_O][4];
#pragma unroll
  for (int n = 0; n < L::NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this thread's part
  const uint8_t* qh = sbase + L::QHI_OFF + lane * 16;
  const uint8_t* ql = sbase + L::QLO_OFF + lane * 16;

  for (int it = 0; vw + nvw * it < ntiles; ++it) {
    const int k0 = (lo + vw + nvw * it) * L::BK;
    const uint8_t* sk = ring + (2 * it % L::NSLOT) * L::TILE_BYTES;
    const uint8_t* sv = ring + ((2 * it + 1) % L::NSLOT) * L::TILE_BYTES;

    // S = Q . K^T: K fragment of n-tile n, k-step kk is K[8n + g][8kk + t]
    // and [8kk + t + 4]; in the swizzled box the 16-byte chunk of column c
    // in row r sits at chunk (c / 4) ^ (r % 8), and r % 8 = g.
    float sb[L::SPLIT][L::NT_S][4], ss[L::SPLIT][L::NT_S][4];
#pragma unroll
    for (int h = 0; h < L::SPLIT; ++h)
#pragma unroll
      for (int n = 0; n < L::NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[h][n][e] = ss[h][n][e] = 0.f;
    wait(2 * it);
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) {
      const uint4 h4 = *reinterpret_cast<const uint4*>(qh + kk * 512);
      const uint4 l4 = *reinterpret_cast<const uint4*>(ql + kk * 512);
      const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w};
      const uint32_t al[4] = {l4.x, l4.y, l4.z, l4.w};
      const uint8_t* kb = sk + (kk / 4) * L::BOX_BYTES + g * 128 + 4 * t;
      const int c0 = (2 * (kk % 4)) ^ g, c1 = (2 * (kk % 4) + 1) ^ g;
#pragma unroll
      for (int n = 0; n < L::NT_S; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split(lds(kb + n * 1024 + 16 * c0), bh0, bl0);
        split(lds(kb + n * 1024 + 16 * c1), bh1, bl1);
        mma(ss[kk % L::SPLIT][n], al, bh0, bh1);
        mma(ss[kk % L::SPLIT][n], ah, bl0, bl1);
        mma(sb[kk % L::SPLIT][n], ah, bh0, bh1);
      }
    }
    float sc[L::NT_S][4];
#pragma unroll
    for (int n = 0; n < L::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float big = sb[0][n][e], small = ss[0][n][e];
#pragma unroll
        for (int h = 1; h < L::SPLIT; ++h) {
          big += sb[h][n][e];
          small += ss[h][n][e];
        }
        sc[n][e] = big + small;
      }
    __syncwarp();   // every lane is past its reads of K: reload the slot
    issue(2 * it + L::NSLOT);

    // masks, only on tiles that cross the diagonal, window or limit
    // (F32FlashPlan.tile_masked); element e of n-tile n is row g + 8(e/2),
    // key k0 + 8n + 2t + e%2
    const bool full = k0 + L::BK <= p.kv_len &&
                      (!p.causal || k0 + L::BK - 1 <= p.q_offset + first) &&
                      (p.window <= 0 || k0 > p.q_offset + last - p.window);
    if (!full) {
#pragma unroll
      for (int n = 0; n < L::NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1), qp = qpos[e >> 1];
          const bool vis = kp < p.kv_len && (!p.causal || kp <= qp) &&
                           (p.window <= 0 || kp > qp - p.window);
          if (!vis) sc[n][e] = kNeg;
        }
    }

    // online softmax on the fragment; each row lives in one quad of lanes
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < L::NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
    // P as the A fragments of P.V: k-step n takes keys 8n + (0, 2, 4, 6,
    // 1, 3, 5, 7), so a0..a3 = (p0, p2, p1, p3) of S's n-tile n
    uint32_t ph[L::KP][4], pl[L::KP][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < L::NT_S; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = exp2f(sc[n][e] - m[e >> 1]);
        rs[e >> 1] += pe[e];
      }
      split(pe[0], ph[n][0], pl[n][0]);
      split(pe[2], ph[n][1], pl[n][1]);
      split(pe[1], ph[n][2], pl[n][2]);
      split(pe[3], ph[n][3], pl[n][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int n = 0; n < L::NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P . V: V fragment of k-step kp, n-tile n is V[8kp + 2t][8n + g]
    // and V[8kp + 2t + 1][8n + g]; those rows sit at r % 8 = 2t, 2t + 1.
    wait(2 * it + 1);
#pragma unroll
    for (int kp = 0; kp < L::KP; ++kp) {
      const uint8_t* vb = sv + (8 * kp + 2 * t) * 128 + 4 * (g % 4);
#pragma unroll
      for (int n = 0; n < L::NT_O; ++n) {
        const int chunk = 2 * (n % 4) + g / 4;
        const uint8_t* vn = vb + (n / 4) * L::BOX_BYTES;
        uint32_t bh0, bl0, bh1, bl1;
        split(lds(vn + 16 * (chunk ^ (2 * t))), bh0, bl0);
        split(lds(vn + 128 + 16 * (chunk ^ (2 * t + 1))), bh1, bl1);
        mma(o[n], pl[kp], bh0, bh1);
        mma(o[n], ph[kp], bl0, bl1);
        mma(o[n], ph[kp], bh0, bh1);
      }
    }
    __syncwarp();
    issue(2 * it + 1 + L::NSLOT);
  }

  // merge the warps' partial states in warp order through the ring and Q,
  // free once every warp is past its last tile (a warp loads no item past
  // its last tile, and waits on every item it loads)
  __syncthreads();
  float* mo = reinterpret_cast<float*>(sbase);
  float* ml = mo + NWARP * ROWS * L::MERGE_LD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = warp * ROWS + g + 8 * h;
#pragma unroll
    for (int n = 0; n < L::NT_O; ++n)
      *reinterpret_cast<float2*>(mo + r * L::MERGE_LD + 8 * n + 2 * t) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (t == 0) {
      ml[2 * r] = m[h];
      ml[2 * r + 1] = l[h];
    }
  }
  __syncthreads();
  // each thread's output items: 16 bytes at row r, column c; first every
  // item's weights a_w = 2^(m_w - max) and l = sum_w a_w l_w (loads all in
  // flight), then the weighted sums: out = sum_w a_w o_w / l, or with a
  // cluster, this CTA's (sum_w a_w o_w, max, l) into rank 0's slot
  float wgt[L::OV][NWARP], mt[L::OV], lt[L::OV];
#pragma unroll
  for (int u = 0; u < L::OV; ++u) {
    const int r = (tid + u * THREADS) / (D / 4);
    mt[u] = kNeg;
    lt[u] = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      mt[u] = fmaxf(mt[u], ml[2 * (w * ROWS + r)]);
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      wgt[u][w] = exp2f(ml[2 * (w * ROWS + r)] - mt[u]);
      lt[u] += wgt[u][w] * ml[2 * (w * ROWS + r) + 1];
    }
    if (p.split == 1) {
      const float inv = 1.f / fmaxf(lt[u], 1e-30f);
#pragma unroll
      for (int w = 0; w < NWARP; ++w) wgt[u][w] *= inv;
    }
  }
  float4 acc[L::OV];
#pragma unroll
  for (int u = 0; u < L::OV; ++u) {
    const int e = tid + u * THREADS;
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          mo + (w * ROWS + r) * L::MERGE_LD + c);
      acc[u].x += wgt[u][w] * x.x;
      acc[u].y += wgt[u][w] * x.y;
      acc[u].z += wgt[u][w] * x.z;
      acc[u].w += wgt[u][w] * x.w;
    }
  }
  auto store = [&](int u, float4 v) {
    const int e = tid + u * THREADS;
    const int r = e / (D / 4), c = (e % (D / 4)) * 4, row = row0 + r;
    if (row < nrows) {
      const int i = row / p.group, h = kvh * p.group + row % p.group;
      *reinterpret_cast<float4*>(p.o + b * p.o_sb + i * p.o_ss +
                                 h * p.o_sh + 4 * c) = v;
    }
  };
  if (p.split == 1) {
#pragma unroll
    for (int u = 0; u < L::OV; ++u) store(u, acc[u]);
    return;
  }
  // the cluster: once every rank is past its loop (rank 0's ring is free),
  // push this CTA's partial state into rank 0's slots; rank 0 merges the
  // ranks in order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every rank is past its loop and resident
  float* cb = reinterpret_cast<float*>(sbase + L::CB_OFF);
  float* co = cluster.map_shared_rank(cb, 0);
  float* cm = co + MAX_SPLIT * ROWS * D;
#pragma unroll
  for (int u = 0; u < L::OV; ++u) {
    const int e = tid + u * THREADS;
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    *reinterpret_cast<float4*>(co + (rank * ROWS + r) * D + c) = acc[u];
    if (c == 0) {
      cm[2 * (rank * ROWS + r)] = mt[u];
      cm[2 * (rank * ROWS + r) + 1] = lt[u];
    }
  }
  cluster.sync();
  if (rank != 0) return;
  cm = cb + MAX_SPLIT * ROWS * D;
#pragma unroll
  for (int u = 0; u < L::OV; ++u) {
    const int e = tid + u * THREADS;
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float m = kNeg, l = 0.f;
    for (int k = 0; k < p.split; ++k) m = fmaxf(m, cm[2 * (k * ROWS + r)]);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < p.split; ++k) {
      const float a = exp2f(cm[2 * (k * ROWS + r)] - m);
      l += a * cm[2 * (k * ROWS + r) + 1];
      const float4 x =
          *reinterpret_cast<const float4*>(cb + (k * ROWS + r) * D + c);
      v.x += a * x.x;
      v.y += a * x.y;
      v.z += a * x.z;
      v.w += a * x.w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    store(u, make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv));
  }
}

// -- host side ---------------------------------------------------------------

// A [batch, seq, heads, D] float32 view as a 4-D tensor map (D innermost),
// strides in bytes; boxes of 32 columns x 1 head x box_rows x 1.
CUresult encode(CUtensorMap* map, const void* ptr, int d, int heads, int seq,
                int batch, long long sh, long long ss, long long sb,
                int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sh), cuuint64_t(ss),
                                 cuuint64_t(sb)};
  const cuuint32_t box[4] = {32, 1, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Error codes beyond the CUDA runtime's: the encoder entry point was not
// found, or it refused a view (kErrEncode + the CUresult).
constexpr int kErrNoEncoder = 20000;
constexpr int kErrEncode = 30000;

template <int D>
int launch(const void* k, const void* v, int skv, int hkv, int batch,
           const long long (&kv_strides)[6], const Params& p, dim3 grid,
           int rows, int threads, int smem_bytes, cudaStream_t stream) {
  using L = Layout<D>;
  // the caller's plan must be this instantiation's layout
  if (rows != ROWS || threads != THREADS || smem_bytes != L::ALLOC ||
      p.split < 1 || p.split > MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_k, tm_v;
  CUresult r = encode(&tm_k, k, D, hkv, skv, batch, kv_strides[0],
                      kv_strides[1], kv_strides[2], L::BK);
  if (r == CUDA_SUCCESS)
    r = encode(&tm_v, v, D, hkv, skv, batch, kv_strides[3], kv_strides[4],
               kv_strides[5], L::BK);
  if (r != CUDA_SUCCESS) return kErrEncode + static_cast<int>(r);
  // once per instantiation, not on every launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tf32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (p.split == 1) {
    flash_tf32<D><<<grid, THREADS, L::ALLOC, stream>>>(tm_k, tm_v, p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::ALLOC;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, flash_tf32<D>, tm_k, tm_v, p));
}

}  // namespace

// float32 only. Strides are in BYTES, in the order (head, seq, batch) for
// each of q, k, v, o, and every one a multiple of 16 (TMA for k and v,
// 16-byte loads and stores for q and o); rows is the number of packed rows
// per CTA, split the CTAs (a cluster) that share a row group's tiles (1
// or 2), threads and smem_bytes the plan's (F32FlashPlan); kv_len =
// min(q_offset + valid_len, skv); window <= 0 means none. Returns 0 on
// success.
extern "C" int cake_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int sq,
    int skv, int hq, int hkv, int d, long long q_sh, long long q_ss,
    long long q_sb, long long k_sh, long long k_ss, long long k_sb,
    long long v_sh, long long v_ss, long long v_sb, long long o_sh,
    long long o_ss, long long o_sb, int rows, int split, int threads,
    int smem_bytes, float scale_log2, int causal, int window, int q_offset,
    int kv_len, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      rows <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  Params p;
  p.q = static_cast<const uint8_t*>(q);
  p.o = static_cast<uint8_t*>(o);
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.q_sb = q_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.o_sb = o_sb;
  p.sq = sq;
  p.group = hq / hkv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.kv_len = kv_len;
  p.split = split;
  p.scale_log2 = scale_log2;
  const long long kv_strides[6] = {k_sh, k_ss, k_sb, v_sh, v_ss, v_sb};
  const dim3 grid((sq * p.group + rows - 1) / rows * split, hkv, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {   // each head dimension its own instantiation; no other
    case 64:
      return launch<64>(k, v, skv, hkv, batch, kv_strides, p, grid, rows,
                        threads, smem_bytes, s);
    case 128:
      return launch<128>(k, v, skv, hkv, batch, kv_strides, p, grid, rows,
                         threads, smem_bytes, s);
    case 256:
      return launch<256>(k, v, skv, hkv, batch, kv_strides, p, grid, rows,
                         threads, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
