// flash_sdpa backward: dQ and dK/dV of masked streaming attention, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the flash VJP in
// freefine_tpu/ops/flash_attention.py: `_flash_bwd_dq_kernel` (:344) and
// `_flash_bwd_dkv_kernel` (:378), both launched by `_flash_sdpa_bwd` (:487,
// pallas_call at :508 and :526).  Same function, per (batch, head):
//   P  = exp(q k^T * scale + bias - lse)   recomputed from the forward's lse
//   dS = P * (dO v^T - delta)              delta = rowsum(out * dO), given
//   dQ = dS k * scale,  dK = dS^T q * scale,  dV = P^T dO
// q/dO/dQ [B, Sq, H*D], k/v/dK/dV [B, Sk, H*D] in bf16 or float32; key_mask
// [B, Sk] float32 0/1 or null, applied as the forward applies it (finite
// -1e9 bias on the scaled logit, `masked_logit`); lse and delta float32
// [B, H, Sq].  Keys past Sk do not exist (no dK/dV row is written for them);
// query rows past Sq add nothing.  Two kernels, as on the TPU, each
// recomputing P: no atomics, deterministic, one launch each.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s f32 FMA, 3.35 TB/s,
// about 4.2e12 exp/s from 16 SFU ops/clk/SM): dQ is 6*Sq*Sk*D FLOPs and
// Sq*Sk exps per (b, h), dK/dV 8*Sq*Sk*D FLOPs and Sq*Sk exps; the bytes
// (the operands once) are far below both.  Per call at the SD-1.5 shapes,
// batch 1 (B*H = 8):
//   * S 4096, d 40 (the energy-guidance layers at 64^2): dQ 32 GFLOP (33 us
//     on the tensor cores) and 0.134 G exps (32 us on the SFU): the
//     exponentials cost as much as the products; dK/dV 43 GFLOP (43 us);
//   * S 1024, d 80: dQ 4.0 GFLOP (4.1 us), dK/dV 5.4 us;
//   * S 256 and 64, d 160: under 1 us per call: latency and the grid's
//     fill rule.
//
// Two routes, chosen by the caller (`flash_bwd_route` in
// ops/flash_attention.py, the operands' dtype) and passed in as an int:
//
// Route 1, bf16 (every SD-1.5 call, d <= 160): warp-specialised wgmma
// kernels, the structure of the forward's `flash_fwd_wgmma_kernel`
// (flash_sdpa.cu) on the helpers of hopper.cuh and attention_bwd.cuh (the
// latter shared with the TCA backward).  A CTA runs one producer
// and NC consumer warpgroups; each consumer owns 64 resident rows.
//   * dQ (`dq_wgmma_kernel`): the resident rows are queries.  The producer
//     warp loads Q and dO once, then keeps a ring of K/V tiles of BK keys
//     full with TMA (full/empty mbarriers), writing the key mask's f32 bias
//     tile ((mask - 1) * 1e9, -inf past Sk) beside each.  A consumer runs
//     S = Q K^T and dP = dO V^T as SS wgmma (all four K-major), turns the
//     accumulators into dS in registers, packs dS to bf16 as the forward
//     packs P and runs dQ += dS K as RS wgmma with K read MN-major through
//     its descriptor: one K tile feeds two products and no transposed copy
//     exists (the mma.sync design before it staged K twice).  The consumers
//     take turns issuing S and dP (one named barrier each, as the forward
//     does), so one's products run during another's dS: faster at S 4096,
//     d 40; the same turns measured slower in the dK/dV kernel.
//   * dK/dV (`dkv_wgmma_kernel`): the resident rows are keys.  The producer
//     loads K and V once and streams Q/dO tiles of BQ queries, writing each
//     tile's lse (in the exponent's units) and delta beside it with plain
//     loads guarded by the row bound: [B, H, Sq] f32 rows of a ragged Sq
//     (20 bytes at Sq 5) are no TMA operand.  A consumer runs S^T = K Q^T
//     and dP^T = V dO^T as SS wgmma, then dV += P^T dO and dK += dS^T Q as
//     RS wgmma, Q and dO read MN-major.  Its two f32 accumulators of
//     64 x d sit in registers, so the query tile is 64 up to d 80 and 32
//     above (at d 160: 160 accumulator registers a thread before S^T, dP^T).
//   * Tensor maps describe the operands as (D, H, S, B) (hopper::make_map):
//     columns past d and rows past S read as zeros and no box reads the next
//     head or batch row.  Keys past Sk get P = 0 (-inf, never logit 0); query
//     rows past Sq get lse = +inf and delta = 0, so P = dS = 0 and their zero
//     Q/dO rows add exactly nothing, whatever lies past the row in memory.
//   * Exponentials: unmasked, one FFMA with scale * log2 e folded in and one
//     ex2 against lse * log2 e.  Masked, the logit is rounded as
//     `masked_logit` rounds it (scale, then the bias) and the difference to
//     lse is exponentiated, so a fully masked row (every logit and its lse
//     exactly -1e9) gives P = 1 per key, JAX's value.
//   * P and dS are rounded to bf16 before their products, as FlashAttention
//     does; the twins and the TPU kernel keep them f32, and chip_smoke.py
//     holds the difference to its per-shape limits.
//   * The grid: 64 * NC rows per CTA, NC of 1 to 3 picked per call for the
//     fewest waves of CTAs over the SMs (`warpgroups`): a warpgroup's tile
//     loop is bound by its own latency (products, exponentials and waits in
//     turn), so more warpgroups on an SM hide more of it, while a small grid
//     (S 1024, batch 1: 64 CTAs of 128 rows) spreads over twice the SMs at
//     one.  Three need the small tiles of d <= 40 (160 registers a thread).
//     Within a warpgroup the products and the elementwise work run in turn:
//     overlapping a tile's exponentials with its own dP product (two commit
//     groups), or the next tile's products with this tile's dQ / dK, dV
//     product, measured no faster at S 4096, d 40 (PERF.md), and the
//     latter makes ptxas serialise the wgmma pipeline (C7515).
//   * Every bf16 head dim the wrapper accepts (a multiple of 8 up to 160)
//     maps to an instantiation (FF_BWD_CONFIGS); no other bf16 route exists.
//
// Route 0, float32 (d <= 512: the tiny configuration's head dims, and the
// SD VAE mid-block's one head of 512 that a gradient through `vae.decode`
// reaches): FMA pipes, one key (dQ) or one query (dK/dV) per lane, ROWS
// rows per warp, the structure of the forward's f32 kernels before their
// TF32 redesign.  Every operand row sits whole in shared memory (stride
// DP + 4 floats), so the block's rows and its 32-row tile of the other
// operand pair set the bytes: up to d 128, 4 warps of 8 rows; above
// (DP 256 and 512), 8 warps of 2 rows, 16 rows a block (`FmaShape`).  At
// DP 512 that is (2 * 16 + 2 * 32) rows of 516 floats plus the dS (and P)
// tiles, 200-203 KB of the 227 KB a block may hold, where 32 rows would
// need 264 KB; and a thread's accumulators stay at 2 x 16 floats (dQ) or
// twice that (dK and dV), where 8 rows would need 128 or 256.  The key
// tile stays at one key per lane.  One block an SM at d 512: the loads and
// the products run in turn, and the logits re-read each lane's row from
// shared memory for every query row, so the kernels are bound by shared
// memory, not the FMA pipes (PERF.md has the time beside the bound).
//
// Measured times against the bound: PERF.md.
#include "attention_bwd.cuh"

namespace ff {

// ---------------------------------------------------------------------------
// Route 1: bf16, wgmma with a TMA ring
// ---------------------------------------------------------------------------

namespace wgb {

// NC consumer warpgroups of 64 resident rows each (queries for dQ, keys for
// dK/dV) and one producer warpgroup streaming tiles of BT rows of the other
// operand pair through STAGES slots.
template <int DK, int DV, int BT, int STAGES, int NC>
struct Cfg {
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kRows = 64 * NC;
  // registers per thread after setmaxnreg (65536 in all); with one consumer
  // the launch bound already gives every thread the most there is
  static constexpr int kProducerRegs = NC == 3 ? 32 : 24;
  static constexpr int kConsumerRegs = NC == 3 ? 160 : 240;
  static constexpr int kPK = (DK + kPanel - 1) / kPanel;  // panels of a row
  static constexpr int kResBytes = kPK * kRows * 128;     // one resident operand
  static constexpr int kTileBytes = kPK * BT * 128;       // one streamed operand
  static constexpr int kStageBytes = 2 * kTileBytes;
  // two resident operands | STAGES x two streamed tiles | per-stage row data
  // f32 [STAGES][2][BT] | mbarriers, from a 1024-byte aligned base (the
  // 128-byte swizzle repeats every 8 rows)
  static constexpr int kRowOff = 2 * kResBytes + STAGES * kStageBytes;
  static constexpr int kBarOff = kRowOff + STAGES * 2 * BT * 4;
  static constexpr int kSmem = kBarOff + (2 * STAGES + 1) * 8 + 1024;
  static_assert(DK % 16 == 0 && DV % 8 == 0 && DV <= DK && BT % 16 == 0, "wgmma tile shapes");
  static_assert(NC >= 1 && NC <= 3, "one to three consumer warpgroups");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

// The producer lane 0's loads of one stage: two tiles of BT rows at row r0.
template <int PK, int BT>
__device__ __forceinline__ void load_stage(uint8_t* dst, const CUtensorMap* m0,
                                           const CUtensorMap* m1, uint64_t* bar, int h, int r0,
                                           int b) {
  constexpr int kTile = PK * BT * 128;
  hopper::mbar_arrive_tx(bar, 2 * kTile);
#pragma unroll
  for (int p = 0; p < PK; ++p) {
    hopper::tma_load_4d(dst + p * BT * 128, m0, bar, p * kPanel, h, r0, b);
    hopper::tma_load_4d(dst + kTile + p * BT * 128, m1, bar, p * kPanel, h, r0, b);
  }
}

template <int DK, int DV, int BK, int STAGES, int NC, bool MASKED>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ key_mask, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq, int heads, int sq, int sk,
                int d, float scale) {
  using C = Cfg<DK, DV, BK, STAGES, NC>;
  constexpr int kBQ = C::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* stages = base + 2 * C::kResBytes;  // Q | dO | STAGES x (K | V)
  float* bias = reinterpret_cast<float*>(base + C::kRowOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;

  const int tid = threadIdx.x, wgi = tid / 128;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (sk + BK - 1) / BK;

  if (tid == 0) init_barriers(full, empty, res, STAGES, 128 * NC);
  __syncthreads();

  if (wgi == 0) {
    // ---- producer warpgroup: one warp issues, three idle ----
    if constexpr (NC > 1) hopper::regs_dec<C::kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        hopper::mbar_arrive_tx(res, 2 * C::kResBytes);
#pragma unroll
        for (int p = 0; p < C::kPK; ++p) {
          hopper::tma_load_4d(base + p * kBQ * 128, &tq, res, p * kPanel, h, q0, b);
          hopper::tma_load_4d(base + C::kResBytes + p * kBQ * 128, &tdo, res, p * kPanel, h, q0,
                              b);
        }
      }
      const float* mrow = MASKED ? key_mask + (size_t)b * sk : nullptr;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // first round passes
        if (MASKED) {
          for (int c = lane; c < BK; c += 32) {
            const int col = j * BK + c;
            bias[s * 2 * BK + c] = col < sk ? (mrow[col] - 1.0f) * kMaskBias : -INFINITY;
          }
        }
        if (lane == 0)
          load_stage<C::kPK, BK>(stages + s * C::kStageBytes, &tk, &tv, &full[s], h, j * BK, b);
        else
          hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  if constexpr (NC > 1) hopper::regs_inc<C::kConsumerRegs>();
  const int cw = wgi - 1;
  const int ctid = tid - 128 * wgi;
  const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, t = lane % 4;
  const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  // turns on the tensor cores in round robin, as in the forward: named
  // barrier 1 + c is consumer c's; the last consumer opens the first round
  const int turn = 1 + cw, next = 1 + (cw + 1) % NC;
  if (NC > 1 && cw == NC - 1) hopper::bar_arrive(1, 256);
  // per row: lse (masked: natural units; else times log2 e) and delta; rows
  // past Sq get +inf and 0, so their P and dS are 0
  float lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool ok = row < sq;
    const float l = ok ? lse[(size_t)bh * sq + row] : INFINITY;
    lr[hh] = MASKED ? l : l * kLog2e;
    dr[hh] = ok ? delta[(size_t)bh * sq + row] : 0.f;
  }
  const float c2 = scale * kLog2e;

  float acc[DV / 2], sacc[BK / 2], dpacc[BK / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  uint32_t pa[BK / 16][4];  // dS of the tile as bf16 A fragments

  hopper::mbar_wait(res, 0);
  const uint32_t qaddr = hopper::smem_addr(base) + cw * 64 * 128;
  const uint32_t doaddr = qaddr + C::kResBytes;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t kaddr = hopper::smem_addr(stages + s * C::kStageBytes);
    const uint32_t vaddr = kaddr + C::kTileBytes;
    // S = Q K^T and dP = dO V^T, both K-major, on this warpgroup's turn;
    // the next one's products then run during this one's dS
    if (NC > 1) hopper::bar_sync(turn, 256);
    hopper::wgmma_fence();
    ss_issue<BK, DK>(sacc, qaddr, kBQ, kaddr);
    ss_issue<BK, DK>(dpacc, doaddr, kBQ, vaddr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);
    if (NC > 1 && !(cw == NC - 1 && j == ntiles - 1)) hopper::bar_arrive(next, 256);
    // dS = P (dP - delta); element 4 i + e is row g + 8 (e / 2), key
    // 8 i + 2 t + (e % 2) of the tile
    const int k0 = j * BK;
    if (!MASKED && k0 + BK > sk) {  // keys past Sk: P = 0 (the bias tile says so when masked)
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * i + 2 * t + (e & 1) >= sk) sacc[4 * i + e] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      float2 bb = make_float2(0.f, 0.f);
      if (MASKED) bb = *reinterpret_cast<const float2*>(bias + s * 2 * BK + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float p;
        if (MASKED) {
          const float x = __fadd_rn(__fmul_rn(sacc[4 * i + e], scale), (e & 1) ? bb.y : bb.x);
          p = hopper::ex2((x - lr[hh]) * kLog2e);
        } else {
          p = hopper::ex2(fmaf(sacc[4 * i + e], c2, -lr[hh]));
        }
        sacc[4 * i + e] = p * (dpacc[4 * i + e] - dr[hh]);
      }
    }
    pack_frags<BK>(pa, sacc);
    // dQ += dS K, K MN-major
    hopper::wgmma_fence();
    rs_issue<DV, BK>(acc, pa, kaddr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }

  const int e = heads * d;
  store_acc_rows<DV>(dq + (size_t)b * sq * e + h * d, acc, row0, sq, e, d, scale, t);
}

template <int DK, int DV, int BQ, int STAGES, int NC, bool MASKED>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ key_mask, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int heads, int sq, int sk, int d, float scale) {
  using C = Cfg<DK, DV, BQ, STAGES, NC>;
  constexpr int kKeys = C::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* stages = base + 2 * C::kResBytes;  // K | V | STAGES x (Q | dO)
  float* rows = reinterpret_cast<float*>(base + C::kRowOff);  // [STAGES][lse, delta][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;

  const int tid = threadIdx.x, wgi = tid / 128;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * kKeys;
  const int ntiles = (sq + BQ - 1) / BQ;

  if (tid == 0) init_barriers(full, empty, res, STAGES, 128 * NC);
  __syncthreads();

  if (wgi == 0) {
    // ---- producer warpgroup: one warp issues, three idle ----
    if constexpr (NC > 1) hopper::regs_dec<C::kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        hopper::mbar_arrive_tx(res, 2 * C::kResBytes);
#pragma unroll
        for (int p = 0; p < C::kPK; ++p) {
          hopper::tma_load_4d(base + p * kKeys * 128, &tk, res, p * kPanel, h, k0, b);
          hopper::tma_load_4d(base + C::kResBytes + p * kKeys * 128, &tv, res, p * kPanel, h, k0,
                              b);
        }
      }
      const float* lrow = lse + (size_t)bh * sq;
      const float* drow = delta + (size_t)bh * sq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // first round passes
        // the tile's lse (masked: natural units; else times log2 e) and
        // delta; rows past Sq get +inf and 0, so their P and dS are 0
        for (int c = lane; c < BQ; c += 32) {
          const int row = j * BQ + c;
          const bool ok = row < sq;
          const float l = ok ? lrow[row] : INFINITY;
          rows[s * 2 * BQ + c] = MASKED ? l : l * kLog2e;
          rows[s * 2 * BQ + BQ + c] = ok ? drow[row] : 0.f;
        }
        if (lane == 0)
          load_stage<C::kPK, BQ>(stages + s * C::kStageBytes, &tq, &tdo, &full[s], h, j * BQ, b);
        else
          hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  if constexpr (NC > 1) hopper::regs_inc<C::kConsumerRegs>();
  const int cw = wgi - 1;
  const int ctid = tid - 128 * wgi;
  const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, t = lane % 4;
  const int key0 = k0 + cw * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  float kb[2] = {0.f, 0.f};  // the keys' mask bias (keys past Sk are never written)
  if (MASKED) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      if (key < sk) kb[hh] = (key_mask[(size_t)b * sk + key] - 1.0f) * kMaskBias;
    }
  }
  const float c2 = scale * kLog2e;

  float adk[DV / 2], adv[DV / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) adk[i] = adv[i] = 0.f;
  uint32_t pa[BQ / 16][4], pb[BQ / 16][4];  // P^T and dS^T as bf16 A fragments

  hopper::mbar_wait(res, 0);
  const uint32_t kaddr = hopper::smem_addr(base) + cw * 64 * 128;
  const uint32_t vaddr = kaddr + C::kResBytes;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t qaddr = hopper::smem_addr(stages + s * C::kStageBytes);
    const uint32_t doaddr = qaddr + C::kTileBytes;
    // S^T = K Q^T and dP^T = V dO^T, both K-major
    hopper::wgmma_fence();
    ss_issue<BQ, DK>(st, kaddr, kKeys, qaddr);
    ss_issue<BQ, DK>(dpt, vaddr, kKeys, doaddr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    // element 4 i + e is key g + 8 (e / 2), query 8 i + 2 t + (e % 2) of the tile
    const float* lt = rows + s * 2 * BQ;
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * i + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(lt + BQ + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
        float p;
        if (MASKED) {
          const float x = __fadd_rn(__fmul_rn(st[4 * i + e], scale), kb[e >> 1]);
          p = hopper::ex2((x - lq) * kLog2e);
        } else {
          p = hopper::ex2(fmaf(st[4 * i + e], c2, -lq));
        }
        st[4 * i + e] = p;
        dpt[4 * i + e] = p * (dpt[4 * i + e] - dl);
      }
    }
    pack_frags<BQ>(pa, st);
    pack_frags<BQ>(pb, dpt);
    // dV += P^T dO and dK += dS^T Q, dO and Q MN-major
    hopper::wgmma_fence();
    rs_issue<DV, BQ>(adv, pa, doaddr);
    rs_issue<DV, BQ>(adk, pb, qaddr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(adv);
    hopper::fence_regs(adk);
    hopper::mbar_arrive(&empty[s]);
  }

  const int e = heads * d;
  const size_t off = (size_t)b * sk * e + h * d;
  store_acc_rows<DV>(dk + off, adk, key0, sk, e, d, scale, t);
  store_acc_rows<DV>(dv + off, adv, key0, sk, e, d, 1.0f, t);
}

}  // namespace wgb


// ---------------------------------------------------------------------------
// float32, FMA pipes
// ---------------------------------------------------------------------------

// dQ: WARPS * ROWS query rows per block, key tiles of 32 (one key per lane).
template <int DP, int WARPS, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ key_mask,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int heads, int sq, int sk,
              int d, float scale) {
  constexpr int kLd = DP + 4;
  constexpr int kBQ = WARPS * ROWS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBQ * kLd;
  float* ks = dos + kBQ * kLd;
  float* vs = ks + kBK * kLd;
  float* ws = vs + kBK * kLd;  // dS of each warp's rows: [kBQ][kBK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = WARPS * 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const float* kb = k + (size_t)b * sk * e + h * d;
  const float* vb = v + (size_t)b * sk * e + h * d;
  const float* mb = key_mask ? key_mask + (size_t)b * sk : nullptr;

  load_tile<DP>(qs, q + (size_t)b * sq * e + h * d, q0, kBQ, sq, e, d, tid, nthreads);
  load_tile<DP>(dos, dout + (size_t)b * sq * e + h * d, q0, kBQ, sq, e, d, tid, nthreads);
  const int r0 = q0 + warp * ROWS;
  const float* lse_w = lse + (size_t)bh * sq + r0;  // read per use: fewer live registers
  const float* delta_w = delta + (size_t)bh * sq + r0;
  float acc[ROWS][(DP + 31) / 32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < (DP + 31) / 32; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + warp * ROWS * kLd;
  const float* dow = dos + warp * ROWS * kLd;
  float* ww = ws + warp * ROWS * kBK;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    __syncthreads();
    load_tile<DP>(ks, kb, k0, kBK, sk, e, d, tid, nthreads);
    load_tile<DP>(vs, vb, k0, kBK, sk, e, d, tid, nthreads);
    __syncthreads();
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = row_dot<DP>(qw + r * kLd, ks + lane * kLd);
      const float dp = row_dot<DP>(dow + r * kLd, vs + lane * kLd);
      float ds = 0.f;
      if (j < sk && r0 + r < sq) {
        const float p = __expf(masked_logit(s, scale, mb, j) - lse_w[r]);
        ds = p * (dp - delta_w[r]);
      }
      ww[r * kBK + lane] = ds;
    }
    __syncwarp();
    accumulate_rows<DP, ROWS>(acc, ww, ks, lane);  // dQ += dS . K
  }
  store_rows<DP, ROWS>(dq + (size_t)b * sq * e + h * d, acc, r0, sq, e, d, scale, lane);
}

// dK/dV: WARPS * ROWS keys per block, query tiles of 32 (one query per lane).
template <int DP, int WARPS, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ key_mask,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
               int heads, int sq, int sk, int d, float scale) {
  constexpr int kLd = DP + 4;
  constexpr int kKeys = WARPS * ROWS;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kKeys * kLd;
  float* qs = vs + kKeys * kLd;
  float* dos = qs + kBK * kLd;
  float* ps = dos + kBK * kLd;   // P^T of each warp's keys: [kKeys][kBK]
  float* dss = ps + kKeys * kBK; // dS^T
  float* lse_s = dss + kKeys * kBK;
  float* delta_s = lse_s + kBK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = WARPS * 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int k0 = blockIdx.x * kKeys;
  const float* qb = q + (size_t)b * sq * e + h * d;
  const float* dob = dout + (size_t)b * sq * e + h * d;
  const float* mb = key_mask ? key_mask + (size_t)b * sk : nullptr;

  load_tile<DP>(ks, k + (size_t)b * sk * e + h * d, k0, kKeys, sk, e, d, tid, nthreads);
  load_tile<DP>(vs, v + (size_t)b * sk * e + h * d, k0, kKeys, sk, e, d, tid, nthreads);
  const int r0 = k0 + warp * ROWS;
  float adk[ROWS][(DP + 31) / 32], adv[ROWS][(DP + 31) / 32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < (DP + 31) / 32; ++i) adk[r][i] = adv[r][i] = 0.f;
  }
  const float* kw = ks + warp * ROWS * kLd;
  const float* vw = vs + warp * ROWS * kLd;
  float* pw = ps + warp * ROWS * kBK;
  float* dsw = dss + warp * ROWS * kBK;

  for (int q0 = 0; q0 < sq; q0 += kBK) {
    __syncthreads();
    load_tile<DP>(qs, qb, q0, kBK, sq, e, d, tid, nthreads);
    load_tile<DP>(dos, dob, q0, kBK, sq, e, d, tid, nthreads);
    for (int i = tid; i < kBK; i += nthreads) {
      lse_s[i] = q0 + i < sq ? lse[(size_t)bh * sq + q0 + i] : 0.f;
      delta_s[i] = q0 + i < sq ? delta[(size_t)bh * sq + q0 + i] : 0.f;
    }
    __syncthreads();
    const bool qvalid = q0 + lane < sq;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = row_dot<DP>(qs + lane * kLd, kw + r * kLd);
      const float dp = row_dot<DP>(dos + lane * kLd, vw + r * kLd);
      float p = 0.f, ds = 0.f;
      if (qvalid && r0 + r < sk) {
        p = __expf(masked_logit(s, scale, mb, r0 + r) - lse_s[lane]);
        ds = p * (dp - delta_s[lane]);
      }
      pw[r * kBK + lane] = p;
      dsw[r * kBK + lane] = ds;
    }
    __syncwarp();
    accumulate_rows<DP, ROWS>(adv, pw, dos, lane);  // dV += P^T . dO
    accumulate_rows<DP, ROWS>(adk, dsw, qs, lane);  // dK += dS^T . Q
  }
  const size_t off = (size_t)b * sk * e + h * d;
  store_rows<DP, ROWS>(dk + off, adk, r0, sk, e, d, scale, lane);
  store_rows<DP, ROWS>(dv + off, adv, r0, sk, e, d, 1.0f, lane);
}


// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *mask, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int batch, heads, sq, sk, d;
  float scale;
  cudaStream_t stream;
};

namespace wgb {

// One bf16 kernel: dQ (BT = the key tile) or dK/dV (BT = the query tile).
template <bool DQ, int DK, int DV, int BT, int STAGES, int NC>
cudaError_t launch(const BwdArgs& a) {
  constexpr bool want_dq = DQ;
  using C = Cfg<DK, DV, BT, STAGES, NC>;
  // resident rows of the CTA's own operand pair, tiles of the streamed one
  const int rq = want_dq ? C::kRows : BT, rk = want_dq ? BT : C::kRows;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = hopper::make_map(&tq, a.q, a.batch, a.heads, a.sq, a.d, rq)) != cudaSuccess ||
      (err = hopper::make_map(&tdo, a.dout, a.batch, a.heads, a.sq, a.d, rq)) != cudaSuccess ||
      (err = hopper::make_map(&tk, a.k, a.batch, a.heads, a.sk, a.d, rk)) != cudaSuccess ||
      (err = hopper::make_map(&tv, a.v, a.batch, a.heads, a.sk, a.d, rk)) != cudaSuccess)
    return err;
  const dim3 grid(((want_dq ? a.sq : a.sk) + C::kRows - 1) / C::kRows, a.batch * a.heads);
  const float* m = static_cast<const float*>(a.mask);
  const bool masked = m != nullptr;
#define FF_BWD_LAUNCH(KERN, MASKED, ...)                                              \
  {                                                                                   \
    auto kern = KERN<DK, DV, BT, STAGES, NC, MASKED>;                                 \
    static bool done = false;                                                         \
    if ((err = set_smem(kern, C::kSmem, done)) != cudaSuccess) return err;            \
    kern<<<grid, C::kThreads, C::kSmem, a.stream>>>(tq, tk, tv, tdo, m, a.lse, a.delta, \
                                                    __VA_ARGS__, a.heads, a.sq, a.sk, \
                                                    a.d, a.scale);                    \
  }
  bf16* dq = static_cast<bf16*>(a.dq);
  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  if constexpr (DQ) {
    if (masked) FF_BWD_LAUNCH(dq_wgmma_kernel, true, dq)
    else FF_BWD_LAUNCH(dq_wgmma_kernel, false, dq)
  } else {
    if (masked) FF_BWD_LAUNCH(dkv_wgmma_kernel, true, dk, dv)
    else FF_BWD_LAUNCH(dkv_wgmma_kernel, false, dk, dv)
  }
#undef FF_BWD_LAUNCH
  return cudaGetLastError();
}

// The instantiation of one kernel for NC consumer warpgroups: tile BT and
// ring ST at one or two, BT3 and ST3 at three (none where BT3 is 0: the
// 160 registers of a thread at three do not hold the accumulators).
template <bool DQ, int DK, int DV, int BT, int ST, int BT3, int ST3>
struct Variants {
  static constexpr int kMaxNc = BT3 > 0 ? 3 : 2;
  static cudaError_t launch(const BwdArgs& a, int nc) {
    if constexpr (BT3 > 0) {
      if (nc == 3) return wgb::launch<DQ, DK, DV, BT3, ST3, 3>(a);
    }
    return nc == 2 ? wgb::launch<DQ, DK, DV, BT, ST, 2>(a) : wgb::launch<DQ, DK, DV, BT, ST, 1>(a);
  }
  static int smem(int nc) {
    if constexpr (BT3 > 0) {
      if (nc == 3) return Cfg<DK, DV, BT3, ST3, 3>::kSmem;
    }
    if (nc == 3) return -1;
    return nc == 2 ? Cfg<DK, DV, BT, ST, 2>::kSmem : Cfg<DK, DV, BT, ST, 1>::kSmem;
  }
};

// Head dim -> instantiations: (DK, DV) the head dim padded to the products'
// depth 16 and the output width; then for dQ the key tile and ring depth at
// one or two consumer warpgroups and at three (0: none), and the same for
// dK/dV's query tile (32 queries above d 80, where its two 64 x d
// accumulators take most of a thread's registers).  Each within the 227 KB
// of one CTA.
#define FF_BWD_CONFIGS(X)                      \
  X(32, 32, 128, 4, 64, 4, 64, 4, 64, 4)       \
  X(48, 40, 128, 4, 64, 4, 64, 4, 64, 4)       \
  X(64, 64, 128, 4, 0, 0, 64, 4, 0, 0)         \
  X(80, 80, 64, 4, 0, 0, 64, 4, 0, 0)          \
  X(128, 128, 64, 4, 0, 0, 32, 4, 0, 0)        \
  X(160, 160, 64, 2, 0, 0, 32, 4, 0, 0)

cudaError_t dispatch(const BwdArgs& a, bool want_dq) {
  const int rows = want_dq ? a.sq : a.sk, bh = a.batch * a.heads;
#define FF_BWD_CASE(DK, DV, BK, SK, BK3, SK3, BQ, SQ, BQ3, SQ3)                 \
  if (a.d <= DV) {                                                              \
    if (want_dq) {                                                              \
      using V = Variants<true, DK, DV, BK, SK, BK3, SK3>;                       \
      return V::launch(a, warpgroups(rows, bh, V::kMaxNc));                    \
    }                                                                           \
    using V = Variants<false, DK, DV, BQ, SQ, BQ3, SQ3>;                        \
    return V::launch(a, warpgroups(rows, bh, V::kMaxNc));                       \
  }
  FF_BWD_CONFIGS(FF_BWD_CASE)
#undef FF_BWD_CASE
  return cudaErrorInvalidValue;
}

int smem_bytes(int d, bool want_dq, int nc) {
#define FF_BWD_SMEM(DK, DV, BK, SK, BK3, SK3, BQ, SQ, BQ3, SQ3)                 \
  if (d <= DV)                                                                  \
    return want_dq ? Variants<true, DK, DV, BK, SK, BK3, SK3>::smem(nc)         \
                   : Variants<false, DK, DV, BQ, SQ, BQ3, SQ3>::smem(nc);
  FF_BWD_CONFIGS(FF_BWD_SMEM)
#undef FF_BWD_SMEM
  return -1;
}

}  // namespace wgb

// Warps a block and rows a warp of the FMA kernels at padded head dim DP
// (see the route notes at the top).
template <int DP>
struct FmaShape {
  static constexpr int kWarps = DP <= 128 ? 4 : 8;
  static constexpr int kRows = DP <= 128 ? 8 : 2;
};

template <int DP>
cudaError_t launch_dq_fma(const BwdArgs& a) {
  constexpr int kWarps = FmaShape<DP>::kWarps, kRows = FmaShape<DP>::kRows;
  constexpr int kBQ = kWarps * kRows;
  const size_t smem = sizeof(float) * (size_t)((2 * kBQ + 2 * kBK) * (DP + 4) + kBQ * kBK);
  static_assert(sizeof(float) * ((2 * kBQ + 2 * kBK) * (DP + 4) + kBQ * kBK) <= 232448,
                "shared memory of one block");
  auto kern = dq_fma_kernel<DP, kWarps, kRows>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.batch * a.heads);
  kern<<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dq), a.heads,
      a.sq, a.sk, a.d, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_fma(const BwdArgs& a) {
  constexpr int kWarps = FmaShape<DP>::kWarps, kRows = FmaShape<DP>::kRows;
  constexpr int kKeys = kWarps * kRows;
  const size_t smem =
      sizeof(float) * (size_t)((2 * kKeys + 2 * kBK) * (DP + 4) + 2 * kKeys * kBK + 2 * kBK);
  static_assert(sizeof(float) * ((2 * kKeys + 2 * kBK) * (DP + 4) + 2 * kKeys * kBK + 2 * kBK)
                    <= 232448,
                "shared memory of one block");
  auto kern = dkv_fma_kernel<DP, kWarps, kRows>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.sk + kKeys - 1) / kKeys, a.batch * a.heads);
  kern<<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.heads, a.sq, a.sk, a.d, a.scale);
  return cudaGetLastError();
}

// f32: DP = d padded to the FMA kernels' widths.
cudaError_t dispatch_f32(const BwdArgs& a, bool want_dq) {
#define FF_FMA_CASE(DP) \
  if (a.d <= DP) return want_dq ? launch_dq_fma<DP>(a) : launch_dkv_fma<DP>(a);
  FF_FMA_CASE(16)
  FF_FMA_CASE(32)
  FF_FMA_CASE(64)
  FF_FMA_CASE(128)
  FF_FMA_CASE(256)
  FF_FMA_CASE(512)
#undef FF_FMA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace ff

namespace {

constexpr int kRouteF32 = 0;    // float32, FMA kernels, d <= 512
constexpr int kRouteWgmma = 1;  // bf16, wgmma + TMA ring, d <= 160

int bwd(const ff::BwdArgs& a, int route, bool want_dq) {
  if (a.d <= 0 || a.d % 8 != 0 || a.sq < 1 || a.sk < 1) return (int)cudaErrorInvalidValue;
  if (route == kRouteWgmma && a.d <= 160) return (int)ff::wgb::dispatch(a, want_dq);
  if (route == kRouteF32 && a.d <= 512) return (int)ff::dispatch_f32(a, want_dq);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (the route): 0 = float32 (FMA kernels, d <= 512), 1 = bfloat16
// (wgmma kernels, d <= 160); d a multiple of 8.  mask may be null.  lse and
// delta are float32 [batch, heads, sq].  Each returns the CUDA error of its
// launch (0 = launched).
extern "C" int flash_sdpa_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                 const void* dout, const void* lse, const void* delta, void* dq,
                                 int batch, int heads, int sq, int sk, int d, float scale,
                                 int dtype, void* stream) {
  const ff::BwdArgs a{q, k, v, mask, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dq, nullptr, nullptr, batch, heads, sq,
                      sk, d, scale, static_cast<cudaStream_t>(stream)};
  return bwd(a, dtype, true);
}

extern "C" int flash_sdpa_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                                  const void* dout, const void* lse, const void* delta, void* dk,
                                  void* dv, int batch, int heads, int sq, int sk, int d,
                                  float scale, int dtype, void* stream) {
  const ff::BwdArgs a{q, k, v, mask, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), nullptr, dk, dv, batch, heads, sq, sk,
                      d, scale, static_cast<cudaStream_t>(stream)};
  return bwd(a, dtype, false);
}

// Dynamic shared memory (bytes) of the bf16 wgmma instantiation at head dim
// d: kernel 0 = dQ, 1 = dK/dV; warpgroups = consumer warpgroups (1 to 3);
// -1 where there is none.
extern "C" int flash_sdpa_bwd_smem_bytes(int d, int kernel, int warpgroups) {
  if (d <= 0 || d % 8 != 0 || d > 160 || (kernel != 0 && kernel != 1) || warpgroups < 1 ||
      warpgroups > 3)
    return -1;
  return ff::wgb::smem_bytes(d, kernel == 0, warpgroups);
}
