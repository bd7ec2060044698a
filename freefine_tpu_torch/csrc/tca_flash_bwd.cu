// tca_flash backward: dQ and dK/dV of the fused temporal-contextual
// attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the TCA VJP in
// freefine_tpu/ops/flash_attention.py: `_tca_bwd_dq_kernel` (:636) and
// `_tca_bwd_dkv_kernel` (:696), both launched by `_tca_diff_bwd` (:861).
// Same function, per (batch, head), with the residuals of the forward
// (csrc/tca_flash.cu, `tca_flash_fwd_lse`):
//   P_x  = exp(logit_x - lse_x)            x = self, fg, bg; the fg and bg
//          logits are the one q.k_mod logit with the forward's mask bias
//          (`masked_logit`, `masked_logit_bg`), rounded as it rounds them
//   w_x  = (1 - cg), cg * tq, cg * (1 - tq) per query (tq [B, S], shared by
//          the heads of a batch row)
//   dS_self = P_self * (w_self dO V_self^T - delta_self)
//   dS_mod  = P_fg * (w_fg dO V_mod^T - delta_fg) + P_bg * (w_bg dO V_mod^T - delta_bg)
//   dQ = (dS_self K_self + dS_mod K_mod) * scale
//   dK_self = dS_self^T Q * scale,  dV_self = (w_self P_self)^T dO
//   dK_mod  = dS_mod^T Q * scale,   dV_mod  = (w_fg P_fg + w_bg P_bg)^T dO
// with delta_x = rowsum(o_x * dO) * w_x, computed in plain math by the
// wrapper (`tca_row_deltas`).  JAX scales dO per pass before each product
// (do_fg = cg tq dO, do_bg = cg (1 - tq) dO); those are row scalings of one
// dO, so one dO.V_mod^T product with per-row weights, and one combined
// P^T.dO for dV_mod, compute the same: FG and BG share every product here,
// as they share q.k_mod in the forward.  q/dO/dQ and k/v/dK/dV [B, S, H*D]
// in bf16 or float32; fg, tq float32 [B, S]; lse and delta float32
// [3, B, H, S] (self, fg, bg).  Keys and queries past S do not exist.
//
// Masked rows: in the odd-head block of the parity split fg = tq = 1, so
// the BG pass masks every key; its logits and its lse all round to -1e9
// (an f32 ulp there is 64), so the recomputed P_bg is exactly 1 per key,
// and its weight cg (1 - tq) and delta_bg are exactly 0: its terms are
// 0 * finite = 0, never NaN.  An FG row with no fg key has a non-zero
// weight: it keeps JAX's values (P = 1 per key, Sk times what autograd
// through the materialised softmax gives).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, about 4.2e12 exp/s
// from 16 SFU ops/clk/SM), per (b, h): dQ 12*S^2*D FLOPs (Q.K_self^T,
// Q.K_mod^T, dO.V_self^T, dO.V_mod^T, two dS.K), dK/dV 16*S^2*D FLOPs (per
// key set K.Q^T, V.dO^T, dS^T.Q, P^T.dO).  Computed as the TPU kernels do,
// each takes 3*S^2 exponentials; at S = 4096, d = 40 on the SD-1.5 path
// (B*H = 24) those 1.2 G exps (289 us) bound both against 193 and 258 us of
// products.  Points 1 and 2 below leave 2*S^2 where the masks allow (the
// edit and object-removal masks do almost everywhere): 193 us, level with
// dQ's products.  At S = 1024, d = 80 the products bound (24 and 32 us).
//
// Two routes, by the operands' dtype:
//
// bf16 (the UNet's TCA layers; every head dim the wrapper admits, a
// multiple of 8 up to 80, maps to an instantiation of FF_TCA_BWD_CONFIGS):
// warp-specialised wgmma kernels with the structure of the flash backward
// (csrc/flash_sdpa_bwd.cu) and the TCA forward's ring (csrc/tca_flash.cu),
// on the helpers of attention_bwd.cuh and hopper.cuh.  A CTA runs one
// producer and NC consumer warpgroups, each consumer owning 64 resident
// rows; tensor maps describe the operands as (D, H, S, B)
// (hopper::make_map), so rows past S read as zeros and no box reads the
// next head or batch row.
//   * dQ (`tca_dq_wgmma_kernel`): the resident rows are queries.  The
//     producer warp loads Q and dO once by TMA, then keeps a ring of
//     stages full, each holding K_self, V_self, K_mod and V_mod of BK keys
//     with the tile's two f32 biases beside it, (fg - 1) * 1e9 and
//     fg * -1e9 (-inf past S), and a flag saying whether every fg of the
//     tile is 0 or 1.  Per tile a consumer runs S_self = Q K_self^T and
//     dP_self = dO V_self^T as SS wgmma, forms dS_self in registers, packs
//     it to bf16 and issues dQ += dS_self K_self as RS wgmma (K read
//     MN-major through its descriptor: no transposed copy of K exists)
//     together with S_mod and dP_mod; then dS_mod and dQ += dS_mod K_mod.
//     Only two logit tiles are live at a time.
//   * dK/dV (`tca_dkv_wgmma_kernel`), split by key set over the grid's z
//     (z = 0 self, z = 1 mod: four 64 x d f32 accumulators would not fit at
//     d 80): the resident rows are 64 keys of the CTA's set.  The producer
//     streams Q/dO tiles of 64 queries and writes beside each the tile's
//     per-query lse (log2 and natural units), delta and weight of the CTA's
//     pass or passes with guarded plain loads (rows past S: lse = +inf,
//     delta = 0, as the flash backward), and the tile's flags (below).
//     S^T = K Q^T and dP^T = V dO^T run as SS wgmma, dV += (w P)^T dO and
//     dK += dS^T Q as RS wgmma with Q and dO read MN-major.  The self CTAs
//     scale dV by the constant w_self once, in the epilogue.  The mod
//     CTAs' one-exponential path (point 2) carries the weight in the
//     exponent, w P = 2^(s scale log2 e - (lse log2 e - log2 w)) and
//     dS = w P (dP - delta / w): two values per query and pass instead of
//     three, which is what lets three consumers fit (point 4).
//   1. No work on a pass whose weight is exactly zero.  A row whose weight
//      w_x is 0 (dK/dV: below f32's normal range, where log2 w and
//      delta / w would not be finite) gets lse_x = +inf, so its P_x is
//      exactly 0: its dS term
//      P_x (0 dP - 0) and its dV share 0 P_x are 0 in the twin too, so
//      this is exact.  A 64-query tile whose tq is 1 on every row has BG
//      dead (weight cg (1 - tq) = 0), else one whose tq is 0 on every row
//      has FG dead (`tca_dead_passes` in ops/flash_attention.py decides
//      the same), decided on the device: per consumer warpgroup in dQ (its
//      64 rows), per streamed tile by the producer in dK/dV.  Where point 2
//      applies a mod logit takes one exponential whatever is dead; where it
//      does not, the dead pass's exponentials are not taken.  Self's weight
//      1 - cg is 0 only at cg = 1, and cg = 0 kills FG and BG at once;
//      neither is skipped (their rows get P = 0 by the +inf rule, so the
//      results stay exact, but the exponentials are taken), as in the
//      forward.
//   2. One exponential per k_mod logit where the row has a real softmax.
//      For a key with fg = 1 the BG logit carries -1e9 and for fg = 0 the
//      FG logit does, so wherever the row's live lse are not themselves
//      about -1e9 (all above -5e8, the +inf of a dead row included) at most
//      one of P_fg and P_bg is not zero, exp(logit - lse_sel) with
//      lse_sel = fg ? lse_fg : lse_bg, and the other is exactly 0 in f32.
//      Where every key of the tile has fg 0 or 1 (dQ: the producer's flag
//      per key tile; dK/dV: each warp's 16 resident keys) and every row
//      does (dQ: each warp's 16 rows; dK/dV: the producer's flag per query
//      tile), the mod pass takes one ex2 per logit, one FFMA with scale *
//      log2 e folded in, and the selected weight and delta.  Elsewhere (a
//      fully masked live row, as the `empty_fg` check case makes, or a
//      soft fg) it takes both exponentials of the live passes, rounding the
//      masked logit as `masked_logit` does and exponentiating its
//      difference to the natural-unit lse, so a fully masked row gives
//      P = 1 per key, JAX's value.  The choice is uniform per warp and only
//      selects elementwise code: every tile issues the same products.
//   3. P (w P for dV) and dS are rounded to bf16 before their products, as
//      the flash backward does; the twins keep them f32, and chip_smoke.py
//      holds the difference to its per-shape limits.  No atomics, sums in
//      a fixed order: two calls give the same bits.
//   4. The grid: 64 * NC rows per CTA, NC of 1 to 3 picked per call for
//      the fewest waves over the SMs (`wgb::warpgroups`; the dK/dV grid
//      counts both key sets).  Three consumers (128 registers a thread at
//      the launch bound) only at d <= 40, with 32-key dQ tiles.  A
//      warpgroup's tile loop is bound by its own latency (products,
//      exponentials and waits in turn), so more warpgroups on an SM hide
//      more of it: dK/dV at S 4096, d 40 runs markedly faster with three
//      than with two.  Its three-consumer instantiations spill at 128
//      registers unless the weight rides in the exponent (above).  Issuing
//      the next tile's logit products with this tile's gradient products
//      (one wait a tile) measured no faster in either kernel and slower for
//      dQ at S 1024, as the flash backward found (PERF.md).
//
// float32 (tests and the tiny configuration, d <= 128): FMA pipes, one key
// (dQ) or one query (dK/dV) per lane, the structure of the flash backward's
// f32 kernels.
//
// Measured times against the bound: PERF.md.
#include <cfloat>

#include "attention_bwd.cuh"

namespace ff {

// Per-query residuals of the three passes, read from [3, B, H, S].
struct Rows {
  const float* lse;
  const float* delta;
  size_t plane;  // B * H * S
};

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma with a TMA ring
// ---------------------------------------------------------------------------

namespace tcab {

using hopper::kPanel;
using wgb::kLog2e;

// A logsumexp at or below this is a fully masked row's (-1e9 to f32
// rounding); a real softmax's is within a few thousand of 0.
constexpr float kRealLse = -5e8f;
// Per-stage flags of the dK/dV query tiles.
constexpr int kFgLive = 1, kBgLive = 2, kOneExp = 4;

// NC consumer warpgroups of 64 resident rows (queries for dQ, keys for
// dK/dV) and one producer warpgroup streaming tiles of BT rows of NSTREAM
// operands through STAGES slots, with ROWF floats per streamed row beside
// each stage.
template <int DK, int BT, int STAGES, int NC, int NSTREAM, int ROWF>
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
  static constexpr int kStageBytes = NSTREAM * kTileBytes;
  // two resident operands | STAGES x NSTREAM streamed tiles | row data f32
  // [STAGES][ROWF][BT] | flags int [STAGES] | mbarriers, from a 1024-byte
  // aligned base (the 128-byte swizzle repeats every 8 rows)
  static constexpr int kRowOff = 2 * kResBytes + STAGES * kStageBytes;
  static constexpr int kFlagOff = kRowOff + STAGES * ROWF * BT * 4;
  static constexpr int kBarOff = kFlagOff + (STAGES * 4 + 7) / 8 * 8;
  static constexpr int kSmem = kBarOff + (2 * STAGES + 1) * 8 + 1024;
  static_assert(DK % 16 == 0 && BT % 16 == 0, "wgmma tile shapes");
  static_assert(NC >= 1 && NC <= 3, "one to three consumer warpgroups");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};
// dQ: K_self | V_self | K_mod | V_mod, biases fg and bg per key
template <int DK, int BK, int STAGES, int NC>
using DqCfg = Cfg<DK, BK, STAGES, NC, 4, 2>;
// dK/dV: Q | dO, per query (mod) lse2_x - log2 w_x (log2 units: w P is
// 2^(s scale log2 e - that)) for x = fg, bg, lse_fg, lse_bg (natural
// units), delta_fg, delta_bg, w_fg, w_bg, delta_fg / w_fg, delta_bg / w_bg;
// (self) lse2 in slot 0, delta in slot 4
template <int DK, int BQ, int STAGES, int NC>
using DkvCfg = Cfg<DK, BQ, STAGES, NC, 2, 10>;

__device__ __forceinline__ uint8_t* aligned_base(uint8_t* raw) {
  return raw + ((1024u - (hopper::smem_addr(raw) & 1023u)) & 1023u);
}

// Rows [row, row + BT) of one head into P 64-column panels (one TMA box each).
template <int P, int BT>
__device__ __forceinline__ void load_panels(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                            int h, int row, int b) {
#pragma unroll
  for (int p = 0; p < P; ++p)
    hopper::tma_load_4d(dst + p * BT * 128, map, bar, p * kPanel, h, row, b);
}

// Keys past S get logit -inf (P = 0).  Element 4 i + e of a 64 x BT
// accumulator is row g + 8 (e / 2), column 8 i + 2 t + (e % 2).
template <int BT>
__device__ __forceinline__ void mask_cols(float (&s)[BT / 2], int c0, int seq, int t) {
#pragma unroll
  for (int i = 0; i < BT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + 8 * i + 2 * t + (e & 1) >= seq) s[4 * i + e] = -INFINITY;
}

// ---- dQ ---------------------------------------------------------------

// One pass's values of a consumer thread's two query rows: weight, lse in
// natural and log2 units (+inf where the weight is 0 or the row is past S,
// so P = 0 there) and delta.
struct PassRows {
  float w[2], ln[2], l2[2], dl[2];
};

// dS_self = P (w dP - delta), P = 2^(s scale log2 e - lse log2 e).
template <int BK>
__device__ __forceinline__ void dq_self(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                        const PassRows& r, float c2) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const float p = hopper::ex2(fmaf(s[4 * i + e], c2, -r.l2[hh]));
      s[4 * i + e] = p * fmaf(r.w[hh], dp[4 * i + e], -r.dl[hh]);
    }
}

// dS_mod with one exponential per logit: the key's fg picks its live pass
// (fg = 1: FG, whose bias is +0; else BG), the other pass's P being 0.
template <int BK>
__device__ __forceinline__ void dq_mod_one(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                           const PassRows& f, const PassRows& g,
                                           const float* bias, float c2, int t) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const float2 bf = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const bool fk = ((e & 1) ? bf.y : bf.x) == 0.f;
      const float p = hopper::ex2(fmaf(s[4 * i + e], c2, -(fk ? f.l2[hh] : g.l2[hh])));
      s[4 * i + e] = p * fmaf(fk ? f.w[hh] : g.w[hh], dp[4 * i + e], -(fk ? f.dl[hh] : g.dl[hh]));
    }
  }
}

// dS_mod from both exponentials of the live passes, the logit rounded as
// `masked_logit` / `masked_logit_bg` round it.
template <int BK, bool FG, bool BG>
__device__ __forceinline__ void dq_mod_exact(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                             const PassRows& f, const PassRows& g,
                                             const float* bias, float scale, int t) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const float2 bf = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * t);
    const float2 bb = *reinterpret_cast<const float2*>(bias + BK + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const float xs = __fmul_rn(s[4 * i + e], scale);
      float ds = 0.f;
      if (FG) {
        const float x = __fadd_rn(xs, (e & 1) ? bf.y : bf.x);
        ds = hopper::ex2((x - f.ln[hh]) * kLog2e) * fmaf(f.w[hh], dp[4 * i + e], -f.dl[hh]);
      }
      if (BG) {
        const float x = __fadd_rn(xs, (e & 1) ? bb.y : bb.x);
        ds += hopper::ex2((x - g.ln[hh]) * kLog2e) * fmaf(g.w[hh], dp[4 * i + e], -g.dl[hh]);
      }
      s[4 * i + e] = ds;
    }
  }
}

template <int DK, int DV, int BK, int STAGES, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
tca_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mks, const __grid_constant__ CUtensorMap mvs,
                    const __grid_constant__ CUtensorMap mkm, const __grid_constant__ CUtensorMap mvm,
                    const float* __restrict__ fg, const float* __restrict__ tq, float cg,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int heads, int seq, int d, float scale) {
  using C = DqCfg<DK, BK, STAGES, NC>;
  constexpr int kBQ = C::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  uint8_t* stages = base + 2 * C::kResBytes;  // Q | dO | STAGES x (K_s | V_s | K_m | V_m)
  float* bias = reinterpret_cast<float*>(base + C::kRowOff);  // [STAGES][fg, bg][BK]
  int* binary = reinterpret_cast<int*>(base + C::kFlagOff);   // [STAGES]: every fg 0 or 1
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;

  const int tid = threadIdx.x, wgi = tid / 128;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (seq + BK - 1) / BK;

  if (tid == 0) wgb::init_barriers(full, empty, res, STAGES, 128 * NC);
  __syncthreads();

  if (wgi == 0) {
    // ---- producer warpgroup: one warp issues, three idle ----
    if constexpr (NC > 1) hopper::regs_dec<C::kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        hopper::mbar_arrive_tx(res, 2 * C::kResBytes);
        load_panels<C::kPK, kBQ>(base, &mq, res, h, q0, b);
        load_panels<C::kPK, kBQ>(base + C::kResBytes, &mdo, res, h, q0, b);
      }
      const float* frow = fg + (size_t)b * seq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // first round passes
        float* bs = bias + s * 2 * BK;
        bool bin = true;
        for (int c = lane; c < BK; c += 32) {
          const int col = j * BK + c;
          const bool ok = col < seq;
          const float f = ok ? frow[col] : 0.f;
          bs[c] = ok ? (f - 1.0f) * kMaskBias : -INFINITY;  // fg pass
          bs[BK + c] = ok ? f * -kMaskBias : -INFINITY;     // bg pass
          bin = bin && (f == 0.f || f == 1.f);
        }
        bin = __all_sync(0xffffffffu, bin);
        if (lane == 0) {
          binary[s] = bin;
          uint8_t* st = stages + s * C::kStageBytes;
          hopper::mbar_arrive_tx(&full[s], C::kStageBytes);
          load_panels<C::kPK, BK>(st, &mks, &full[s], h, j * BK, b);
          load_panels<C::kPK, BK>(st + C::kTileBytes, &mvs, &full[s], h, j * BK, b);
          load_panels<C::kPK, BK>(st + 2 * C::kTileBytes, &mkm, &full[s], h, j * BK, b);
          load_panels<C::kPK, BK>(st + 3 * C::kTileBytes, &mvm, &full[s], h, j * BK, b);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  if constexpr (NC > 1) hopper::regs_inc<C::kConsumerRegs>();
  const int cw = wgi - 1;
  const int ctid = tid - 128 * wgi;
  const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + cw * 64;                // this warpgroup's first query row
  const int row0 = r0 + warp * 16 + g;        // this thread's rows: row0, row0 + 8
  const float* trow = tq + (size_t)b * seq;
  // the warpgroup's live passes: every row's tq 1 kills BG, else every
  // row's tq 0 kills FG (each warp reads the same 64 rows: uniform)
  bool one = true, zero = true;
  for (int r = lane; r < 64; r += 32) {
    if (r0 + r < seq) {
      const float w = trow[r0 + r];
      one = one && w == 1.0f;
      zero = zero && w == 0.0f;
    }
  }
  one = __all_sync(0xffffffffu, one);
  zero = __all_sync(0xffffffffu, zero);
  const bool fg_live = one || !zero, bg_live = !one;
  // per row and pass: weight, lse (+inf where the weight is 0 or past S),
  // delta; `real`: every row of the warp has a real softmax in each pass
  // that weights it, so one exponential serves both mod passes
  PassRows pr[3];
  const size_t plane = (size_t)gridDim.y * seq;
  bool real = true;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool ok = row < seq;
    const float tv = ok ? trow[row] : 0.f;
    const float wv[3] = {1.0f - cg, cg * tv, cg * (1.0f - tv)};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t at = a * plane + (size_t)bh * seq + row;
      const float l = ok && wv[a] != 0.f ? lse[at] : INFINITY;
      pr[a].w[hh] = ok ? wv[a] : 0.f;
      pr[a].ln[hh] = l;
      pr[a].l2[hh] = l * kLog2e;
      pr[a].dl[hh] = ok ? delta[at] : 0.f;
    }
    real = real && pr[1].ln[hh] > kRealLse && pr[2].ln[hh] > kRealLse;
  }
  real = __all_sync(0xffffffffu, real);
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
    const uint32_t kss = hopper::smem_addr(stages + s * C::kStageBytes);
    const uint32_t vss = kss + C::kTileBytes, kms = vss + C::kTileBytes, vms = kms + C::kTileBytes;
    const int k0 = j * BK;
    const bool ragged = k0 + BK > seq;
    // self: S = Q K_self^T, dP = dO V_self^T (K-major)
    hopper::wgmma_fence();
    wgb::ss_issue<BK, DK>(sacc, qaddr, kBQ, kss);
    wgb::ss_issue<BK, DK>(dpacc, doaddr, kBQ, vss);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);
    if (ragged) mask_cols<BK>(sacc, k0, seq, t);
    dq_self<BK>(sacc, dpacc, pr[0], c2);
    wgb::pack_frags<BK>(pa, sacc);
    // dQ += dS_self K_self (K MN-major), with S = Q K_mod^T, dP = dO V_mod^T
    hopper::wgmma_fence();
    wgb::rs_issue<DV, BK>(acc, pa, kss);
    wgb::ss_issue<BK, DK>(sacc, qaddr, kBQ, kms);
    wgb::ss_issue<BK, DK>(dpacc, doaddr, kBQ, vms);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(sacc);
    hopper::fence_regs(dpacc);
    if (ragged) mask_cols<BK>(sacc, k0, seq, t);
    const float* bs = bias + s * 2 * BK;
    if (real && binary[s])
      dq_mod_one<BK>(sacc, dpacc, pr[1], pr[2], bs, c2, t);
    else if (fg_live && bg_live)
      dq_mod_exact<BK, true, true>(sacc, dpacc, pr[1], pr[2], bs, scale, t);
    else if (fg_live)
      dq_mod_exact<BK, true, false>(sacc, dpacc, pr[1], pr[2], bs, scale, t);
    else
      dq_mod_exact<BK, false, true>(sacc, dpacc, pr[1], pr[2], bs, scale, t);
    wgb::pack_frags<BK>(pa, sacc);
    // dQ += dS_mod K_mod
    hopper::wgmma_fence();
    wgb::rs_issue<DV, BK>(acc, pa, kms);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }

  const int e = heads * d;
  wgb::store_acc_rows<DV>(dq + (size_t)b * seq * e + h * d, acc, row0, seq, e, d, scale, t);
}

// ---- dK/dV ------------------------------------------------------------

// Self: P^T (unweighted: the epilogue scales dV by w_self) and
// dS^T = P (w dP - delta).  Element 4 i + e is key g + 8 (e / 2), query
// 8 i + 2 t + (e % 2) of the tile; rs the tile's [lse2 | . | . | . | delta].
template <int BQ>
__device__ __forceinline__ void dkv_self(float (&st)[BQ / 2], float (&dpt)[BQ / 2],
                                         const float* rs, float w, float c2, int t) {
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const float2 l2 = *reinterpret_cast<const float2*>(rs + 8 * i + 2 * t);
    const float2 d2 = *reinterpret_cast<const float2*>(rs + 4 * BQ + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = hopper::ex2(fmaf(st[4 * i + e], c2, -((e & 1) ? l2.y : l2.x)));
      st[4 * i + e] = p;
      dpt[4 * i + e] = p * fmaf(w, dpt[4 * i + e], -((e & 1) ? d2.y : d2.x));
    }
  }
}

// Mod, one exponential per logit: each key's fg picks its live pass (the
// thread's two keys fixed for the whole kernel), the other pass's P is 0.
// The weight rides in the exponent: w P = 2^(s c2 - (lse2 - log2 w)) and
// dS = w P (dP - delta / w), two values per query instead of three.
template <int BQ>
__device__ __forceinline__ void dkv_mod_one(float (&st)[BQ / 2], float (&dpt)[BQ / 2],
                                            const float* rs, const bool (&fgk)[2], float c2,
                                            int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float* sel = rs + (fgk[hh] ? 0 : BQ);  // lse2 - log2 w at 0, delta / w at 8 BQ
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(sel + 8 * i + 2 * t);
      const float2 u2 = *reinterpret_cast<const float2*>(sel + 8 * BQ + 8 * i + 2 * t);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int k = 4 * i + 2 * hh + c;
        const float pw = hopper::ex2(fmaf(st[k], c2, -(c ? l2.y : l2.x)));
        st[k] = pw;
        dpt[k] = pw * (dpt[k] - (c ? u2.y : u2.x));
      }
    }
  }
}

// Mod from both exponentials of the live passes, the logit rounded as
// `masked_logit` / `masked_logit_bg` round it (kb*: the keys' biases).
template <int BQ, bool FG, bool BG>
__device__ __forceinline__ void dkv_mod_exact(float (&st)[BQ / 2], float (&dpt)[BQ / 2],
                                              const float* rs, const float (&kbf)[2],
                                              const float (&kbb)[2], float scale, int t) {
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const int o = 8 * i + 2 * t;
    const float2 lf = *reinterpret_cast<const float2*>(rs + 2 * BQ + o);
    const float2 lb = *reinterpret_cast<const float2*>(rs + 3 * BQ + o);
    const float2 df = *reinterpret_cast<const float2*>(rs + 4 * BQ + o);
    const float2 db = *reinterpret_cast<const float2*>(rs + 5 * BQ + o);
    const float2 wf = *reinterpret_cast<const float2*>(rs + 6 * BQ + o);
    const float2 wb = *reinterpret_cast<const float2*>(rs + 7 * BQ + o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, c = e & 1;
      const float xs = __fmul_rn(st[4 * i + e], scale), dp = dpt[4 * i + e];
      float pw = 0.f, ds = 0.f;
      if (FG) {
        const float w = c ? wf.y : wf.x;
        const float p = hopper::ex2((__fadd_rn(xs, kbf[hh]) - (c ? lf.y : lf.x)) * kLog2e);
        pw = w * p;
        ds = p * fmaf(w, dp, -(c ? df.y : df.x));
      }
      if (BG) {
        const float w = c ? wb.y : wb.x;
        const float p = hopper::ex2((__fadd_rn(xs, kbb[hh]) - (c ? lb.y : lb.x)) * kLog2e);
        pw += w * p;
        ds += p * fmaf(w, dp, -(c ? db.y : db.x));
      }
      st[4 * i + e] = pw;
      dpt[4 * i + e] = ds;
    }
  }
}

template <int DK, int DV, int BQ, int STAGES, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
tca_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                     const __grid_constant__ CUtensorMap mks, const __grid_constant__ CUtensorMap mvs,
                     const __grid_constant__ CUtensorMap mkm, const __grid_constant__ CUtensorMap mvm,
                     const float* __restrict__ fg, const float* __restrict__ tq, float cg,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk_self, bf16* __restrict__ dv_self,
                     bf16* __restrict__ dk_mod, bf16* __restrict__ dv_mod, int heads, int seq,
                     int d, float scale) {
  using C = DkvCfg<DK, BQ, STAGES, NC>;
  constexpr int kKeys = C::kRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  uint8_t* stages = base + 2 * C::kResBytes;  // K | V | STAGES x (Q | dO)
  float* rows = reinterpret_cast<float*>(base + C::kRowOff);  // [STAGES][10][BQ]
  int* flags = reinterpret_cast<int*>(base + C::kFlagOff);    // [STAGES]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;

  const bool mod = blockIdx.z == 1;  // this CTA's key set: self (0) or mod (1)
  const int tid = threadIdx.x, wgi = tid / 128;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * kKeys;
  const int ntiles = (seq + BQ - 1) / BQ;

  if (tid == 0) wgb::init_barriers(full, empty, res, STAGES, 128 * NC);
  __syncthreads();

  if (wgi == 0) {
    // ---- producer warpgroup: one warp issues, three idle ----
    if constexpr (NC > 1) hopper::regs_dec<C::kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        hopper::mbar_arrive_tx(res, 2 * C::kResBytes);
        load_panels<C::kPK, kKeys>(base, mod ? &mkm : &mks, res, h, k0, b);
        load_panels<C::kPK, kKeys>(base + C::kResBytes, mod ? &mvm : &mvs, res, h, k0, b);
      }
      const float* trow = tq + (size_t)b * seq;
      const size_t plane = (size_t)gridDim.y * seq;
      const float* lrow = lse + (size_t)bh * seq;
      const float* drow = delta + (size_t)bh * seq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // first round passes
        // the tile's per-query values; rows past S and rows whose weight
        // is 0 get lse = +inf (P = 0), rows past S delta = 0
        float* rs = rows + s * 10 * BQ;
        bool one = true, zero = true, real = true;
        for (int c = lane; c < BQ; c += 32) {
          const int row = j * BQ + c;
          const bool ok = row < seq;
          const float tv = ok ? trow[row] : 0.f;
          if (!mod) {
            const float l = ok && cg != 1.0f ? lrow[row] : INFINITY;
            rs[c] = l * kLog2e;
            rs[4 * BQ + c] = ok ? drow[row] : 0.f;
          } else {
            // a weight below the normal range counts as 0: log2 w and
            // delta / w (the SFU's, which flush subnormals) stay finite
            const float wf = cg * tv, wb = cg * (1.0f - tv);
            const float lf = ok && wf >= FLT_MIN ? lrow[plane + row] : INFINITY;
            const float lb = ok && wb >= FLT_MIN ? lrow[2 * plane + row] : INFINITY;
            rs[c] = lf * kLog2e - (lf < INFINITY ? __log2f(wf) : 0.f);
            rs[BQ + c] = lb * kLog2e - (lb < INFINITY ? __log2f(wb) : 0.f);
            rs[2 * BQ + c] = lf;
            rs[3 * BQ + c] = lb;
            rs[4 * BQ + c] = ok ? drow[plane + row] : 0.f;
            rs[5 * BQ + c] = ok ? drow[2 * plane + row] : 0.f;
            rs[6 * BQ + c] = ok ? wf : 0.f;
            rs[7 * BQ + c] = ok ? wb : 0.f;
            rs[8 * BQ + c] = lf < INFINITY ? __fdividef(rs[4 * BQ + c], wf) : 0.f;
            rs[9 * BQ + c] = lb < INFINITY ? __fdividef(rs[5 * BQ + c], wb) : 0.f;
            one = one && (!ok || tv == 1.0f);
            zero = zero && (!ok || tv == 0.0f);
            real = real && lf > kRealLse && lb > kRealLse;
          }
        }
        one = __all_sync(0xffffffffu, one);
        zero = __all_sync(0xffffffffu, zero);
        real = __all_sync(0xffffffffu, real);
        if (lane == 0) {
          // every row's tq 1 kills BG, else every row's tq 0 kills FG
          flags[s] = (one || !zero ? kFgLive : 0) | (one ? 0 : kBgLive) | (real ? kOneExp : 0);
          uint8_t* st = stages + s * C::kStageBytes;
          hopper::mbar_arrive_tx(&full[s], C::kStageBytes);
          load_panels<C::kPK, BQ>(st, &mq, &full[s], h, j * BQ, b);
          load_panels<C::kPK, BQ>(st + C::kTileBytes, &mdo, &full[s], h, j * BQ, b);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
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
  // the keys' fg and mask biases (keys past S are never written); `binary`:
  // every key of the warp has fg 0 or 1
  float kbf[2], kbb[2];
  bool fgk[2], binary = true;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    const float f = key < seq ? fg[(size_t)b * seq + key] : 0.f;
    kbf[hh] = (f - 1.0f) * kMaskBias;
    kbb[hh] = f * -kMaskBias;
    fgk[hh] = f == 1.0f;
    binary = binary && (f == 0.f || f == 1.f);
  }
  binary = __all_sync(0xffffffffu, binary);
  const float c2 = scale * kLog2e, w_self = 1.0f - cg;

  float adk[DV / 2], adv[DV / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) adk[i] = adv[i] = 0.f;
  uint32_t pa[BQ / 16][4], pb[BQ / 16][4];  // (w P)^T and dS^T as bf16 A fragments

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
    wgb::ss_issue<BQ, DK>(st, kaddr, kKeys, qaddr);
    wgb::ss_issue<BQ, DK>(dpt, vaddr, kKeys, doaddr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    const float* rs = rows + s * 10 * BQ;
    if (!mod) {
      dkv_self<BQ>(st, dpt, rs, w_self, c2, t);
    } else {
      const int fl = flags[s];
      if (binary && (fl & kOneExp))
        dkv_mod_one<BQ>(st, dpt, rs, fgk, c2, t);
      else if ((fl & kFgLive) && (fl & kBgLive))
        dkv_mod_exact<BQ, true, true>(st, dpt, rs, kbf, kbb, scale, t);
      else if (fl & kFgLive)
        dkv_mod_exact<BQ, true, false>(st, dpt, rs, kbf, kbb, scale, t);
      else
        dkv_mod_exact<BQ, false, true>(st, dpt, rs, kbf, kbb, scale, t);
    }
    wgb::pack_frags<BQ>(pa, st);
    wgb::pack_frags<BQ>(pb, dpt);
    // dV += (w P)^T dO and dK += dS^T Q, dO and Q MN-major
    hopper::wgmma_fence();
    wgb::rs_issue<DV, BQ>(adv, pa, doaddr);
    wgb::rs_issue<DV, BQ>(adk, pb, qaddr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(adv);
    hopper::fence_regs(adk);
    hopper::mbar_arrive(&empty[s]);
  }

  const int e = heads * d;
  const size_t off = (size_t)b * seq * e + h * d;
  wgb::store_acc_rows<DV>((mod ? dk_mod : dk_self) + off, adk, key0, seq, e, d, scale, t);
  wgb::store_acc_rows<DV>((mod ? dv_mod : dv_self) + off, adv, key0, seq, e, d,
                          mod ? 1.0f : w_self, t);
}

}  // namespace tcab

// ---------------------------------------------------------------------------
// float32, FMA pipes
// ---------------------------------------------------------------------------

// Per-query values of a dK/dV block's query tile in shared memory: lse,
// delta and weight of the block's one (self) or two (fg, bg) passes.
struct QueryTile {
  float *lse0, *lse1, *dl0, *dl1, *w0, *w1;
};

template <int BQ>
__device__ __forceinline__ QueryTile carve_query_tile(float* base) {
  return {base, base + BQ, base + 2 * BQ, base + 3 * BQ, base + 4 * BQ, base + 5 * BQ};
}

// Fill the query tile [q0, q0 + BQ) of pass set `mod` (rows past seq: 0).
template <int BQ>
__device__ __forceinline__ void load_query_tile(const QueryTile& qt, const Rows& rows,
                                                const float* tqb, float cg, bool mod, int bh,
                                                int q0, int seq, int tid, int nthreads) {
  for (int i = tid; i < BQ; i += nthreads) {
    const int row = q0 + i;
    const bool ok = row < seq;
    const size_t r = (size_t)bh * seq + row;
    const int a0 = mod ? 1 : 0;
    qt.lse0[i] = ok ? rows.lse[a0 * rows.plane + r] : 0.f;
    qt.dl0[i] = ok ? rows.delta[a0 * rows.plane + r] : 0.f;
    qt.lse1[i] = ok && mod ? rows.lse[2 * rows.plane + r] : 0.f;
    qt.dl1[i] = ok && mod ? rows.delta[2 * rows.plane + r] : 0.f;
    const float tv = ok ? tqb[row] : 0.f;
    qt.w0[i] = !ok ? 0.f : mod ? cg * tv : 1.0f - cg;
    qt.w1[i] = ok && mod ? cg * (1.0f - tv) : 0.f;
  }
}

// The weighted probability (for dV) and dS of one (key, query) pair:
// self: P = exp(logit - lse0); mod: the FG and BG terms of one logit.
__device__ __forceinline__ void pair_terms(float s, float dp, float scale, const float* fgb,
                                           int key, bool mod, const QueryTile& qt, int li,
                                           float& pw, float& ds) {
  if (!mod) {
    const float p = __expf(masked_logit(s, scale, nullptr, key) - qt.lse0[li]);
    pw = qt.w0[li] * p;
    ds = p * (qt.w0[li] * dp - qt.dl0[li]);
  } else {
    const float pf = __expf(masked_logit(s, scale, fgb, key) - qt.lse0[li]);
    const float pb = __expf(masked_logit_bg(s, scale, fgb, key) - qt.lse1[li]);
    pw = qt.w0[li] * pf + qt.w1[li] * pb;
    ds = pf * (qt.w0[li] * dp - qt.dl0[li]) + pb * (qt.w1[li] * dp - qt.dl1[li]);
  }
}

// dQ: WARPS * ROWS query rows per block, key tiles of 32 (one key per lane).
template <int DP, int WARPS, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
tca_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k_self,
                  const float* __restrict__ v_self, const float* __restrict__ k_mod,
                  const float* __restrict__ v_mod, const float* __restrict__ fg,
                  const float* __restrict__ tq, float cg, const float* __restrict__ dout,
                  Rows rows, float* __restrict__ dq, int heads, int seq, int d, float scale) {
  constexpr int kLd = DP + 4;
  constexpr int kBQ = WARPS * ROWS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBQ * kLd;
  float* kss = dos + kBQ * kLd;
  float* vss = kss + kBK * kLd;
  float* kms = vss + kBK * kLd;
  float* vms = kms + kBK * kLd;
  float* wss = vms + kBK * kLd;   // dS_self of each warp's rows: [kBQ][kBK]
  float* wsm = wss + kBQ * kBK;   // dS_mod

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = WARPS * 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const size_t off = (size_t)b * seq * e + h * d;
  const float* fgb = fg + (size_t)b * seq;

  load_tile<DP>(qs, q + off, q0, kBQ, seq, e, d, tid, nthreads);
  load_tile<DP>(dos, dout + off, q0, kBQ, seq, e, d, tid, nthreads);
  const int r0 = q0 + warp * ROWS;
  float acc[ROWS][(DP + 31) / 32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < (DP + 31) / 32; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + warp * ROWS * kLd;
  const float* dow = dos + warp * ROWS * kLd;
  float* wsw = wss + warp * ROWS * kBK;
  float* wmw = wsm + warp * ROWS * kBK;

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();
    load_tile<DP>(kss, k_self + off, k0, kBK, seq, e, d, tid, nthreads);
    load_tile<DP>(vss, v_self + off, k0, kBK, seq, e, d, tid, nthreads);
    load_tile<DP>(kms, k_mod + off, k0, kBK, seq, e, d, tid, nthreads);
    load_tile<DP>(vms, v_mod + off, k0, kBK, seq, e, d, tid, nthreads);
    __syncthreads();
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = r0 + r;
      const float s_self = row_dot<DP>(qw + r * kLd, kss + lane * kLd);
      const float dp_self = row_dot<DP>(dow + r * kLd, vss + lane * kLd);
      const float s_mod = row_dot<DP>(qw + r * kLd, kms + lane * kLd);
      const float dp_mod = row_dot<DP>(dow + r * kLd, vms + lane * kLd);
      float ds_self = 0.f, ds_mod = 0.f;
      if (j < seq && qi < seq) {
        const size_t ri = (size_t)bh * seq + qi;
        const float tv = tq[(size_t)b * seq + qi];
        const float ps = __expf(masked_logit(s_self, scale, nullptr, j) - rows.lse[ri]);
        ds_self = ps * ((1.0f - cg) * dp_self - rows.delta[ri]);
        const float pf =
            __expf(masked_logit(s_mod, scale, fgb, j) - rows.lse[rows.plane + ri]);
        const float pb =
            __expf(masked_logit_bg(s_mod, scale, fgb, j) - rows.lse[2 * rows.plane + ri]);
        ds_mod = pf * (cg * tv * dp_mod - rows.delta[rows.plane + ri]) +
                 pb * (cg * (1.0f - tv) * dp_mod - rows.delta[2 * rows.plane + ri]);
      }
      wsw[r * kBK + lane] = ds_self;
      wmw[r * kBK + lane] = ds_mod;
    }
    __syncwarp();
    accumulate_rows<DP, ROWS>(acc, wsw, kss, lane);  // dQ += dS_self . K_self
    accumulate_rows<DP, ROWS>(acc, wmw, kms, lane);  // dQ += dS_mod . K_mod
  }
  store_rows<DP, ROWS>(dq + off, acc, r0, seq, e, d, scale, lane);
}

// dK/dV: WARPS * ROWS keys of one key set (blockIdx.z) per block, query
// tiles of 32 (one query per lane).
template <int DP, int WARPS, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
tca_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k_self,
                   const float* __restrict__ v_self, const float* __restrict__ k_mod,
                   const float* __restrict__ v_mod, const float* __restrict__ fg,
                   const float* __restrict__ tq, float cg, const float* __restrict__ dout,
                   Rows rows, float* __restrict__ dk_self, float* __restrict__ dv_self,
                   float* __restrict__ dk_mod, float* __restrict__ dv_mod, int heads, int seq,
                   int d, float scale) {
  constexpr int kLd = DP + 4;
  constexpr int kKeys = WARPS * ROWS;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kKeys * kLd;
  float* qs = vs + kKeys * kLd;
  float* dos = qs + kBK * kLd;
  float* ps = dos + kBK * kLd;    // weighted P^T of each warp's keys: [kKeys][kBK]
  float* dss = ps + kKeys * kBK;  // dS^T
  const QueryTile tile = carve_query_tile<kBK>(dss + kKeys * kBK);

  const bool mod = blockIdx.z == 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = WARPS * 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int k0 = blockIdx.x * kKeys;
  const size_t off = (size_t)b * seq * e + h * d;
  const float* fgb = fg + (size_t)b * seq;

  load_tile<DP>(ks, (mod ? k_mod : k_self) + off, k0, kKeys, seq, e, d, tid, nthreads);
  load_tile<DP>(vs, (mod ? v_mod : v_self) + off, k0, kKeys, seq, e, d, tid, nthreads);
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

  for (int q0 = 0; q0 < seq; q0 += kBK) {
    __syncthreads();
    load_tile<DP>(qs, q + off, q0, kBK, seq, e, d, tid, nthreads);
    load_tile<DP>(dos, dout + off, q0, kBK, seq, e, d, tid, nthreads);
    load_query_tile<kBK>(tile, rows, tq + (size_t)b * seq, cg, mod, bh, q0, seq, tid, nthreads);
    __syncthreads();
    const bool qvalid = q0 + lane < seq;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float s = row_dot<DP>(qs + lane * kLd, kw + r * kLd);
      const float dp = row_dot<DP>(dos + lane * kLd, vw + r * kLd);
      float p = 0.f, ds = 0.f;
      if (qvalid && r0 + r < seq) pair_terms(s, dp, scale, fgb, r0 + r, mod, tile, lane, p, ds);
      pw[r * kBK + lane] = p;
      dsw[r * kBK + lane] = ds;
    }
    __syncwarp();
    accumulate_rows<DP, ROWS>(adv, pw, dos, lane);  // dV += (w P)^T . dO
    accumulate_rows<DP, ROWS>(adk, dsw, qs, lane);  // dK += dS^T . Q
  }
  store_rows<DP, ROWS>((mod ? dk_mod : dk_self) + off, adk, r0, seq, e, d, scale, lane);
  store_rows<DP, ROWS>((mod ? dv_mod : dv_self) + off, adv, r0, seq, e, d, 1.0f, lane);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct TcaBwdArgs {
  const void *q, *ks, *vs, *km, *vm;
  const float *fg, *tq;
  float cg;
  const void* dout;
  Rows rows;
  void *dq, *dks, *dvs, *dkm, *dvm;
  int batch, heads, seq, d;
  float scale;
  cudaStream_t stream;
};

template <typename T>
const T* in_ptr(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out_ptr(void* p) {
  return static_cast<T*>(p);
}

namespace tcab {

// The six tensor maps of a call: Q and dO in boxes of `qrows` rows, the
// four key-set operands in boxes of `krows`.
inline cudaError_t make_maps(CUtensorMap (&m)[6], const TcaBwdArgs& a, int qrows, int krows) {
  const void* ops[6] = {a.q, a.dout, a.ks, a.vs, a.km, a.vm};
  for (int i = 0; i < 6; ++i) {
    const cudaError_t err =
        hopper::make_map(&m[i], ops[i], a.batch, a.heads, a.seq, a.d, i < 2 ? qrows : krows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DK, int DV, int BK, int STAGES, int NC>
cudaError_t launch_dq(const TcaBwdArgs& a) {
  using C = DqCfg<DK, BK, STAGES, NC>;
  CUtensorMap m[6];
  cudaError_t err = make_maps(m, a, C::kRows, BK);
  if (err != cudaSuccess) return err;
  auto kern = tca_dq_wgmma_kernel<DK, DV, BK, STAGES, NC>;
  static bool done = false;
  if ((err = set_smem(kern, C::kSmem, done)) != cudaSuccess) return err;
  const dim3 grid((a.seq + C::kRows - 1) / C::kRows, a.batch * a.heads);
  kern<<<grid, C::kThreads, C::kSmem, a.stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], a.fg, a.tq,
                                                  a.cg, a.rows.lse, a.rows.delta,
                                                  out_ptr<bf16>(a.dq), a.heads, a.seq, a.d,
                                                  a.scale);
  return cudaGetLastError();
}

template <int DK, int DV, int BQ, int STAGES, int NC>
cudaError_t launch_dkv(const TcaBwdArgs& a) {
  using C = DkvCfg<DK, BQ, STAGES, NC>;
  CUtensorMap m[6];
  cudaError_t err = make_maps(m, a, BQ, C::kRows);
  if (err != cudaSuccess) return err;
  auto kern = tca_dkv_wgmma_kernel<DK, DV, BQ, STAGES, NC>;
  static bool done = false;
  if ((err = set_smem(kern, C::kSmem, done)) != cudaSuccess) return err;
  const dim3 grid((a.seq + C::kRows - 1) / C::kRows, a.batch * a.heads, 2);
  kern<<<grid, C::kThreads, C::kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a.fg, a.tq, a.cg, a.rows.lse, a.rows.delta,
      out_ptr<bf16>(a.dks), out_ptr<bf16>(a.dvs), out_ptr<bf16>(a.dkm), out_ptr<bf16>(a.dvm),
      a.heads, a.seq, a.d, a.scale);
  return cudaGetLastError();
}

// One head dim's instantiations: dQ with key tiles of BK through SK stages
// at one or two consumer warpgroups, of BK3 through SK3 at three (none
// where BK3 is 0); dK/dV with query tiles of BQ (64: the unit of the
// dead-pass decision) through SQ stages at one or two, SQ3 at three (none
// where SQ3 is 0).
template <int DK, int DV, int BK, int SK, int BK3, int SK3, int BQ, int SQ, int SQ3>
struct Inst {
  static constexpr int kMaxNcDq = BK3 > 0 ? 3 : 2;
  static constexpr int kMaxNcDkv = SQ3 > 0 ? 3 : 2;
  static cudaError_t dq(const TcaBwdArgs& a, int nc) {
    if constexpr (BK3 > 0) {
      if (nc == 3) return launch_dq<DK, DV, BK3, SK3, 3>(a);
    }
    return nc == 2 ? launch_dq<DK, DV, BK, SK, 2>(a) : launch_dq<DK, DV, BK, SK, 1>(a);
  }
  static cudaError_t dkv(const TcaBwdArgs& a, int nc) {
    if constexpr (SQ3 > 0) {
      if (nc == 3) return launch_dkv<DK, DV, BQ, SQ3, 3>(a);
    }
    return nc == 2 ? launch_dkv<DK, DV, BQ, SQ, 2>(a) : launch_dkv<DK, DV, BQ, SQ, 1>(a);
  }
  static int smem(bool want_dq, int nc) {
    if (!want_dq) {
      if constexpr (SQ3 > 0) {
        if (nc == 3) return DkvCfg<DK, BQ, SQ3, 3>::kSmem;
      }
      return nc == 2 ? DkvCfg<DK, BQ, SQ, 2>::kSmem : nc == 1 ? DkvCfg<DK, BQ, SQ, 1>::kSmem : -1;
    }
    if constexpr (BK3 > 0) {
      if (nc == 3) return DqCfg<DK, BK3, SK3, 3>::kSmem;
    }
    return nc == 2 ? DqCfg<DK, BK, SK, 2>::kSmem : nc == 1 ? DqCfg<DK, BK, SK, 1>::kSmem : -1;
  }
};

// Head dim -> instantiations (DK, DV, BK, SK, BK3, SK3, BQ, SQ, SQ3): the
// dQ / dV width DV (the head dim rounded up to a wgmma width), the
// products' depth DK (DV rounded up to 16), then as `Inst` reads them.
// Four streamed operands make a dQ stage twice the flash backward's: at
// d > 40, 64-key tiles through two stages; three consumers (160 registers
// a thread) only at d <= 40.  Each within the 227 KB of one CTA.
#define FF_TCA_BWD_CONFIGS(X)             \
  X(16, 16, 64, 4, 64, 4, 64, 4, 4)       \
  X(32, 24, 64, 4, 64, 4, 64, 4, 4)       \
  X(32, 32, 64, 4, 64, 4, 64, 4, 4)       \
  X(48, 40, 64, 4, 32, 4, 64, 4, 4)       \
  X(64, 64, 64, 2, 0, 0, 64, 4, 0)        \
  X(80, 80, 64, 2, 0, 0, 64, 4, 0)

cudaError_t dispatch(const TcaBwdArgs& a, bool want_dq) {
  const int bh = a.batch * a.heads;
#define FF_TCA_BWD_CASE(DK, DV, BK, SK, BK3, SK3, BQ, SQ, SQ3)                   \
  if (a.d <= DV) {                                                              \
    using I = Inst<DK, DV, BK, SK, BK3, SK3, BQ, SQ, SQ3>;                      \
    return want_dq ? I::dq(a, wgb::warpgroups(a.seq, bh, I::kMaxNcDq))          \
                   : I::dkv(a, wgb::warpgroups(a.seq, bh, I::kMaxNcDkv, 2));    \
  }
  FF_TCA_BWD_CONFIGS(FF_TCA_BWD_CASE)
#undef FF_TCA_BWD_CASE
  return cudaErrorInvalidValue;
}

int smem_bytes(int d, bool want_dq, int nc) {
#define FF_TCA_BWD_SMEM(DK, DV, BK, SK, BK3, SK3, BQ, SQ, SQ3) \
  if (d <= DV) return Inst<DK, DV, BK, SK, BK3, SK3, BQ, SQ, SQ3>::smem(want_dq, nc);
  FF_TCA_BWD_CONFIGS(FF_TCA_BWD_SMEM)
#undef FF_TCA_BWD_SMEM
  return -1;
}

}  // namespace tcab

constexpr int kFmaWarps = 4, kFmaRows = 8;

template <int DP>
cudaError_t launch_dq_fma(const TcaBwdArgs& a) {
  constexpr int kBQ = kFmaWarps * kFmaRows;
  const size_t smem = sizeof(float) * (size_t)((2 * kBQ + 4 * kBK) * (DP + 4) + 2 * kBQ * kBK);
  auto kern = tca_dq_fma_kernel<DP, kFmaWarps, kFmaRows>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.batch * a.heads);
  kern<<<grid, kFmaWarps * 32, smem, a.stream>>>(
      in_ptr<float>(a.q), in_ptr<float>(a.ks), in_ptr<float>(a.vs), in_ptr<float>(a.km),
      in_ptr<float>(a.vm), a.fg, a.tq, a.cg, in_ptr<float>(a.dout), a.rows, out_ptr<float>(a.dq),
      a.heads, a.seq, a.d, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_fma(const TcaBwdArgs& a) {
  constexpr int kKeys = kFmaWarps * kFmaRows;
  const size_t smem =
      sizeof(float) * (size_t)((2 * kKeys + 2 * kBK) * (DP + 4) + 2 * kKeys * kBK + 6 * kBK);
  auto kern = tca_dkv_fma_kernel<DP, kFmaWarps, kFmaRows>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.seq + kKeys - 1) / kKeys, a.batch * a.heads, 2);
  kern<<<grid, kFmaWarps * 32, smem, a.stream>>>(
      in_ptr<float>(a.q), in_ptr<float>(a.ks), in_ptr<float>(a.vs), in_ptr<float>(a.km),
      in_ptr<float>(a.vm), a.fg, a.tq, a.cg, in_ptr<float>(a.dout), a.rows,
      out_ptr<float>(a.dks), out_ptr<float>(a.dvs), out_ptr<float>(a.dkm), out_ptr<float>(a.dvm),
      a.heads, a.seq, a.d, a.scale);
  return cudaGetLastError();
}

// f32: DP = d padded to the FMA kernels' widths.
cudaError_t dispatch_f32(const TcaBwdArgs& a, bool want_dq) {
#define FF_FMA_CASE(DP) \
  if (a.d <= DP) return want_dq ? launch_dq_fma<DP>(a) : launch_dkv_fma<DP>(a);
  FF_FMA_CASE(16)
  FF_FMA_CASE(32)
  FF_FMA_CASE(64)
  FF_FMA_CASE(128)
#undef FF_FMA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace ff

namespace {

bool bad_dims(int d, int dtype) {
  return d <= 0 || d % 8 != 0 || d > (dtype == 1 ? 80 : 128);
}

ff::Rows rows_of(const void* lse, const void* delta, int batch, int heads, int seq) {
  return {static_cast<const float*>(lse), static_cast<const float*>(delta),
          (size_t)batch * heads * seq};
}

int bwd(const ff::TcaBwdArgs& a, int dtype, bool want_dq) {
  if (bad_dims(a.d, dtype) || a.seq < 1) return (int)cudaErrorInvalidValue;
  return (int)(dtype == 1 ? ff::tcab::dispatch(a, want_dq) : ff::dispatch_f32(a, want_dq));
}

}  // namespace

// dtype: 0 = float32 (FMA kernels, d <= 128), 1 = bfloat16 (wgmma kernels,
// d <= 80); d a multiple of 8.  lse and delta are float32 [3, batch, heads,
// seq] (self, fg, bg).  Each returns the CUDA error of its launch
// (0 = launched).
extern "C" int tca_flash_bwd_dq(const void* q, const void* k_self, const void* v_self,
                                const void* k_mod, const void* v_mod, const void* fg,
                                const void* tq, float cg, const void* dout, const void* lse,
                                const void* delta, void* dq, int batch, int heads, int seq, int d,
                                float scale, int dtype, void* stream) {
  const ff::TcaBwdArgs a{q, k_self, v_self, k_mod, v_mod, static_cast<const float*>(fg),
                         static_cast<const float*>(tq), cg, dout,
                         rows_of(lse, delta, batch, heads, seq), dq, nullptr, nullptr, nullptr,
                         nullptr, batch, heads, seq, d, scale, static_cast<cudaStream_t>(stream)};
  return bwd(a, dtype, true);
}

extern "C" int tca_flash_bwd_dkv(const void* q, const void* k_self, const void* v_self,
                                 const void* k_mod, const void* v_mod, const void* fg,
                                 const void* tq, float cg, const void* dout, const void* lse,
                                 const void* delta, void* dk_self, void* dv_self, void* dk_mod,
                                 void* dv_mod, int batch, int heads, int seq, int d, float scale,
                                 int dtype, void* stream) {
  const ff::TcaBwdArgs a{q, k_self, v_self, k_mod, v_mod, static_cast<const float*>(fg),
                         static_cast<const float*>(tq), cg, dout,
                         rows_of(lse, delta, batch, heads, seq), nullptr, dk_self, dv_self,
                         dk_mod, dv_mod, batch, heads, seq, d, scale,
                         static_cast<cudaStream_t>(stream)};
  return bwd(a, dtype, false);
}

// Dynamic shared memory (bytes) of the bf16 wgmma instantiation at head dim
// d: kernel 0 = dQ, 1 = dK/dV; warpgroups = consumer warpgroups (1 to 3);
// -1 where there is none.
extern "C" int tca_flash_bwd_smem_bytes(int d, int kernel, int warpgroups) {
  if (bad_dims(d, 1) || (kernel != 0 && kernel != 1) || warpgroups < 1 || warpgroups > 3)
    return -1;
  return ff::tcab::smem_bytes(d, kernel == 0, warpgroups);
}
