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
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, about 4.2e12 exp/s),
// per (b, h), counting the products these kernels do: dQ 12*S^2*D FLOPs
// (Q.K_self^T, Q.K_mod^T, dO.V_self^T, dO.V_mod^T, two dS.K) and 3*S^2
// exps; dK/dV 16*S^2*D FLOPs (per key set K.Q^T, V.dO^T, dS^T.Q, P^T.dO)
// and 3*S^2 exps.  On the SD-1.5 path (B*H = 24): at S = 4096, d = 40 the
// exps (1.2 G, 289 us) bound both against 193 and 258 us of products; at
// S = 1024, d = 80 the products (24 and 32 us) against 18 us of exps.
//
// Design (a first, simple version; wgmma/TMA and pipelined tiles are later
// work), no atomics, sums in a fixed order:
//   * dQ: a block owns 64 query rows (bf16: 4 warps x 16 rows on mma.sync
//     m16n8k16) and sweeps key tiles, staging K_self, V_self, K_mod, V_mod
//     and both K transposed once per tile; the self and the mod terms run
//     one after the other into one dQ accumulator, so a warp holds one
//     16 x d accumulator and one S and one dP tile at a time.
//   * dK/dV, split by key set: the grid's z = 0 blocks compute dK_self and
//     dV_self, z = 1 blocks dK_mod and dV_mod (one launch).  The split keeps
//     two 16 x d accumulators per warp, as the flash dK/dV kernel
//     (csrc/flash_sdpa_bwd.cu), instead of the TPU kernel's four: four would
//     be 160 registers at d = 80 before any S or dP tile.  The self blocks
//     recompute Q.K_self^T and dO.V_self^T, the mod blocks Q.K_mod^T and
//     dO.V_mod^T: no product is done twice.  A block owns 64 keys (16 per
//     warp) and sweeps query tiles, Q and dO staged row major and
//     transposed, the per-query lse, delta and weights in shared memory.
//   * bf16: S and dP are products of bf16 operands with f32 sums; P (the
//     weighted P for dV) and dS are rounded to bf16 for the tensor cores, as
//     in csrc/flash_sdpa_bwd.cu; the twins keep them f32.
//   * float32 (tests and the tiny configuration, d <= 128): FMA pipes, one
//     key (dQ) or one query (dK/dV) per lane, the structure of the flash
//     backward's f32 kernels.
#include "attention_common.cuh"

namespace ff {

// Per-query residuals of the three passes, read from [3, B, H, S].
struct Rows {
  const float* lse;
  const float* delta;
  size_t plane;  // B * H * S
};

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

template <int DK, int DV, int BK>
__global__ void __launch_bounds__(128)
tca_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_self,
                  const bf16* __restrict__ v_self, const bf16* __restrict__ k_mod,
                  const bf16* __restrict__ v_mod, const float* __restrict__ fg,
                  const float* __restrict__ tq, float cg, const bf16* __restrict__ dout,
                  Rows rows, bf16* __restrict__ dq, int heads, int seq, int d, float scale) {
  constexpr int kBQ = 64;
  constexpr int kLd = DK + 8, kLdT = BK + 8;
  constexpr int kKT = DK / 16, kNT = BK / 8, kOT = DV / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dos = qs + kBQ * kLd;
  bf16* kss = dos + kBQ * kLd;
  bf16* vss = kss + BK * kLd;
  bf16* kms = vss + BK * kLd;
  bf16* vms = kms + BK * kLd;
  bf16* kst = vms + BK * kLd;  // K_self transposed: [DV][BK + 8]
  bf16* kmt = kst + DV * kLdT;  // K_mod transposed
  float* fgs = reinterpret_cast<float*>(kmt + DV * kLdT);  // the tile's fg values

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const size_t off = (size_t)b * seq * e + h * d;

  load_tile_bf16<DK>(qs, q + off, q0, kBQ, seq, e, d, tid, 128);
  load_tile_bf16<DK>(dos, dout + off, q0, kBQ, seq, e, d, tid, 128);
  // per row (g, g + 8): lse and delta of the three passes and the weights
  float lse_r[3][2], dl_r[3][2], w_r[3][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    const bool ok = row < seq;
    const float tv = ok ? tq[(size_t)b * seq + row] : 0.f;
    w_r[0][hh] = ok ? 1.0f - cg : 0.f;
    w_r[1][hh] = cg * tv;
    w_r[2][hh] = ok ? cg * (1.0f - tv) : 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lse_r[a][hh] = ok ? rows.lse[a * rows.plane + (size_t)bh * seq + row] : 0.f;
      dl_r[a][hh] = ok ? rows.delta[a * rows.plane + (size_t)bh * seq + row] : 0.f;
    }
  }
  const bf16* qw = qs + warp * 16 * kLd;
  const bf16* dow = dos + warp * 16 * kLd;

  float acc[kOT][4];
#pragma unroll
  for (int ot = 0; ot < kOT; ++ot) acc[ot][0] = acc[ot][1] = acc[ot][2] = acc[ot][3] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed (and Q, dO are in place)
    load_tile_bf16<DK>(kss, k_self + off, k0, BK, seq, e, d, tid, 128);
    load_tile_bf16<DK>(vss, v_self + off, k0, BK, seq, e, d, tid, 128);
    load_tile_bf16<DK>(kms, k_mod + off, k0, BK, seq, e, d, tid, 128);
    load_tile_bf16<DK>(vms, v_mod + off, k0, BK, seq, e, d, tid, 128);
    load_tile_bf16_t<DV, BK>(kst, k_self + off, k0, seq, e, d, tid, 128);
    load_tile_bf16_t<DV, BK>(kmt, k_mod + off, k0, seq, e, d, tid, 128);
    for (int i = tid; i < BK; i += 128) {
      fgs[i] = k0 + i < seq ? fg[(size_t)b * seq + k0 + i] : 0.f;
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
    // self: dS = P (w dP - delta), dQ += dS (bf16) . K_self
    mma_abt<kKT, kNT, kLd>(s, qw, kss, g, t);
    mma_abt<kKT, kNT, kLd>(dp, dow, vss, g, t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + 2 * t + (c & 1);
        const int hh = c >> 1;
        float ds = 0.f;
        if (k0 + col < seq) {
          const float p = __expf(masked_logit(s[nt][c], scale, nullptr, col) - lse_r[0][hh]);
          ds = p * (w_r[0][hh] * dp[nt][c] - dl_r[0][hh]);
        }
        s[nt][c] = ds;
      }
    }
    pv_tile<kNT, kOT, kLdT>(acc, s, kst, g, t);

    // fg and bg: one S and one dP, dS_mod = sum of both terms, dQ += dS_mod . K_mod
    mma_abt<kKT, kNT, kLd>(s, qw, kms, g, t);
    mma_abt<kKT, kNT, kLd>(dp, dow, vms, g, t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + 2 * t + (c & 1);
        const int hh = c >> 1;
        float ds = 0.f;
        if (k0 + col < seq) {
          const float pf = __expf(masked_logit(s[nt][c], scale, fgs, col) - lse_r[1][hh]);
          const float pb = __expf(masked_logit_bg(s[nt][c], scale, fgs, col) - lse_r[2][hh]);
          ds = pf * (w_r[1][hh] * dp[nt][c] - dl_r[1][hh]) +
               pb * (w_r[2][hh] * dp[nt][c] - dl_r[2][hh]);
        }
        s[nt][c] = ds;
      }
    }
    pv_tile<kNT, kOT, kLdT>(acc, s, kmt, g, t);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row < seq) {
      bf16* orow = dq + off + (size_t)row * e;
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        const int col = ot * 8 + 2 * t;
        if (col < d) {
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(acc[ot][2 * hh] * scale, acc[ot][2 * hh + 1] * scale);
        }
      }
    }
  }
}

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

template <int DK, int DV, int BQ>
__global__ void __launch_bounds__(128)
tca_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_self,
                   const bf16* __restrict__ v_self, const bf16* __restrict__ k_mod,
                   const bf16* __restrict__ v_mod, const float* __restrict__ fg,
                   const float* __restrict__ tq, float cg, const bf16* __restrict__ dout,
                   Rows rows, bf16* __restrict__ dk_self, bf16* __restrict__ dv_self,
                   bf16* __restrict__ dk_mod, bf16* __restrict__ dv_mod, int heads, int seq,
                   int d, float scale) {
  constexpr int kKeys = 64;
  constexpr int kLd = DK + 8, kLdT = BQ + 8;
  constexpr int kKT = DK / 16, kNT = BQ / 8, kOT = DV / 8;
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + kKeys * kLd;
  bf16* qs = vs + kKeys * kLd;
  bf16* dos = qs + BQ * kLd;
  bf16* qt = dos + BQ * kLd;    // Q transposed: [DV][BQ + 8]
  bf16* dot = qt + DV * kLdT;   // dO transposed
  const QueryTile tile = carve_query_tile<BQ>(reinterpret_cast<float*>(dot + DV * kLdT));

  const bool mod = blockIdx.z == 1;  // this block's key set: self (0) or mod (1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int k0 = blockIdx.x * kKeys;
  const size_t off = (size_t)b * seq * e + h * d;
  const float* fgb = fg + (size_t)b * seq;

  load_tile_bf16<DK>(ks, (mod ? k_mod : k_self) + off, k0, kKeys, seq, e, d, tid, 128);
  load_tile_bf16<DK>(vs, (mod ? v_mod : v_self) + off, k0, kKeys, seq, e, d, tid, 128);
  int key[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) key[hh] = k0 + warp * 16 + g + 8 * hh;
  const bf16* kw = ks + warp * 16 * kLd;
  const bf16* vw = vs + warp * 16 * kLd;

  float adk[kOT][4], adv[kOT][4];
#pragma unroll
  for (int ot = 0; ot < kOT; ++ot) {
    adk[ot][0] = adk[ot][1] = adk[ot][2] = adk[ot][3] = 0.f;
    adv[ot][0] = adv[ot][1] = adv[ot][2] = adv[ot][3] = 0.f;
  }

  for (int q0 = 0; q0 < seq; q0 += BQ) {
    __syncthreads();  // the previous tiles are consumed (and K, V are in place)
    load_tile_bf16<DK>(qs, q + off, q0, BQ, seq, e, d, tid, 128);
    load_tile_bf16<DK>(dos, dout + off, q0, BQ, seq, e, d, tid, 128);
    load_tile_bf16_t<DV, BQ>(qt, q + off, q0, seq, e, d, tid, 128);
    load_tile_bf16_t<DV, BQ>(dot, dout + off, q0, seq, e, d, tid, 128);
    load_query_tile<BQ>(tile, rows, tq + (size_t)b * seq, cg, mod, bh, q0, seq, tid, 128);
    __syncthreads();

    float s[kNT][4], dp[kNT][4];  // S^T and dP^T: [16 keys x BQ queries]
    mma_abt<kKT, kNT, kLd>(s, kw, qs, g, t);
    mma_abt<kKT, kNT, kLd>(dp, vw, dos, g, t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int li = nt * 8 + 2 * t + (c & 1);
        const int kj = key[c >> 1];
        float pw = 0.f, ds = 0.f;
        if (q0 + li < seq && kj < seq) pair_terms(s[nt][c], dp[nt][c], scale, fgb, kj, mod, tile,
                                                  li, pw, ds);
        s[nt][c] = pw;
        dp[nt][c] = ds;
      }
    }
    pv_tile<kNT, kOT, kLdT>(adv, s, dot, g, t);  // dV += (w P)^T (bf16) . dO
    pv_tile<kNT, kOT, kLdT>(adk, dp, qt, g, t);  // dK += dS^T (bf16) . Q
  }

  bf16* dk = mod ? dk_mod : dk_self;
  bf16* dv = mod ? dv_mod : dv_self;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] < seq) {
      const size_t o = off + (size_t)key[hh] * e;
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        const int col = ot * 8 + 2 * t;
        if (col < d) {
          *reinterpret_cast<uint32_t*>(dk + o + col) =
              pack_bf16(adk[ot][2 * hh] * scale, adk[ot][2 * hh + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + o + col) =
              pack_bf16(adv[ot][2 * hh], adv[ot][2 * hh + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32, FMA pipes
// ---------------------------------------------------------------------------

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

template <int DK, int DV, int BK>
cudaError_t launch_dq_mma(const TcaBwdArgs& a) {
  const size_t smem = sizeof(bf16) * (size_t)((2 * 64 + 4 * BK) * (DK + 8) + 2 * DV * (BK + 8)) +
                      sizeof(float) * BK;
  auto kern = tca_dq_mma_kernel<DK, DV, BK>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.seq + 63) / 64, a.batch * a.heads);
  kern<<<grid, 128, smem, a.stream>>>(
      in_ptr<bf16>(a.q), in_ptr<bf16>(a.ks), in_ptr<bf16>(a.vs), in_ptr<bf16>(a.km),
      in_ptr<bf16>(a.vm), a.fg, a.tq, a.cg, in_ptr<bf16>(a.dout), a.rows, out_ptr<bf16>(a.dq),
      a.heads, a.seq, a.d, a.scale);
  return cudaGetLastError();
}

template <int DK, int DV, int BQ>
cudaError_t launch_dkv_mma(const TcaBwdArgs& a) {
  const size_t smem = sizeof(bf16) * (size_t)((2 * 64 + 2 * BQ) * (DK + 8) + 2 * DV * (BQ + 8)) +
                      sizeof(float) * 6 * BQ;
  auto kern = tca_dkv_mma_kernel<DK, DV, BQ>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.seq + 63) / 64, a.batch * a.heads, 2);
  kern<<<grid, 128, smem, a.stream>>>(
      in_ptr<bf16>(a.q), in_ptr<bf16>(a.ks), in_ptr<bf16>(a.vs), in_ptr<bf16>(a.km),
      in_ptr<bf16>(a.vm), a.fg, a.tq, a.cg, in_ptr<bf16>(a.dout), a.rows, out_ptr<bf16>(a.dks),
      out_ptr<bf16>(a.dvs), out_ptr<bf16>(a.dkm), out_ptr<bf16>(a.dvm), a.heads, a.seq, a.d,
      a.scale);
  return cudaGetLastError();
}

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

// bf16: (DK, DV) = head dim padded to the mma depth 16, output width; key
// (dQ) and query (dK/dV) tiles of 64, 32 at d > 48 (registers: the 16 x d
// accumulators grow with d).  f32: DP = d padded.
cudaError_t dispatch(const TcaBwdArgs& a, int dtype, bool want_dq) {
#define FF_MMA_CASE(DK, DV, T)                                               \
  if (a.d <= DV) return want_dq ? launch_dq_mma<DK, DV, T>(a) : launch_dkv_mma<DK, DV, T>(a);
#define FF_FMA_CASE(DP) \
  if (a.d <= DP) return want_dq ? launch_dq_fma<DP>(a) : launch_dkv_fma<DP>(a);
  if (dtype == 1) {
    FF_MMA_CASE(16, 16, 64)
    FF_MMA_CASE(32, 32, 64)
    FF_MMA_CASE(48, 40, 64)
    FF_MMA_CASE(64, 64, 32)
    FF_MMA_CASE(80, 80, 32)
  } else {
    FF_FMA_CASE(16)
    FF_FMA_CASE(32)
    FF_FMA_CASE(64)
    FF_FMA_CASE(128)
  }
#undef FF_MMA_CASE
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

}  // namespace

// dtype: 0 = float32 (FMA kernels, d <= 128), 1 = bfloat16 (tensor cores,
// d <= 80); d a multiple of 8.  lse and delta are float32 [3, batch, heads,
// seq] (self, fg, bg).  Each returns the CUDA error of its launch
// (0 = launched).
extern "C" int tca_flash_bwd_dq(const void* q, const void* k_self, const void* v_self,
                                const void* k_mod, const void* v_mod, const void* fg,
                                const void* tq, float cg, const void* dout, const void* lse,
                                const void* delta, void* dq, int batch, int heads, int seq, int d,
                                float scale, int dtype, void* stream) {
  if (bad_dims(d, dtype)) return (int)cudaErrorInvalidValue;
  const ff::TcaBwdArgs a{q, k_self, v_self, k_mod, v_mod, static_cast<const float*>(fg),
                         static_cast<const float*>(tq), cg, dout,
                         rows_of(lse, delta, batch, heads, seq), dq, nullptr, nullptr, nullptr,
                         nullptr, batch, heads, seq, d, scale, static_cast<cudaStream_t>(stream)};
  return (int)ff::dispatch(a, dtype, true);
}

extern "C" int tca_flash_bwd_dkv(const void* q, const void* k_self, const void* v_self,
                                 const void* k_mod, const void* v_mod, const void* fg,
                                 const void* tq, float cg, const void* dout, const void* lse,
                                 const void* delta, void* dk_self, void* dv_self, void* dk_mod,
                                 void* dv_mod, int batch, int heads, int seq, int d, float scale,
                                 int dtype, void* stream) {
  if (bad_dims(d, dtype)) return (int)cudaErrorInvalidValue;
  const ff::TcaBwdArgs a{q, k_self, v_self, k_mod, v_mod, static_cast<const float*>(fg),
                         static_cast<const float*>(tq), cg, dout,
                         rows_of(lse, delta, batch, heads, seq), nullptr, dk_self, dv_self,
                         dk_mod, dv_mod, batch, heads, seq, d, scale,
                         static_cast<cudaStream_t>(stream)};
  return (int)ff::dispatch(a, dtype, false);
}
