// tca_flash: fused temporal-contextual attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tca_kernel` behind `tca_flash`
// (freefine_tpu/ops/flash_attention.py:175 and :235, pallas_call :274).
// Same function: one sweep over the keys with three online softmaxes,
//   self : q against (k_self, v_self),
//   fg   : q against (k_mod, v_mod), logit + (fg - 1) * 1e9,
//   bg   : q against (k_mod, v_mod), logit - fg * 1e9,
// fg and bg sharing one q.k_mod product, and the epilogue
//   out = cg * (tq * o_fg + (1 - tq) * o_bg) + (1 - cg) * o_self
// with a per-query tq [B, S] and a scalar cg.  q/k/v [B, S, H*D] bf16 or
// float32; fg, tq float32 [B, S]; output in q's dtype.
//
// With `parts` and `lse` pointers (the kLse instantiations, exported as
// `tca_flash_fwd_lse`) the same kernels also write the residuals of the
// differentiable TCA: the three normalised partial outputs o_self, o_fg,
// o_bg as float32 [3, B, S, H*D] and their logsumexps m + log(max(l, 1e-30))
// as float32 [3, B, H, S].  That replaces `_tca_fwd_lse_kernel` (:569, via
// `_tca_fwd_lse` :800, pallas_call :812); the backward is
// csrc/tca_flash_bwd.cu.  A masked logit is rounded as `masked_logit` /
// `masked_logit_bg` round it, so the backward recomputes the same P from
// these logsumexps.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, about 4.2e12 exp/s
// from 16 SFU ops/clk/SM): 10*S^2*D*B*H FLOPs (two QK^T, three P.V) and
// 3*S^2*B*H exponentials.  On the SD-1.5 main path (after the head-parity
// split: B*H = 6*4 = 24, d=40 at S=4096, d=80 at S=1024) the exponentials
// bound it: 1.2 G exps at S=4096 is 0.29 ms against 161 GFLOP = 0.16 ms on
// the tensor cores.  The bytes (six [B, S, H*D] tensors, and with the
// residuals three float32 partials) are microseconds.  Counting only the
// passes whose weight is not zero (below) the exponential term drops to
// 2/3 of that for object removal (tq = 1 everywhere), to 2.16/3 for
// chip_smoke.py's edit and to 2.5/3 at random tq rows, where only the
// odd-head half skips (PERF.md gives the live-pass bound of each layout).
//
// Masking: the odd-head block of the parity split has fg = 1 for every key,
// so its bg pass masks every key.  The finite bias keeps that row uniform
// and finite (its weight 1 - tq is 0, and a NaN would survive the 0 weight);
// -inf masking would be wrong here.
//
// Two routes, by the operands' dtype:
//
// bf16 (the UNet's TCA layers; every head dim the wrapper admits, a multiple
// of 8 up to 80, maps to an instantiation): a warp-specialised wgmma kernel
// with the structure of flash_sdpa.cu's forward, on the helpers of
// hopper.cuh.  A CTA owns 128 query rows of one (b, h): one producer and
// two consumer warpgroups of 64 rows.
//   * The producer warp loads Q once, then keeps a ring of STAGES tiles of
//     BK keys full with TMA (full/empty mbarriers), each stage holding
//     K_self, V_self, K_mod and V_mod; the tensor maps describe the operands
//     as (D, H, S, B), so no box reads the next head or batch row and
//     columns past d and rows past S read as zeros.  Beside each stage it
//     writes the tile's two f32 biases, (fg - 1) * 1e9 and fg * -1e9 (-inf
//     past S), the values `masked_logit` and `masked_logit_bg` add.
//   * A consumer runs S_self = Q K_self^T and S_mod = Q K_mod^T as SS wgmma
//     in one group (the consumers take turns issuing them, one named barrier
//     each, so one's products run during the other's softmax), then per
//     live pass an online softmax on the accumulator registers, P packed to
//     bf16 as the A operand of an RS wgmma O += P V with V read MN-major
//     through its descriptor (no transposed copy of V).  Each pass's P.V is
//     issued as soon as its P exists and runs during the next pass's
//     softmax; the warpgroup waits once per tile (deferring that wait to
//     the next tile's Q K^T makes ptxas serialise the wgmmas, C7515, and
//     measured no faster).  The self logit costs one FFMA and one ex2
//     (scale * log2 e folded in); a masked logit is rounded as
//     `masked_logit` rounds it (the scale once per tile, shared by fg and
//     bg, then the bias) and the exponent is taken of its difference to the
//     row max, so a fully masked row is uniform attention with lse exactly
//     -1e9, the value the backward kernels recompute P = 1 from.  Keys past
//     S get probability exactly 0.
//   * No work on a pass whose weight is zero (the plain forward only): each
//     consumer reads its 64 rows of tq before the key loop; if every row has
//     tq = 1 the BG pass has weight cg * (1 - tq) = 0 and is skipped, if
//     every row has tq = 0 the FG pass is.  Skipped means no exponentials,
//     no statistics and no P.V: its accumulator stays 0 and the epilogue
//     composes the same expression with that partial taken as 0, which is
//     what the twin's 0 * (finite partial) adds.  The decision is made on
//     the device, uniform per warpgroup (each warp reads the same 64 rows),
//     and picks one of three instantiated key loops, so each loop is
//     straight-line wgmma code.  Object removal passes tq = 1 everywhere
//     (BG dead in every tile); an edit passes tq = 1 on the odd-head half of
//     the rows and a 0/1 object mask on the other half, so only the 64-row
//     tiles that cross the object's edge run three passes.  The kLse
//     instantiations run every pass: their partials and logsumexps are
//     outputs held to the twin's, and the backward reads all three.
//   * Registers: three 64 x d f32 accumulators take 3 d / 2 registers a
//     thread (120 at d 80), the two logit tiles BK more and three packed P
//     tiles 3 BK / 4: 64-key tiles up to d 40, 32-key tiles above, two
//     consumer warpgroups at 240 registers (a third would leave 160, room
//     for 32-key tiles only; at d 40 both 32-key variants measured slower
//     on the card).  ptxas reports no spill (phase 1 of chip_smoke.py
//     prints each instantiation).
//   * kLse stores: the composite goes out as bf16 from registers; the three
//     f32 partials are staged in the (then idle) ring, dense rows of d
//     floats per pass and warpgroup, and written by TMA stores, so the
//     epilogue issues three bulk copies instead of 3 d / 2 scattered
//     8-byte stores a thread.
// The tensor maps are encoded on the host for every call
// (`hopper::make_map`, `hopper::make_store_map_f32`) and passed as
// __grid_constant__ parameters.
//
// float32 (tests and the tiny config): one block per query tile and (b, h),
// FMA pipes, one key per lane of a 32-key tile, three float32 accumulators
// per query row.
//
// Measured times against the bound: PERF.md.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace ff {

// ---------------------------------------------------------------------------
// bf16: wgmma with a TMA ring
// ---------------------------------------------------------------------------

namespace wg {

using hopper::kPanel;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kNC = 2;  // consumer warpgroups of 64 query rows

template <int DK, int DV, int BK, int STAGES, bool kLse>
struct Cfg {
  static constexpr int kThreads = 128 * (kNC + 1);
  static constexpr int kBQ = 64 * kNC;
  // registers per thread after setmaxnreg: producer, consumers (65536 in all)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kPK = (DK + kPanel - 1) / kPanel;  // panels of a Q or K row
  static constexpr int kPV = (DV + kPanel - 1) / kPanel;  // panels of a V row
  static constexpr int kQBytes = kPK * kBQ * 128;
  static constexpr int kKBytes = kPK * BK * 128;
  static constexpr int kVBytes = kPV * BK * 128;
  // K_self | V_self | K_mod | V_mod
  static constexpr int kStageBytes = 2 * (kKBytes + kVBytes);
  // kLse: after the key loop the ring holds each consumer's three f32
  // partials, 64 rows of d floats each, for the TMA stores
  static constexpr int kPartBytes = 64 * DV * 4;
  static constexpr int kRingBytes = (kLse && 3 * kNC * kPartBytes > STAGES * kStageBytes)
                                        ? 3 * kNC * kPartBytes
                                        : STAGES * kStageBytes;
  // Q | ring | biases [STAGES][fg, bg][BK] f32 | mbarriers, from a
  // 1024-byte aligned base (the 128-byte swizzle repeats every 8 rows)
  static constexpr int kBiasOff = kQBytes + kRingBytes;
  static constexpr int kBarOff = kBiasOff + STAGES * 2 * BK * 4;
  static constexpr int kSmem = kBarOff + (2 * STAGES + 1) * 8 + 1024;
};

// Issue O += P V over one key tile (P as bf16 A fragments, V MN-major) and
// commit it as one wgmma group.
template <int DV, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[DV / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vaddr) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(vaddr + kk * 16 * 128, BK * 128, 1024);
    hopper::WgmmaRS<DV>::rs(o, pa[kk], dv);
  }
  hopper::wgmma_commit();
}

// The online-softmax step of one pass over a tile, for the thread's two
// rows (accumulator element 4 i + e is row g + 8 (e / 2), column
// 8 i + 2 t + (e % 2) of the tile): p = exp of the logits x less the new
// row max, the running max m and per-lane sum l updated, o rescaled, and P
// packed to bf16 A fragments.  LOG2: x is the unscaled product and m is in
// log2 units of the scaled logit (p = 2^(x c2 - m)); otherwise x is the
// rounded masked logit and m in its own units (p = 2^((x - m) log2 e)), so
// a fully masked row's equal logits give p = 1 exactly.
template <int BK, int DV, bool LOG2>
__device__ __forceinline__ void online_step(float (&x)[BK / 2], float c2, float (&m)[2],
                                            float (&l)[2], float (&o)[DV / 2],
                                            uint32_t (&pa)[BK / 16][4]) {
  // row maxima: four independent chains per row, then the 4 lanes of a row
  float mx[2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[hh][u] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1][(i & 1) * 2 + (e & 1)] = fmaxf(mx[e >> 1][(i & 1) * 2 + (e & 1)], x[4 * i + e]);
  float corr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float v = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    const float mn = fmaxf(m[hh], LOG2 ? v * c2 : v);
    corr[hh] = LOG2 ? hopper::ex2(m[hh] - mn) : hopper::ex2((m[hh] - mn) * kLog2e);
    m[hh] = mn;
  }
  float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const float p = LOG2 ? hopper::ex2(fmaf(x[4 * i + e], c2, -m[hh]))
                           : hopper::ex2((x[4 * i + e] - m[hh]) * kLog2e);
      ls[hh][(i & 1) * 2 + (e & 1)] += p;
      x[4 * i + e] = p;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[hh] = l[hh] * corr[hh] + ((ls[hh][0] + ls[hh][1]) + (ls[hh][2] + ls[hh][3]));
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// The masked logits of one mod pass: the scaled product xs (rounded once,
// shared by fg and bg) plus the tile's bias, rounded as `masked_logit`
// rounds it.
template <int BK>
__device__ __forceinline__ void add_bias(float (&x)[BK / 2], const float (&xs)[BK / 2],
                                         const float* bias, int t) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * i + e] = __fadd_rn(xs[4 * i + e], (e & 1) ? bb.y : bb.x);
  }
}

// Shared memory and indices of one consumer warpgroup's key loop.
struct Loop {
  uint8_t* stages;
  const float* bias;
  uint64_t *full, *empty;
  uint32_t qaddr;
  int ntiles, seq, turn, next, t;
  bool last;  // the last consumer: it opens no round after the last tile
  float scale;
};

// The key loop of one consumer warpgroup over every tile, running the self
// pass and the FG and / or BG pass (the skipped pass's accumulator and
// statistics stay untouched).
template <int DK, int DV, int BK, int STAGES, bool kLse, bool FG, bool BG>
__device__ __forceinline__ void key_loop(const Loop& lp, float (&os)[DV / 2], float (&of)[DV / 2],
                                         float (&ob)[DV / 2], float (&m)[3][2],
                                         float (&l)[3][2]) {
  using C = Cfg<DK, DV, BK, STAGES, kLse>;
  const float c2 = lp.scale * kLog2e;
  float ss[BK / 2], sm[BK / 2], x[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) ss[i] = sm[i] = 0.f;
  uint32_t ps[BK / 16][4], pf[BK / 16][4], pb[BK / 16][4];  // P of each pass, bf16

  for (int j = 0; j < lp.ntiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&lp.full[s], (j / STAGES) & 1);
    const uint32_t ks = hopper::smem_addr(lp.stages + s * C::kStageBytes);
    const uint32_t vs = ks + C::kKBytes, km = vs + C::kVBytes, vm = km + C::kKBytes;
    // S_self = Q K_self^T and S_mod = Q K_mod^T on this warpgroup's turn
    hopper::bar_sync(lp.turn, 256);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;  // 16 columns = 32 bytes
      const uint64_t da =
          hopper::desc_sw128(lp.qaddr + (kk / 4) * C::kBQ * 128 + (kk % 4) * 32, 16, 1024);
      hopper::Wgmma<BK>::ss(ss, da, hopper::desc_sw128(ks + off, 16, 1024), kk > 0);
      hopper::Wgmma<BK>::ss(sm, da, hopper::desc_sw128(km + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(ss);
    hopper::fence_regs(sm);
    if (!(lp.last && j == lp.ntiles - 1)) hopper::bar_arrive(lp.next, 256);

    const int k0 = j * BK;
    if (k0 + BK > lp.seq) {  // keys past S: probability exactly 0
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * i + 2 * lp.t + (e & 1) >= lp.seq) ss[4 * i + e] = -INFINITY;
    }
    online_step<BK, DV, true>(ss, c2, m[0], l[0], os, ps);
    pv_issue<DV, BK>(os, ps, vs);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sm[i] = __fmul_rn(sm[i], lp.scale);
    const float* bias = lp.bias + s * 2 * BK;
    if (FG) {
      add_bias<BK>(x, sm, bias, lp.t);
      online_step<BK, DV, false>(x, c2, m[1], l[1], of, pf);
      pv_issue<DV, BK>(of, pf, vm);
    }
    if (BG) {
      add_bias<BK>(x, sm, bias + BK, lp.t);
      online_step<BK, DV, false>(x, c2, m[2], l[2], ob, pb);
      pv_issue<DV, BK>(ob, pb, vm);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(os);
    hopper::fence_regs(of);
    hopper::fence_regs(ob);
    hopper::mbar_arrive(&lp.empty[s]);
  }
}

// Rows [row, row + BK) of one head into P 64-column panels (one TMA box each).
template <int P, int BK>
__device__ __forceinline__ void load_panels(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                            int h, int row, int b) {
#pragma unroll
  for (int p = 0; p < P; ++p) hopper::tma_load_4d(dst + p * BK * 128, map, bar, p * kPanel, h, row, b);
}

// A pass's normalised partial (the thread's rows r and r + 8 of the
// accumulator o) into 64 dense rows of d floats in shared memory.
template <int DV>
__device__ __forceinline__ void stage_rows(float* dst, const float (&o)[DV / 2],
                                           const float (&inv)[2], int r, int d, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* row = dst + (r + 8 * hh) * d;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < d)
        *reinterpret_cast<float2*>(row + col) =
            make_float2(o[4 * i + 2 * hh] * inv[hh], o[4 * i + 2 * hh + 1] * inv[hh]);
    }
  }
}

template <int DK, int DV, int BK, int STAGES, bool kLse>
__global__ void __launch_bounds__(128 * (kNC + 1), 1)
tca_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_ks,
                     const __grid_constant__ CUtensorMap tm_vs,
                     const __grid_constant__ CUtensorMap tm_km,
                     const __grid_constant__ CUtensorMap tm_vm,
                     const __grid_constant__ CUtensorMap tm_parts, const float* __restrict__ fg,
                     const float* __restrict__ tq, float cg, bf16* __restrict__ out,
                     float* __restrict__ lse, int heads, int seq, int d, float scale) {
  using C = Cfg<DK, DV, BK, STAGES, kLse>;
  constexpr int kBQ = C::kBQ;
  static_assert(DK % 16 == 0 && DV % 8 == 0 && BK % 16 == 0, "wgmma tile shapes");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (hopper::smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* stages = base + C::kQBytes;
  float* bias = reinterpret_cast<float*>(base + C::kBiasOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kBarOff);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, wgi = tid / 128;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (seq + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);          // the producer warp's lanes (one with the bytes)
      hopper::mbar_init(&empty[s], 128 * kNC);  // every consumer thread
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer warpgroup: one warp issues, three idle ----
    hopper::regs_dec<C::kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        hopper::mbar_arrive_tx(qbar, C::kQBytes);
#pragma unroll
        for (int p = 0; p < C::kPK; ++p)
          hopper::tma_load_4d(base + p * kBQ * 128, &tm_q, qbar, p * kPanel, h, q0, b);
      }
      const float* frow = fg + (size_t)b * seq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // first round passes
        float* bs = bias + s * 2 * BK;
        for (int c = lane; c < BK; c += 32) {
          const int col = j * BK + c;
          const float f = col < seq ? frow[col] : 0.f;
          bs[c] = col < seq ? (f - 1.0f) * kMaskBias : -INFINITY;  // fg pass
          bs[BK + c] = col < seq ? f * -kMaskBias : -INFINITY;     // bg pass
        }
        if (lane == 0) {
          uint8_t* st = stages + s * C::kStageBytes;
          hopper::mbar_arrive_tx(&full[s], C::kStageBytes);
          load_panels<C::kPK, BK>(st, &tm_ks, &full[s], h, j * BK, b);
          load_panels<C::kPV, BK>(st + C::kKBytes, &tm_vs, &full[s], h, j * BK, b);
          load_panels<C::kPK, BK>(st + C::kKBytes + C::kVBytes, &tm_km, &full[s], h, j * BK, b);
          load_panels<C::kPV, BK>(st + 2 * C::kKBytes + C::kVBytes, &tm_vm, &full[s], h, j * BK,
                                  b);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  hopper::regs_inc<C::kConsumerRegs>();
  const int cw = wgi - 1;  // 0 .. kNC - 1
  const int ctid = tid - 128 * wgi;
  const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + cw * 64;  // this warpgroup's first query row
  // turns on the tensor cores in round robin: named barrier 1 + c is
  // consumer c's; the last consumer opens the first round for consumer 0
  if (cw == kNC - 1) hopper::bar_arrive(1, 256);

  float os[DV / 2], of[DV / 2], ob[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) os[i] = of[i] = ob[i] = 0.f;
  // running max (self: log2 units of the scaled logit) and partial sums
  float m[3][2], l[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a][0] = m[a][1] = -INFINITY, l[a][0] = l[a][1] = 0.f;

  hopper::mbar_wait(qbar, 0);
  const Loop lp{stages, bias, full, empty, hopper::smem_addr(base) + cw * 64 * 128, ntiles, seq,
                1 + cw, 1 + (cw + 1) % kNC, t, cw == kNC - 1, scale};
  if constexpr (kLse) {
    key_loop<DK, DV, BK, STAGES, kLse, true, true>(lp, os, of, ob, m, l);
  } else {
    // The passes this warpgroup runs: every row's tq 1 kills BG, every
    // row's tq 0 kills FG (each warp reads the same 64 rows: the choice is
    // uniform over the warpgroup).
    const float* tr = tq + (size_t)b * seq + r0;
    bool one = true, zero = true;
    for (int r = lane; r < 64; r += 32) {
      if (r0 + r < seq) {
        const float w = tr[r];
        one = one && w == 1.0f;
        zero = zero && w == 0.0f;
      }
    }
    if (__all_sync(0xffffffffu, one))
      key_loop<DK, DV, BK, STAGES, kLse, true, false>(lp, os, of, ob, m, l);
    else if (__all_sync(0xffffffffu, zero))
      key_loop<DK, DV, BK, STAGES, kLse, false, true>(lp, os, of, ob, m, l);
    else
      key_loop<DK, DV, BK, STAGES, kLse, true, true>(lp, os, of, ob, m, l);
  }

  // epilogue: a skipped pass has o = 0 and l = 0, so its partial is 0
#pragma unroll
  for (int a = 0; a < 3; ++a) finish_rows(l[a]);
  float inv[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) inv[a][0] = 1.0f / l[a][0], inv[a][1] = 1.0f / l[a][1];
  const int e = heads * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + warp * 16 + g + 8 * hh;
    if (row >= seq) continue;
    const float w = tq[(size_t)b * seq + row];
    if (kLse && t == 0) {
      const size_t lrow = (size_t)bh * seq + row, lplane = (size_t)gridDim.y * seq;
      lse[lrow] = (m[0][hh] + log2f(l[0][hh])) * kLn2;
      lse[lplane + lrow] = m[1][hh] + logf(l[1][hh]);
      lse[2 * lplane + lrow] = m[2][hh] + logf(l[2][hh]);
    }
    bf16* orow = out + ((size_t)b * seq + row) * e + h * d;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < d) {
        float r[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = 4 * i + 2 * hh + c;
          const float p_self = os[k] * inv[0][hh], p_fg = of[k] * inv[1][hh],
                      p_bg = ob[k] * inv[2][hh];
          r[c] = cg * (w * p_fg + (1.0f - w) * p_bg) + (1.0f - cg) * p_self;
        }
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(r[0], r[1]);
      }
    }
  }

  if constexpr (kLse) {
    // every consumer is past its last tile: the ring is free for the
    // partials, 64 dense rows of d floats per pass and warpgroup
    hopper::bar_sync(kNC + 1, 128 * kNC);
    float* stage_out = reinterpret_cast<float*>(stages) + cw * 3 * 64 * DV;
    const int r = warp * 16 + g;
    stage_rows<DV>(stage_out, os, inv[0], r, d, t);
    stage_rows<DV>(stage_out + 64 * DV, of, inv[1], r, d, t);
    stage_rows<DV>(stage_out + 2 * 64 * DV, ob, inv[2], r, d, t);
    hopper::fence_async_smem();
    hopper::bar_sync(kNC + 1, 128 * kNC);
    if (ctid == 0 && r0 < seq) {
      const int batch = gridDim.y / heads;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        hopper::tma_store_4d(&tm_parts, stage_out + a * 64 * DV, 0, h, r0, a * batch + b);
      hopper::bulk_commit();
      hopper::bulk_wait_read();
    }
  }
}

// The launch arguments of both entry points; parts and lse are null for
// the plain forward.
struct FwdArgs {
  const void *q, *ks, *vs, *km, *vm, *fg, *tq;
  float cg;
  void* out;
  float *parts, *lse;
  int batch, heads, seq, d;
  float scale;
  cudaStream_t stream;
};

template <int DK, int DV, int BK, int STAGES, bool kLse>
cudaError_t launch(const FwdArgs& a) {
  using C = Cfg<DK, DV, BK, STAGES, kLse>;
  static_assert(C::kSmem <= 232448, "shared memory of one CTA");
  CUtensorMap maps[6];
  const void* ops[5] = {a.q, a.ks, a.vs, a.km, a.vm};
  cudaError_t err;
  for (int i = 0; i < 5; ++i) {
    err = hopper::make_map(&maps[i], ops[i], a.batch, a.heads, a.seq, a.d, i == 0 ? C::kBQ : BK);
    if (err != cudaSuccess) return err;
  }
  if constexpr (kLse) {
    err = hopper::make_store_map_f32(&maps[5], a.parts, 3 * a.batch, a.heads, a.seq, a.d, 64);
    if (err != cudaSuccess) return err;
  } else {
    maps[5] = maps[0];  // not read
  }
  auto kern = tca_fwd_wgmma_kernel<DK, DV, BK, STAGES, kLse>;
  static bool done = false;
  if ((err = set_smem(kern, C::kSmem, done)) != cudaSuccess) return err;
  const dim3 grid((a.seq + C::kBQ - 1) / C::kBQ, a.batch * a.heads);
  kern<<<grid, C::kThreads, C::kSmem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<const float*>(a.fg),
      static_cast<const float*>(a.tq), a.cg, static_cast<bf16*>(a.out), a.lse, a.heads, a.seq,
      a.d, a.scale);
  return cudaGetLastError();
}

// Head dim -> instantiation (DK, DV, BK, STAGES): the P V width DV (the
// head dim rounded up to the next width), the Q K^T depth DK (DV rounded up
// to 16), the key tile (64 up to d 40, 32 above: registers) and the ring
// depth.
#define FF_TCA_CONFIGS(X) \
  X(16, 16, 64, 4)        \
  X(32, 24, 64, 4)        \
  X(32, 32, 64, 4)        \
  X(48, 40, 64, 4)        \
  X(64, 64, 32, 4)        \
  X(80, 80, 32, 4)

cudaError_t dispatch(const FwdArgs& a) {
#define FF_TCA_LAUNCH(DK, DV, BK, ST) \
  if (a.d <= DV) return a.lse ? launch<DK, DV, BK, ST, true>(a) : launch<DK, DV, BK, ST, false>(a);
  FF_TCA_CONFIGS(FF_TCA_LAUNCH)
#undef FF_TCA_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32: FMA pipes
// ---------------------------------------------------------------------------

using wg::FwdArgs;

// float32 version (FMA pipes).
template <int DP, int WARPS, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
tca_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k_self,
               const float* __restrict__ v_self, const float* __restrict__ k_mod,
               const float* __restrict__ v_mod, const float* __restrict__ fg,
               const float* __restrict__ tq, float cg, float* __restrict__ out,
               float* __restrict__ parts, float* __restrict__ lse, int heads, int seq, int d,
               float scale) {
  constexpr int kLd = DP + 4;
  constexpr int kBQ = WARPS * ROWS;
  constexpr int kNC = (DP + 31) / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kss = qs + kBQ * kLd;
  float* vss = kss + kBK * kLd;
  float* kms = vss + kBK * kLd;
  float* vms = kms + kBK * kLd;
  float* ps = vms + kBK * kLd;  // [3][kBQ][kBK]: self, fg, bg

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = WARPS * 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const size_t off = (size_t)b * seq * e + h * d;
  const float* fgb = fg + (size_t)b * seq;

  load_tile<DP>(qs, q + off, q0, kBQ, seq, e, d, tid, nthreads);

  float m[3][ROWS], l[3][ROWS], acc[3][ROWS][kNC];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[a][r] = kMInit;
      l[a][r] = 0.f;
#pragma unroll
      for (int i = 0; i < kNC; ++i) acc[a][r][i] = 0.f;
    }
  }
  const float* qw = qs + warp * ROWS * kLd;
  float* pw[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) pw[a] = ps + (a * kBQ + warp * ROWS) * kBK;

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();
    load_tile<DP>(kss, k_self + off, k0, kBK, seq, e, d, tid, nthreads);
    load_tile<DP>(vss, v_self + off, k0, kBK, seq, e, d, tid, nthreads);
    load_tile<DP>(kms, k_mod + off, k0, kBK, seq, e, d, tid, nthreads);
    load_tile<DP>(vms, v_mod + off, k0, kBK, seq, e, d, tid, nthreads);
    __syncthreads();

    float s_self[ROWS], s_mod[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s_self[r] = s_mod[r] = 0.f;
    const float* ksr = kss + lane * kLd;
    const float* kmr = kms + lane * kLd;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(ksr + c);
      const float4 bm = *reinterpret_cast<const float4*>(kmr + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * kLd + c);
        s_self[r] = fmaf(qq.x, a.x, s_self[r]);
        s_self[r] = fmaf(qq.y, a.y, s_self[r]);
        s_self[r] = fmaf(qq.z, a.z, s_self[r]);
        s_self[r] = fmaf(qq.w, a.w, s_self[r]);
        s_mod[r] = fmaf(qq.x, bm.x, s_mod[r]);
        s_mod[r] = fmaf(qq.y, bm.y, s_mod[r]);
        s_mod[r] = fmaf(qq.z, bm.z, s_mod[r]);
        s_mod[r] = fmaf(qq.w, bm.w, s_mod[r]);
      }
    }
    const int j = k0 + lane;
    const bool valid = j < seq;

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float sv[3];
      sv[0] = valid ? masked_logit(s_self[r], scale, nullptr, j) : -INFINITY;
      sv[1] = valid ? masked_logit(s_mod[r], scale, fgb, j) : -INFINITY;
      sv[2] = valid ? masked_logit_bg(s_mod[r], scale, fgb, j) : -INFINITY;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float mn = fmaxf(m[a][r], warp_max(sv[a]));
        const float corr = __expf(m[a][r] - mn);
        const float p = __expf(sv[a] - mn);
        l[a][r] = l[a][r] * corr + p;
#pragma unroll
        for (int i = 0; i < kNC; ++i) acc[a][r][i] *= corr;
        m[a][r] = mn;
        pw[a][r * kBK + lane] = p;
      }
    }
    __syncwarp();

    for (int jj = 0; jj < kBK; jj += 4) {
      float vsv[4][kNC], vmv[4][kNC];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int i = 0; i < kNC; ++i) {
          const int c = lane + 32 * i;
          vsv[t][i] = (c < DP) ? vss[(jj + t) * kLd + c] : 0.f;
          vmv[t][i] = (c < DP) ? vms[(jj + t) * kLd + c] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p0 = *reinterpret_cast<const float4*>(pw[0] + r * kBK + jj);
        const float4 p1 = *reinterpret_cast<const float4*>(pw[1] + r * kBK + jj);
        const float4 p2 = *reinterpret_cast<const float4*>(pw[2] + r * kBK + jj);
#pragma unroll
        for (int i = 0; i < kNC; ++i) {
          float x = acc[0][r][i];
          x = fmaf(p0.x, vsv[0][i], x);
          x = fmaf(p0.y, vsv[1][i], x);
          x = fmaf(p0.z, vsv[2][i], x);
          x = fmaf(p0.w, vsv[3][i], x);
          acc[0][r][i] = x;
          x = acc[1][r][i];
          x = fmaf(p1.x, vmv[0][i], x);
          x = fmaf(p1.y, vmv[1][i], x);
          x = fmaf(p1.z, vmv[2][i], x);
          x = fmaf(p1.w, vmv[3][i], x);
          acc[1][r][i] = x;
          x = acc[2][r][i];
          x = fmaf(p2.x, vmv[0][i], x);
          x = fmaf(p2.y, vmv[1][i], x);
          x = fmaf(p2.z, vmv[2][i], x);
          x = fmaf(p2.w, vmv[3][i], x);
          acc[2][r][i] = x;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float ls = fmaxf(warp_sum(l[0][r]), 1e-30f);
    const float lf = fmaxf(warp_sum(l[1][r]), 1e-30f);
    const float lb = fmaxf(warp_sum(l[2][r]), 1e-30f);
    const int qi = q0 + warp * ROWS + r;
    if (qi < seq) {
      const float t = tq[(size_t)b * seq + qi];
      const size_t row = ((size_t)b * seq + qi) * e + h * d;
      const size_t plane = (size_t)gridDim.y * seq * d;  // one [B, S, H*D] partial
      if (lse && lane == 0) {
        const size_t lrow = (size_t)bh * seq + qi, lplane = (size_t)gridDim.y * seq;
        lse[lrow] = m[0][r] + logf(ls);
        lse[lplane + lrow] = m[1][r] + logf(lf);
        lse[2 * lplane + lrow] = m[2][r] + logf(lb);
      }
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          const float o_self = acc[0][r][i] / ls;
          const float o_fg = acc[1][r][i] / lf;
          const float o_bg = acc[2][r][i] / lb;
          const float modulated = t * o_fg + (1.0f - t) * o_bg;
          out[row + c] = (cg * modulated + (1.0f - cg) * o_self);
          if (parts) {
            parts[row + c] = o_self;
            parts[plane + row + c] = o_fg;
            parts[2 * plane + row + c] = o_bg;
          }
        }
      }
    }
  }
}

template <int DP, int WARPS, int ROWS>
cudaError_t launch(const FwdArgs& a) {
  constexpr int kLd = DP + 4;
  constexpr int kBQ = WARPS * ROWS;
  const size_t smem = sizeof(float) * (size_t)(kBQ * kLd + 4 * kBK * kLd + 3 * kBQ * kBK);
  auto kern = tca_fwd_kernel<DP, WARPS, ROWS>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.batch * a.heads);
  kern<<<grid, WARPS * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const float*>(a.km),
      static_cast<const float*>(a.vm), static_cast<const float*>(a.fg),
      static_cast<const float*>(a.tq), a.cg, static_cast<float*>(a.out), a.parts, a.lse,
      a.heads, a.seq, a.d, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fma(const FwdArgs& a) {
#define FF_TCA_CASE(DP, W, R) \
  if (a.d <= DP) return launch<DP, W, R>(a);
  FF_TCA_CASE(16, 8, 4)
  FF_TCA_CASE(32, 8, 4)
  FF_TCA_CASE(64, 8, 4)
  FF_TCA_CASE(160, 8, 2)
#undef FF_TCA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace ff

namespace {

int fwd(const ff::FwdArgs& a, int dtype) {
  if (a.d <= 0 || a.d % 8 != 0 || a.d > (dtype == 1 ? 80 : 160)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(dtype == 1 ? ff::wg::dispatch(a) : ff::dispatch_fma(a));
}

}  // namespace

// dtype: 0 = float32 (FMA kernel, d <= 160), 1 = bfloat16 (wgmma kernel,
// d <= 80); d a multiple of 8.  Returns the CUDA error of the launch.
extern "C" int tca_flash_fwd(const void* q, const void* k_self, const void* v_self,
                             const void* k_mod, const void* v_mod, const void* fg,
                             const void* tq, float cg, void* out, int batch, int heads, int seq,
                             int d, float scale, int dtype, void* stream) {
  return fwd({q, k_self, v_self, k_mod, v_mod, fg, tq, cg, out, nullptr, nullptr, batch, heads,
              seq, d, scale, static_cast<cudaStream_t>(stream)},
             dtype);
}

// The same, also writing the partial outputs parts [3, batch, seq, heads*d]
// and their logsumexps lse [3, batch, heads, seq], both float32 (passes
// self, fg, bg).
extern "C" int tca_flash_fwd_lse(const void* q, const void* k_self, const void* v_self,
                                 const void* k_mod, const void* v_mod, const void* fg,
                                 const void* tq, float cg, void* out, void* parts, void* lse,
                                 int batch, int heads, int seq, int d, float scale, int dtype,
                                 void* stream) {
  return fwd({q, k_self, v_self, k_mod, v_mod, fg, tq, cg, out, static_cast<float*>(parts),
              static_cast<float*>(lse), batch, heads, seq, d, scale,
              static_cast<cudaStream_t>(stream)},
             dtype);
}
