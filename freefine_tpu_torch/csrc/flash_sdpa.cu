// flash_sdpa: streaming softmax attention with an optional per-key 0/1
// mask, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind `flash_sdpa`
// (freefine_tpu/ops/flash_attention.py:80, called at :145).  Same function:
// q [B, Sq, H*D], k/v [B, Sk, H*D] in bf16 or float32, key_mask [B, Sk]
// float32 0/1 (or none) applied as a finite -1e9 bias on the scaled f32
// logit; output [B, Sq, H*D] in q's dtype.  With an lse pointer the same
// kernels also write the per-row natural-log logsumexp as float32
// [B, H, Sq]: the forward of the differentiable attention, replacing
// `_flash_fwd_lse_kernel` (:307, called at :455), exported as its own entry
// point (`flash_sdpa_fwd_lse`) and counted as its own kernel by the wrapper.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32 outside the
// tensor cores, 3.35 TB/s, about 4.2e12 exp/s from 16 SFU ops/clk/SM): the
// work is 4*Sq*Sk*D*B*H FLOPs and Sq*Sk*B*H exponentials; the bytes are far
// below both.  Per call at the SD-1.5 shapes (B*H = 16 at batch 2):
//   * S 4096, d 40: 4.0 us of exponentials per (b, h) against 2.7 us of
//     tensor-core FLOPs, 64 us per call: the SFU sets the bound;
//   * S 1024, d 80: 0.34 us of FLOPs per (b, h) (0.25 of exps), 5.4 us;
//   * S 256 and 64, d 160: under 1 us per call; launch latency rules;
//   * the VAE's float32 d = 512 (1 head, S 4096): 69 GFLOP of f32 FMA at
//     batch 2, 1.03 ms (0.51 ms at batch 1).
//
// Two routes, chosen by the caller (`flash_route` in
// ops/flash_attention.py) and passed in as an int:
//
// Route 1, bf16 (every UNet self-attention, d <= 160): a warp-specialised
// wgmma kernel.  A CTA owns 64 * NC query rows of one (b, h) and runs one
// producer and NC consumer warpgroups (NC = 3 at d <= 64, 2 above):
//   * a producer warp loads Q once and then keeps a ring of STAGES K/V tiles
//     full with TMA (full/empty mbarriers); the tensor maps describe the
//     operands as (D, H, S, B), so a 64-column box past column d reads zeros,
//     never the next head, and rows past S read zeros, never the next batch
//     row.  With a key mask the same warp writes the tile's f32 bias
//     ((mask - 1) * 1e9, -inf past Sk) beside it.  It gives its registers
//     away (setmaxnreg);
//   * each consumer warpgroup of 64 query rows computes S = Q K^T with wgmma
//     (Q and K K-major in shared memory, 128-byte swizzle) and O += P V with
//     wgmma, P taken from the S accumulator registers packed to bf16 as the
//     A operand and V read MN-major (the transpose is in the descriptor; no
//     transposed copy of V);
//   * the consumers take turns on the tensor cores in round robin (one named
//     barrier each): a warpgroup issues its Q K^T, waits for it and passes
//     the turn on, so the next warpgroup's product runs during its softmax.
//     Issuing S_{j+1} before the softmax of S_j instead (two S tiles in
//     flight per warpgroup) measured slower at d = 40 (PERF.md): there the
//     kernel is bound by each warpgroup's serial path per tile (wgmma
//     latency, row reductions), not by the SFU, and more warpgroups hide
//     more of it;
//   * unmasked, a logit costs one FFMA (scale * log2 e folded in) and one
//     ex2 in log2 units.  Masked, the logit is rounded exactly as
//     `masked_logit` rounds it (scale, then the bias) and the exponent is
//     taken of the difference to the row max, so a fully masked row is
//     uniform attention with lse exactly -1e9, the value the backward
//     kernels recompute P = 1 from;
//   * padding: the head dim is padded to 16 for Q K^T (zeros from the
//     tensor map), the P V width is the head dim rounded up to the next
//     instantiated width; keys past Sk get probability exactly 0 (-inf).
// Every bf16 head dim the wrapper accepts (a multiple of 8 up to 160) maps
// to an instantiation: no other bf16 route exists.  The tensor maps are
// encoded on the host for every call (`hopper::make_map`: cuTensorMapEncodeTiled,
// fetched from the driver through the runtime) and passed as __grid_constant__.
//
// Route 0, float32 (the VAE, d = 512, and the tiny config): split-TF32
// products on the tensor cores (mma.sync m16n8k8; each operand split into
// a TF32 high part and a TF32 remainder, three products per pair), chosen
// over a register-tiled FMA kernel because it measured faster at the VAE
// shape within the f32 limits.  A CTA of 8 warps owns 32 query rows; Q stays in shared memory
// and K and V tiles of 32 keys stream through one buffer each with
// cp.async, each load overlapping the other product.  Each warp computes
// the partial S of 16 rows over a quarter of the head dim, the partials are
// summed in the softmax (rounded as `masked_logit` rounds, -1e30 running
// max), and each warp then accumulates P V for 16 rows and a quarter of
// the output columns: each tile's products from zero on the tensor cores,
// added to the output by FFMA (the tensor cores' sums round toward zero,
// a bias that carrying the output through them would grow with Sk).
//
// Measured times against the bound: PERF.md.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace ff {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Route 1: bf16, wgmma with a TMA ring
// ---------------------------------------------------------------------------

namespace wg {

using hopper::kPanel;
using hopper::make_map;

// NC consumer warpgroups of 64 query rows each, one producer warpgroup.
template <int DK, int DV, int BK, int STAGES, int NC>
struct Cfg {
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBQ = 64 * NC;
  // registers per thread after setmaxnreg: producer, consumers (65536 in all)
  static constexpr int kProducerRegs = NC == 2 ? 24 : 32;
  static constexpr int kConsumerRegs = NC == 2 ? 240 : 160;
  static constexpr int kPK = (DK + kPanel - 1) / kPanel;  // panels of a Q or K row
  static constexpr int kPV = (DV + kPanel - 1) / kPanel;  // panels of a V row
  static constexpr int kQBytes = kPK * kBQ * 128;
  static constexpr int kKBytes = kPK * BK * 128;
  static constexpr int kVBytes = kPV * BK * 128;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // Q | STAGES x (K | V) | bias [STAGES][BK] f32 | mbarriers, from a
  // 1024-byte aligned base (the 128-byte swizzle repeats every 8 rows)
  static constexpr int kBiasOff = kQBytes + STAGES * kStageBytes;
  static constexpr int kBarOff = kBiasOff + STAGES * BK * 4;
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

template <int DK, int DV, int BK, int STAGES, int NC, bool MASKED>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ key_mask,
                       bf16* __restrict__ out, float* __restrict__ lse, int heads, int sq, int sk,
                       int d, float scale) {
  using C = Cfg<DK, DV, BK, STAGES, NC>;
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
  const int ntiles = (sk + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);    // the producer warp's lanes (one with the bytes)
      hopper::mbar_init(&empty[s], 128 * NC);  // every consumer thread
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
          hopper::tma_load_4d(base + p * kBQ * 128, &tq, qbar, p * kPanel, h, q0, b);
      }
      const float* mrow = MASKED ? key_mask + (size_t)b * sk : nullptr;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // first round passes
        if (MASKED) {
          for (int c = lane; c < BK; c += 32) {
            const int col = j * BK + c;
            bias[s * BK + c] = col < sk ? (mrow[col] - 1.0f) * kMaskBias : -INFINITY;
          }
        }
        if (lane == 0) {
          uint8_t* ks = stages + s * C::kStageBytes;
          uint8_t* vs = ks + C::kKBytes;
          hopper::mbar_arrive_tx(&full[s], C::kStageBytes);
#pragma unroll
          for (int p = 0; p < C::kPK; ++p)
            hopper::tma_load_4d(ks + p * BK * 128, &tk, &full[s], p * kPanel, h, j * BK, b);
#pragma unroll
          for (int p = 0; p < C::kPV; ++p)
            hopper::tma_load_4d(vs + p * BK * 128, &tv, &full[s], p * kPanel, h, j * BK, b);
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  hopper::regs_inc<C::kConsumerRegs>();
  const int cw = wgi - 1;  // 0 .. NC - 1
  const int ctid = tid - 128 * wgi;
  const int warp = ctid / 32, lane = ctid % 32, g = lane / 4, t = lane % 4;
  // turns on the tensor cores in round robin: named barrier 1 + c is
  // consumer c's; the last consumer opens the first round for consumer 0
  const int turn = 1 + cw, next = 1 + (cw + 1) % NC;
  if (cw == NC - 1) hopper::bar_arrive(1, 256);

  float o[DV / 2], sacc[BK / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
  uint32_t pa[BK / 16][4];  // P of the tile as bf16 A fragments
  // running max (unmasked: in log2 units of the scaled logit) and partial sums
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float c2 = scale * kLog2e;

  hopper::mbar_wait(qbar, 0);
  const uint32_t qaddr = hopper::smem_addr(base) + cw * 64 * 128;

  // Tile j: on this warpgroup's turn issue S_j = Q K_j^T, wait for it and
  // pass the turn on, so the next warpgroup's products run during this
  // one's softmax; then O += P_j V_j and release the stage.
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    const uint32_t kaddr = hopper::smem_addr(stages + s * C::kStageBytes);
    hopper::bar_sync(turn, 256);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the panel
      const uint64_t da = hopper::desc_sw128(qaddr + (kk / 4) * kBQ * 128 + off, 16, 1024);
      const uint64_t db = hopper::desc_sw128(kaddr + (kk / 4) * BK * 128 + off, 16, 1024);
      hopper::Wgmma<BK>::ss(sacc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (!(cw == NC - 1 && j == ntiles - 1)) hopper::bar_arrive(next, 256);
    // online softmax on the accumulator: element 4 i + e is row g + 8 (e / 2),
    // column 8 i + 2 t + (e % 2) of the tile
    const int k0 = j * BK;
    if (MASKED) {
      const float* bs = bias + s * BK;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * i + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[4 * i + e] = __fadd_rn(__fmul_rn(sacc[4 * i + e], scale), (e & 1) ? bb.y : bb.x);
      }
    } else if (k0 + BK > sk) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * i + 2 * t + (e & 1) >= sk) sacc[4 * i + e] = -INFINITY;
      }
    }
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
        mx[e >> 1][(i & 1) * 2 + (e & 1)] = fmaxf(mx[e >> 1][(i & 1) * 2 + (e & 1)], sacc[4 * i + e]);
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const float mn = fmaxf(m[hh], MASKED ? v : v * c2);
      corr[hh] = MASKED ? hopper::ex2((m[hh] - mn) * kLog2e) : hopper::ex2(m[hh] - mn);
      m[hh] = mn;
    }
    float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float x = sacc[4 * i + e];
        const float p = MASKED ? hopper::ex2((x - m[hh]) * kLog2e) : hopper::ex2(fmaf(x, c2, -m[hh]));
        ls[hh][(i & 1) * 2 + (e & 1)] += p;
        sacc[4 * i + e] = p;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      l[hh] = l[hh] * corr[hh] + ((ls[hh][0] + ls[hh][1]) + (ls[hh][2] + ls[hh][3]));
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
    // O += P V: P (bf16) from the accumulator registers, V MN-major
    pv_issue<DV, BK>(o, pa, kaddr + C::kKBytes);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(&empty[s]);
  }

  finish_rows(l);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + cw * 64 + warp * 16 + g + 8 * hh;
    if (row >= sq) continue;
    if (lse && t == 0)
      lse[(size_t)bh * sq + row] = MASKED ? m[hh] + logf(l[hh]) : (m[hh] + log2f(l[hh])) * kLn2;
    const float inv = 1.0f / l[hh];
    bf16* orow = out + ((size_t)b * sq + row) * heads * d + h * d;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * i + 2 * hh] * inv, o[4 * i + 2 * hh + 1] * inv);
    }
  }
}

template <int DK, int DV, int BK, int STAGES, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* lse, int batch, int heads, int sq, int sk, int d, float scale,
                   cudaStream_t stream) {
  using C = Cfg<DK, DV, BK, STAGES, NC>;
  constexpr int kBQ = C::kBQ;
  static_assert(C::kSmem <= 232448, "shared memory of one CTA");
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, batch, heads, sq, d, kBQ)) != cudaSuccess) return err;
  if ((err = make_map(&tk, k, batch, heads, sk, d, BK)) != cudaSuccess) return err;
  if ((err = make_map(&tv, v, batch, heads, sk, d, BK)) != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  const float* m = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(out);
  if (mask != nullptr) {
    auto kern = flash_fwd_wgmma_kernel<DK, DV, BK, STAGES, NC, true>;
    static bool done = false;
    if ((err = set_smem(kern, C::kSmem, done)) != cudaSuccess) return err;
    kern<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, m, o, lse, heads, sq, sk, d, scale);
  } else {
    auto kern = flash_fwd_wgmma_kernel<DK, DV, BK, STAGES, NC, false>;
    static bool done = false;
    if ((err = set_smem(kern, C::kSmem, done)) != cudaSuccess) return err;
    kern<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, m, o, lse, heads, sq, sk, d, scale);
  }
  return cudaGetLastError();
}

// Head dim -> instantiation (DK, DV, BK, STAGES, NC): the P V width DV (the
// head dim rounded up to the next width), the Q K^T depth DK (DV rounded up
// to 16), the key tile, the ring depth within the 227 KB of one CTA and the
// consumer warpgroups.
#define FF_WG_CONFIGS(X) \
  X(16, 16, 128, 4, 3)   \
  X(32, 24, 128, 4, 3)   \
  X(32, 32, 128, 4, 3)   \
  X(48, 40, 128, 4, 3)   \
  X(64, 64, 128, 4, 3)   \
  X(80, 80, 64, 4, 2)    \
  X(128, 128, 64, 4, 2)  \
  X(160, 160, 64, 3, 2)

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* mask, void* out,
                     float* lse, int batch, int heads, int sq, int sk, int d, float scale,
                     cudaStream_t stream) {
#define FF_WG_LAUNCH(DK, DV, BK, ST, NC) \
  if (d <= DV) return launch<DK, DV, BK, ST, NC>(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, stream);
  FF_WG_CONFIGS(FF_WG_LAUNCH)
#undef FF_WG_LAUNCH
  return cudaErrorInvalidValue;
}

int smem_bytes(int d) {
#define FF_WG_SMEM(DK, DV, BK, ST, NC) \
  if (d <= DV) return Cfg<DK, DV, BK, ST, NC>::kSmem;
  FF_WG_CONFIGS(FF_WG_SMEM)
#undef FF_WG_SMEM
  return -1;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Route 0: float32, split-TF32 products on mma.sync
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;  // 8 warps: 2 row groups of 16 queries x 4 column quarters
constexpr int kBQ = 32;        // query rows per CTA
constexpr int kBK = 32;        // keys per tile
constexpr int kLdS = 36;       // row stride of P (float4-aligned, conflict-free A fragments)
constexpr int kLdP = 40;       // row stride of the S partials (conflict-free float2 stores)

template <int DP>
struct Cfg {
  // Q, K row stride DP + 4 and V row stride DP + 8 floats: the fragment
  // loads of a warp (8 rows x 4 columns of Q or K, 4 rows x 8 columns of V)
  // hit 32 distinct banks
  static constexpr int kLdQ = DP + 4, kLdV = DP + 8;
  // Q | K | V | S partials [4][kBQ][kLdP] | P [kBQ][kLdS] | corr, l [kBQ]
  static constexpr int kFloats = 2 * kBQ * kLdQ + kBK * kLdV + 4 * kBQ * kLdP + kBQ * kLdS + 2 * kBQ;
  static constexpr int kSmem = kFloats * 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 32) of one head into dst (row stride LD) with
// cp.async; rows past `rows_valid` and columns past d are zero-filled.
template <int DP, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* head, int row0, int rows_valid,
                                          int stride, int d, int tid) {
  constexpr int kChunks = DP / 4;
#pragma unroll 4
  for (int idx = tid; idx < 32 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 4;
    const bool valid = row0 + r < rows_valid && c < d;
    cp_async16(dst + r * LD + c, valid ? head + (size_t)(row0 + r) * stride + c : head, valid);
  }
}

// x = hi + lo for the TF32 products: the tensor cores read the top 19 bits
// of an f32 operand register, so x's own bits serve as the high part and
// lo = x - (x with its low 13 bits cleared), |lo| < 2^-10 |x|, whose own
// top 19 bits leave an error under 2^-20 |x|.  Two instructions per
// operand, where rounding both parts with cvt.rna.tf32 takes three.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in three TF32 products, small terms first (lo.hi + hi.lo +
// hi.hi; the lo.lo term, under 2^-20 relative, is dropped).
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ key_mask,
                      float* __restrict__ out, float* __restrict__ lse, int heads, int sq, int sk,
                      int d, float scale) {
  using C = Cfg<DP>;
  constexpr int kLdQ = C::kLdQ, kLdV = C::kLdV, kSlice = DP / 4, kNT = DP / 4 / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * kLdQ;
  float* vs = ks + kBK * kLdQ;
  float* sp = vs + kBK * kLdV;      // [4][kBQ][kLdP]
  float* ps = sp + 4 * kBQ * kLdP;  // [kBQ][kLdS]
  float* corr_s = ps + kBQ * kLdS;
  float* l_s = corr_s + kBQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warp (rgrp, cgrp): query rows 16 rgrp .. + 15; the partial S over head
  // columns [cgrp, cgrp + 1) * DP / 4 and the output columns of the same range
  const int rgrp = warp >> 2, cgrp = warp & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const float* kb = k + (size_t)b * sk * e + h * d;
  const float* vb = v + (size_t)b * sk * e + h * d;
  const float* mb = key_mask ? key_mask + (size_t)b * sk : nullptr;
  const int sr = tid / 8, sk4 = tid % 8;  // softmax: row sr, keys 4 sk4 .. + 3

  load_rows<DP, kLdQ>(qs, q + (size_t)b * sq * e + h * d, q0, sq, e, d, tid);
  load_rows<DP, kLdQ>(ks, kb, 0, sk, e, d, tid);
  cp_commit();
  load_rows<DP, kLdV>(vs, vb, 0, sk, e, d, tid);
  cp_commit();

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m = kMInit, l = 0.f;
  const float* qw = qs + (16 * rgrp + g) * kLdQ + cgrp * kSlice + t;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    cp_wait<1>();  // K of this tile (and Q) landed; V may still be in flight
    __syncthreads();
    {  // partial S over this warp's quarter of the head dim
      float sc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const float* kw = ks + g * kLdQ + cgrp * kSlice + t;
#pragma unroll 2
      for (int c = 0; c < kSlice; c += 8) {
        uint32_t ah[4], al[4];
        split(qw[c], ah[0], al[0]);
        split(qw[c + 8 * kLdQ], ah[1], al[1]);
        split(qw[c + 4], ah[2], al[2]);
        split(qw[c + 8 * kLdQ + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma3(sc[nt], ah, al, kw[nt * 8 * kLdQ + c], kw[nt * 8 * kLdQ + c + 4]);
      }
      float* spw = sp + (cgrp * kBQ + 16 * rgrp + g) * kLdP + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        *reinterpret_cast<float2*>(spw + nt * 8) = make_float2(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<float2*>(spw + 8 * kLdP + nt * 8) = make_float2(sc[nt][2], sc[nt][3]);
      }
    }
    __syncthreads();  // partials written; K consumed
    if (k0 + kBK < sk) load_rows<DP, kLdQ>(ks, kb, k0 + kBK, sk, e, d, tid);
    cp_commit();
    {  // online softmax, rounded as `masked_logit` rounds
      float4 a = *reinterpret_cast<const float4*>(sp + sr * kLdP + 4 * sk4);
#pragma unroll
      for (int sl = 1; sl < 4; ++sl) {
        const float4 bb = *reinterpret_cast<const float4*>(sp + (sl * kBQ + sr) * kLdP + 4 * sk4);
        a.x += bb.x; a.y += bb.y; a.z += bb.z; a.w += bb.w;
      }
      float x[4] = {a.x, a.y, a.z, a.w};
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int col = k0 + 4 * sk4 + u;
        x[u] = col < sk ? masked_logit(x[u], scale, mb, col) : -INFINITY;
        mx = fmaxf(mx, x[u]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m, mx);
      const float corr = __expf(m - mn);
      m = mn;
      float p[4], ls = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p[u] = __expf(x[u] - mn);
        ls += p[u];
      }
      l = l * corr + ls;
      *reinterpret_cast<float4*>(ps + sr * kLdS + 4 * sk4) = make_float4(p[0], p[1], p[2], p[3]);
      if (sk4 == 0) corr_s[sr] = corr;
    }
    cp_wait<1>();  // V of this tile landed; the next K may still be in flight
    __syncthreads();
    {  // O = O * corr + P V over this warp's output columns.  The tile's
       // P V is summed on the tensor cores from zero (12 products) and
       // added to O by one FFMA: mma.sync rounds its f32 sums toward zero,
       // so carrying O itself through every product would shrink it by
       // about 2^-24 a product, a bias that grows with the keys (2e-4 of
       // |O| at S 16384); an FFMA rounds to nearest.
      const float c0 = corr_s[16 * rgrp + g], c1 = corr_s[16 * rgrp + g + 8];
      const float* pw = ps + (16 * rgrp + g) * kLdS + t;
      const float* vw = vs + t * kLdV + cgrp * kSlice + g;
      uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        split(pw[8 * kk], ph[kk][0], pl[kk][0]);
        split(pw[8 * kk + 8 * kLdS], ph[kk][1], pl[kk][1]);
        split(pw[8 * kk + 4], ph[kk][2], pl[kk][2]);
        split(pw[8 * kk + 8 * kLdS + 4], ph[kk][3], pl[kk][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float tile[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk)
          mma3(tile, ph[kk], pl[kk], vw[8 * kk * kLdV + nt * 8], vw[(8 * kk + 4) * kLdV + nt * 8]);
        acc[nt][0] = fmaf(acc[nt][0], c0, tile[0]);
        acc[nt][1] = fmaf(acc[nt][1], c0, tile[1]);
        acc[nt][2] = fmaf(acc[nt][2], c1, tile[2]);
        acc[nt][3] = fmaf(acc[nt][3], c1, tile[3]);
      }
    }
    __syncthreads();  // V and P consumed
    if (k0 + kBK < sk) load_rows<DP, kLdV>(vs, vb, k0 + kBK, sk, e, d, tid);
    cp_commit();
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  l = fmaxf(l, 1e-30f);
  if (sk4 == 0) {
    l_s[sr] = l;
    if (lse && q0 + sr < sq) lse[(size_t)bh * sq + q0 + sr] = m + logf(l);
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * rgrp + g + 8 * hh;
    if (q0 + r >= sq) continue;
    const float inv = 1.0f / l_s[r];
    float* orow = out + ((size_t)b * sq + q0 + r) * e + h * d;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = cgrp * kSlice + nt * 8 + 2 * t;
      if (col < d)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[nt][2 * hh] * inv, acc[nt][2 * hh + 1] * inv);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* lse, int batch, int heads, int sq, int sk, int d, float scale,
                   cudaStream_t stream) {
  static_assert(Cfg<DP>::kSmem <= 232448, "shared memory of one CTA");
  auto kern = flash_fwd_tf32_kernel<DP>;
  static bool done = false;
  const cudaError_t err = set_smem(kern, Cfg<DP>::kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  kern<<<grid, kThreads, Cfg<DP>::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<float*>(out), lse, heads, sq, sk, d, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* mask, void* out,
                     float* lse, int batch, int heads, int sq, int sk, int d, float scale,
                     cudaStream_t stream) {
  if (d <= 128) return launch<128>(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, stream);
  return launch<512>(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, stream);
}

int smem_bytes(int d) { return d <= 128 ? Cfg<128>::kSmem : Cfg<512>::kSmem; }

}  // namespace f32
}  // namespace ff

namespace {

constexpr int kRouteF32 = 0;    // float32, split-TF32 products, d <= 512
constexpr int kRouteWgmma = 1; // bf16, wgmma + TMA ring, d <= 160

int fwd(const void* q, const void* k, const void* v, const void* mask, void* out, float* lse,
        int batch, int heads, int sq, int sk, int d, float scale, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || sq < 1 || sk < 1) return (int)cudaErrorInvalidValue;
  if (route == kRouteWgmma && d <= 160)
    return (int)ff::wg::dispatch(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, s);
  if (route == kRouteF32 && d <= 512)
    return (int)ff::f32::dispatch(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// route: 0 = float32 operands (split-TF32 products, d <= 512), 1 = bf16
// operands (wgmma, d <= 160); d a multiple of 8.  mask may be null.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_sdpa_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* out, int batch, int heads, int sq, int sk, int d,
                              float scale, int route, void* stream) {
  return fwd(q, k, v, mask, out, nullptr, batch, heads, sq, sk, d, scale, route, stream);
}

// The same attention, also writing lse [batch, heads, sq] float32.
extern "C" int flash_sdpa_fwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, void* lse, int batch, int heads, int sq, int sk,
                                  int d, float scale, int route, void* stream) {
  return fwd(q, k, v, mask, out, static_cast<float*>(lse), batch, heads, sq, sk, d, scale, route,
             stream);
}

// Dynamic shared memory (bytes) of the instantiation that `route` takes at
// head dim d, or -1 if it takes none.
extern "C" int flash_sdpa_smem_bytes(int route, int d) {
  if (d <= 0 || d % 8 != 0) return -1;
  if (route == kRouteWgmma && d <= 160) return ff::wg::smem_bytes(d);
  if (route == kRouteF32 && d <= 512) return ff::f32::smem_bytes(d);
  return -1;
}
