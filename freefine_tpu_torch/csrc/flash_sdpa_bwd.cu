// flash_sdpa backward: dQ and dK/dV of masked streaming attention, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the flash VJP in
// freefine_tpu/ops/flash_attention.py: `_flash_bwd_dq_kernel` (:344) and
// `_flash_bwd_dkv_kernel` (:378), both launched by `_flash_sdpa_bwd` (:487).
// Same function, per (batch, head):
//   P  = exp(q k^T * scale + bias - lse)   recomputed from the forward's lse
//   dS = P * (dO v^T - delta)              delta = rowsum(out * dO), given
//   dQ = dS k * scale,  dK = dS^T q * scale,  dV = P^T dO
// q/dO/dQ [B, Sq, H*D], k/v/dK/dV [B, Sk, H*D] in bf16 or float32; key_mask
// [B, Sk] float32 0/1 or null, applied as the forward applies it (finite
// -1e9 bias on the scaled logit, `masked_logit`); lse and delta float32
// [B, H, Sq].  Keys past Sk do not exist (no dK/dV row is written for them);
// query rows past Sq add nothing.  Two kernels, as on the TPU, each
// recomputing P: no atomics, deterministic.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s f32 FMA, 3.35 TB/s,
// about 4.2e12 exp/s): dQ is 6*Sq*Sk*D FLOPs and Sq*Sk exps per (b, h), dK/dV
// 8*Sq*Sk*D FLOPs and Sq*Sk exps; the bytes are the operands once.  At the
// energy-guidance shape S=4096, d=40, B*H=8 that is 32 GFLOP (33 us) and
// 0.13 G exps (32 us) for dQ against 2.6 MB (0.8 us): operations bound, the
// exponentials as much as the products.
//
// Design (a first, simple version; wgmma/TMA, pipelined tiles and a fused
// dQ with atomics are later work):
//   * bf16: 4 warps of 16 rows on mma.sync m16n8k16 (bf16 in, f32
//     accumulate).  S and dP are products of bf16 operands (exact products,
//     f32 sums, as the f32 products of the TPU kernel on the same values).
//     P and dS are rounded to bf16 to feed the tensor cores for dS.K, P^T.dO
//     and dS^T.Q, as FlashAttention-2 does; the TPU kernel keeps them f32.
//     The twins keep them f32, and chip_smoke.py holds the difference to its
//     per-shape limits.
//     - dQ: a block owns 64 query rows and sweeps key tiles of BK; K is
//       staged twice, row major for S = Q K^T and transposed for dS.K.
//     - dK/dV: a block owns 64 keys (16 per warp) and sweeps query tiles of
//       BQ; Q and dO are staged row major (for S^T = K Q^T, dP^T = V dO^T)
//       and transposed (for dK += dS^T Q, dV += P^T dO).  Two f32
//       accumulators of 16 x d per warp: at d = 160 the query tile is 32 so
//       that the S^T and dP^T tiles fit beside them in registers.
//   * float32 (the tiny configuration's head dims, d <= 128): FMA pipes, one
//     key (dQ) or one query (dK/dV) per lane, ROWS rows per warp, the
//     structure of the f32 forward kernel in flash_sdpa.cu.
#include "attention_common.cuh"

namespace ff {

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

template <int DK, int DV, int BK>
__global__ void __launch_bounds__(128)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ key_mask, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int heads, int sq, int sk, int d, float scale) {
  constexpr int kBQ = 64;
  constexpr int kLd = DK + 8, kLdT = BK + 8;
  constexpr int kKT = DK / 16, kNT = BK / 8, kOT = DV / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dos = qs + kBQ * kLd;
  bf16* ks = dos + kBQ * kLd;
  bf16* vs = ks + BK * kLd;
  bf16* kt = vs + BK * kLd;  // K transposed: [DV][BK + 8]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const bf16* kb = k + (size_t)b * sk * e + h * d;
  const bf16* vb = v + (size_t)b * sk * e + h * d;
  const float* mb = key_mask ? key_mask + (size_t)b * sk : nullptr;

  load_tile_bf16<DK>(qs, q + (size_t)b * sq * e + h * d, q0, kBQ, sq, e, d, tid, 128);
  load_tile_bf16<DK>(dos, dout + (size_t)b * sq * e + h * d, q0, kBQ, sq, e, d, tid, 128);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    lse_r[hh] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    delta_r[hh] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }
  const bf16* qw = qs + warp * 16 * kLd;
  const bf16* dow = dos + warp * 16 * kLd;

  float acc[kOT][4];
#pragma unroll
  for (int ot = 0; ot < kOT; ++ot) acc[ot][0] = acc[ot][1] = acc[ot][2] = acc[ot][3] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed (and Q, dO are in place)
    load_tile_bf16<DK>(ks, kb, k0, BK, sk, e, d, tid, 128);
    load_tile_bf16<DK>(vs, vb, k0, BK, sk, e, d, tid, 128);
    load_tile_bf16_t<DV, BK>(kt, kb, k0, sk, e, d, tid, 128);
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
    mma_abt<kKT, kNT, kLd>(s, qw, ks, g, t);
    mma_abt<kKT, kNT, kLd>(dp, dow, vs, g, t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + nt * 8 + 2 * t + (c & 1);
        const int hh = c >> 1;
        float ds = 0.f;
        if (col < sk) {
          const float p = __expf(masked_logit(s[nt][c], scale, mb, col) - lse_r[hh]);
          ds = p * (dp[nt][c] - delta_r[hh]);
        }
        s[nt][c] = ds;
      }
    }
    pv_tile<kNT, kOT, kLdT>(acc, s, kt, g, t);  // dQ += dS (bf16) . K
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row < sq) {
      bf16* orow = dq + ((size_t)b * sq + row) * e + h * d;
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

template <int DK, int DV, int BQ>
__global__ void __launch_bounds__(128)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const float* __restrict__ key_mask, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk, int d,
               float scale) {
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
  float* lse_s = reinterpret_cast<float*>(dot + DV * kLdT);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int k0 = blockIdx.x * kKeys;
  const bf16* qb = q + (size_t)b * sq * e + h * d;
  const bf16* dob = dout + (size_t)b * sq * e + h * d;
  const float* mb = key_mask ? key_mask + (size_t)b * sk : nullptr;

  load_tile_bf16<DK>(ks, k + (size_t)b * sk * e + h * d, k0, kKeys, sk, e, d, tid, 128);
  load_tile_bf16<DK>(vs, v + (size_t)b * sk * e + h * d, k0, kKeys, sk, e, d, tid, 128);
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

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous tiles are consumed (and K, V are in place)
    load_tile_bf16<DK>(qs, qb, q0, BQ, sq, e, d, tid, 128);
    load_tile_bf16<DK>(dos, dob, q0, BQ, sq, e, d, tid, 128);
    load_tile_bf16_t<DV, BQ>(qt, qb, q0, sq, e, d, tid, 128);
    load_tile_bf16_t<DV, BQ>(dot, dob, q0, sq, e, d, tid, 128);
    for (int i = tid; i < BQ; i += 128) {
      const int row = q0 + i;
      lse_s[i] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
      delta_s[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
    }
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
        float p = 0.f, ds = 0.f;
        if (q0 + li < sq && kj < sk) {
          p = __expf(masked_logit(s[nt][c], scale, mb, kj) - lse_s[li]);
          ds = p * (dp[nt][c] - delta_s[li]);
        }
        s[nt][c] = p;
        dp[nt][c] = ds;
      }
    }
    pv_tile<kNT, kOT, kLdT>(adv, s, dot, g, t);  // dV += P^T (bf16) . dO
    pv_tile<kNT, kOT, kLdT>(adk, dp, qt, g, t);  // dK += dS^T (bf16) . Q
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (key[hh] < sk) {
      const size_t off = ((size_t)b * sk + key[hh]) * e + h * d;
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        const int col = ot * 8 + 2 * t;
        if (col < d) {
          *reinterpret_cast<uint32_t*>(dk + off + col) =
              pack_bf16(adk[ot][2 * hh] * scale, adk[ot][2 * hh + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + col) =
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

template <int DK, int DV, int BK>
cudaError_t launch_dq_mma(const BwdArgs& a) {
  const size_t smem = sizeof(bf16) * (size_t)((2 * 64 + 2 * BK) * (DK + 8) + DV * (BK + 8));
  auto kern = dq_mma_kernel<DK, DV, BK>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.sq + 63) / 64, a.batch * a.heads);
  kern<<<grid, 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.mask), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.heads, a.sq, a.sk, a.d, a.scale);
  return cudaGetLastError();
}

template <int DK, int DV, int BQ>
cudaError_t launch_dkv_mma(const BwdArgs& a) {
  const size_t smem = sizeof(bf16) * (size_t)((2 * 64 + 2 * BQ) * (DK + 8) + 2 * DV * (BQ + 8)) +
                      sizeof(float) * 2 * BQ;
  auto kern = dkv_mma_kernel<DK, DV, BQ>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.sk + 63) / 64, a.batch * a.heads);
  kern<<<grid, 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.mask), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.heads, a.sq, a.sk, a.d, a.scale);
  return cudaGetLastError();
}

constexpr int kFmaWarps = 4, kFmaRows = 8;

template <int DP>
cudaError_t launch_dq_fma(const BwdArgs& a) {
  constexpr int kBQ = kFmaWarps * kFmaRows;
  const size_t smem = sizeof(float) * (size_t)((2 * kBQ + 2 * kBK) * (DP + 4) + kBQ * kBK);
  auto kern = dq_fma_kernel<DP, kFmaWarps, kFmaRows>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.batch * a.heads);
  kern<<<grid, kFmaWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dq), a.heads,
      a.sq, a.sk, a.d, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_fma(const BwdArgs& a) {
  constexpr int kKeys = kFmaWarps * kFmaRows;
  const size_t smem =
      sizeof(float) * (size_t)((2 * kKeys + 2 * kBK) * (DP + 4) + 2 * kKeys * kBK + 2 * kBK);
  auto kern = dkv_fma_kernel<DP, kFmaWarps, kFmaRows>;
  static bool attr_set = false;
  if (const cudaError_t err = set_smem(kern, smem, attr_set)) return err;
  const dim3 grid((a.sk + kKeys - 1) / kKeys, a.batch * a.heads);
  kern<<<grid, kFmaWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.dout), a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.heads, a.sq, a.sk, a.d, a.scale);
  return cudaGetLastError();
}

// bf16: (DK, DV) = head dim padded to the mma depth 16, output width; key
// (dQ) and query (dK/dV) tiles of 64, 32 at d > 80.  f32: DP = d padded.
cudaError_t dispatch(const BwdArgs& a, int dtype, bool want_dq) {
#define FF_MMA_CASE(DK, DV, T)                                               \
  if (a.d <= DV) return want_dq ? launch_dq_mma<DK, DV, T>(a) : launch_dkv_mma<DK, DV, T>(a);
#define FF_FMA_CASE(DP) \
  if (a.d <= DP) return want_dq ? launch_dq_fma<DP>(a) : launch_dkv_fma<DP>(a);
  if (dtype == 1) {
    FF_MMA_CASE(16, 16, 64)
    FF_MMA_CASE(32, 32, 64)
    FF_MMA_CASE(48, 40, 64)
    FF_MMA_CASE(64, 64, 64)
    FF_MMA_CASE(80, 80, 64)
    FF_MMA_CASE(128, 128, 32)
    FF_MMA_CASE(160, 160, 32)
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
  return d <= 0 || d % 8 != 0 || d > (dtype == 1 ? 160 : 128);
}

}  // namespace

// dtype: 0 = float32 (FMA kernels, d <= 128), 1 = bfloat16 (tensor cores,
// d <= 160); d a multiple of 8.  mask may be null.  lse and delta are float32
// [batch, heads, sq].  Each returns the CUDA error of its launch (0 = launched).
extern "C" int flash_sdpa_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                 const void* dout, const void* lse, const void* delta, void* dq,
                                 int batch, int heads, int sq, int sk, int d, float scale,
                                 int dtype, void* stream) {
  if (bad_dims(d, dtype)) return (int)cudaErrorInvalidValue;
  const ff::BwdArgs a{q, k, v, mask, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), dq, nullptr, nullptr, batch, heads, sq,
                      sk, d, scale, static_cast<cudaStream_t>(stream)};
  return (int)ff::dispatch(a, dtype, true);
}

extern "C" int flash_sdpa_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                                  const void* dout, const void* lse, const void* delta, void* dk,
                                  void* dv, int batch, int heads, int sq, int sk, int d,
                                  float scale, int dtype, void* stream) {
  if (bad_dims(d, dtype)) return (int)cudaErrorInvalidValue;
  const ff::BwdArgs a{q, k, v, mask, dout, static_cast<const float*>(lse),
                      static_cast<const float*>(delta), nullptr, dk, dv, batch, heads, sq, sk,
                      d, scale, static_cast<cudaStream_t>(stream)};
  return (int)ff::dispatch(a, dtype, false);
}
