// tca_flash: fused temporal-contextual attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tca_kernel` behind `tca_flash`
// (freefine_tpu/ops/flash_attention.py:175 and :235).  Same function: one
// sweep over the keys with three online softmaxes,
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
// `_tca_fwd_lse` :800); the backward is csrc/tca_flash_bwd.cu.  A masked
// logit is rounded as `masked_logit` / `masked_logit_bg` round it, so the
// backward recomputes the same P from these logsumexps.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s, about 4e12 exp/s):
// 10*S^2*D*B*H FLOPs (two QK^T, three P.V) and 3*S^2*B*H exponentials.
// On the SD-1.5 main path (after the head-parity split: B*H = 6*4 = 24,
// d=40 at S=4096, d=80 at S=1024) the exponentials bound it: 1.2 G exps
// at S=4096 is 300 us against 161 GFLOP = 163 us on the tensor cores.
// The bytes (six [B, S, H*D] tensors, and with the residuals three float32
// partials) are microseconds.
//
// Masking: the odd-head block of the parity split has fg = 1 for every key,
// so its bg pass masks every key.  The finite bias keeps that row uniform
// and finite (its weight 1 - tq is 0, and a NaN would survive the 0 weight);
// -inf masking would be wrong here.
//
// Design (first versions; wgmma/TMA are later work): one block per (query
// tile, b*h), a loop over 32-key tiles, float32 statistics and three float32
// accumulators per query row; head dims zero-padded in shared memory.
//   * bf16 (the UNet's TCA layers, d <= 80): 4 warps of 16 query rows, the two
//     QK^T and three P.V products on the tensor cores (mma.sync m16n8k16),
//     the three accumulators in registers (252 registers at d = 80).
//   * float32 (tests and the tiny config): FMA pipes, one key per lane.
// Against the bound: the five products go to the tensor cores and fg/bg share
// one q.k_mod product, so each logit costs one __expf per softmax (three in
// all) on the SFU, the bound's own term; tile loads are not yet overlapped
// with compute.  Measured times: PERF.md.
#include "attention_common.cuh"

namespace ff {

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

// Tensor-core version for bf16 operands (head dim <= 80): 4 warps of 16
// query rows; per 32-key tile two S = Q K^T products (self, mod) and three
// P.V products on mma.sync m16n8k16, three online softmaxes in registers.
// kLse: also write the partial outputs and logsumexps (a template flag, so
// the plain forward keeps its registers).
template <int DK, int DV, int BK, bool kLse>
__global__ void __launch_bounds__(128)
tca_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_self,
                   const bf16* __restrict__ v_self, const bf16* __restrict__ k_mod,
                   const bf16* __restrict__ v_mod, const float* __restrict__ fg,
                   const float* __restrict__ tq, float cg, bf16* __restrict__ out,
                   float* __restrict__ parts, float* __restrict__ lse, int heads, int seq, int d,
                   float scale) {
  constexpr int kBQ = 64;
  constexpr int kLdK = DK + 8, kLdV = BK + 8;
  constexpr int kKT = DK / 16, kNT = BK / 8, kOT = DV / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* kss = qs + kBQ * kLdK;
  bf16* kms = kss + BK * kLdK;
  bf16* vts = kms + BK * kLdK;
  bf16* vtm = vts + DV * kLdV;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const size_t off = (size_t)b * seq * e + h * d;
  const float* fgb = fg + (size_t)b * seq;

  load_tile_bf16<DK>(qs, q + off, q0, kBQ, seq, e, d, tid, 128);
  __syncthreads();
  uint32_t qa[kKT][4];
  load_q_frags<kKT, kLdK>(qa, qs + warp * 16 * kLdK, g, t);

  // accumulators and statistics of the self, fg and bg passes
  float os[kOT][4], of[kOT][4], ob[kOT][4];
  float m[3][2], l[3][2];
#pragma unroll
  for (int ot = 0; ot < kOT; ++ot) {
#pragma unroll
    for (int c = 0; c < 4; ++c) os[ot][c] = of[ot][c] = ob[ot][c] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    m[a][0] = m[a][1] = kMInit;
    l[a][0] = l[a][1] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += BK) {
    __syncthreads();
    load_tile_bf16<DK>(kss, k_self + off, k0, BK, seq, e, d, tid, 128);
    load_tile_bf16<DK>(kms, k_mod + off, k0, BK, seq, e, d, tid, 128);
    load_tile_bf16_t<DV, BK>(vts, v_self + off, k0, seq, e, d, tid, 128);
    load_tile_bf16_t<DV, BK>(vtm, v_mod + off, k0, seq, e, d, tid, 128);
    __syncthreads();

    float ss[kNT][4], sb[kNT][4], sf[kNT][4];
    qk_tile<kKT, kNT, kLdK>(ss, qa, kss, g, t);
    qk_tile<kKT, kNT, kLdK>(sb, qa, kms, g, t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + nt * 8 + 2 * t + (c & 1);
        if (col < seq) {
          ss[nt][c] = masked_logit(ss[nt][c], scale, nullptr, col);
          sf[nt][c] = masked_logit(sb[nt][c], scale, fgb, col);
          sb[nt][c] = masked_logit_bg(sb[nt][c], scale, fgb, col);
        } else {
          ss[nt][c] = sf[nt][c] = sb[nt][c] = -INFINITY;
        }
      }
    }
    softmax_update<kNT, kOT>(ss, os, m[0], l[0]);
    softmax_update<kNT, kOT>(sf, of, m[1], l[1]);
    softmax_update<kNT, kOT>(sb, ob, m[2], l[2]);
    pv_tile<kNT, kOT, kLdV>(os, ss, vts, g, t);
    pv_tile<kNT, kOT, kLdV>(of, sf, vtm, g, t);
    pv_tile<kNT, kOT, kLdV>(ob, sb, vtm, g, t);
  }

#pragma unroll
  for (int a = 0; a < 3; ++a) finish_rows(l[a]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row < seq) {
      const float w = tq[(size_t)b * seq + row];
      const size_t orow = ((size_t)b * seq + row) * e + h * d;
      const size_t plane = (size_t)gridDim.y * seq * d;  // one [B, S, H*D] partial
      if (kLse && t == 0) {
        const size_t lrow = (size_t)bh * seq + row, lplane = (size_t)gridDim.y * seq;
#pragma unroll
        for (int a = 0; a < 3; ++a) lse[a * lplane + lrow] = m[a][hh] + logf(l[a][hh]);
      }
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        const int col = ot * 8 + 2 * t;
        if (col < d) {
          float r[2], p[3][2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = 2 * hh + c;
            p[0][c] = os[ot][i] / l[0][hh];
            p[1][c] = of[ot][i] / l[1][hh];
            p[2][c] = ob[ot][i] / l[2][hh];
            r[c] = cg * (w * p[1][c] + (1.0f - w) * p[2][c]) + (1.0f - cg) * p[0][c];
          }
          *reinterpret_cast<uint32_t*>(out + orow + col) = pack_bf16(r[0], r[1]);
          if (kLse) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              *reinterpret_cast<float2*>(parts + a * plane + orow + col) =
                  make_float2(p[a][0], p[a][1]);
            }
          }
        }
      }
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

template <int DK, int DV, int BK, bool kLse>
cudaError_t launch_mma(const FwdArgs& a) {
  constexpr int kBQ = 64;
  const size_t smem = sizeof(bf16) * (size_t)((kBQ + 2 * BK) * (DK + 8) + 2 * DV * (BK + 8));
  auto kern = tca_fwd_mma_kernel<DK, DV, BK, kLse>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.batch * a.heads);
  kern<<<grid, 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.ks),
      static_cast<const bf16*>(a.vs), static_cast<const bf16*>(a.km),
      static_cast<const bf16*>(a.vm), static_cast<const float*>(a.fg),
      static_cast<const float*>(a.tq), a.cg, static_cast<bf16*>(a.out), a.parts, a.lse, a.heads,
      a.seq, a.d, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const FwdArgs& a) {
#define FF_TCA_MMA_CASE(DK, DV)                                                      \
  if (a.d <= DV)                                                                     \
    return a.lse ? launch_mma<DK, DV, 32, true>(a) : launch_mma<DK, DV, 32, false>(a);
  FF_TCA_MMA_CASE(16, 16)
  FF_TCA_MMA_CASE(32, 32)
  FF_TCA_MMA_CASE(48, 40)
  FF_TCA_MMA_CASE(64, 64)
  FF_TCA_MMA_CASE(80, 80)
#undef FF_TCA_MMA_CASE
  return cudaErrorInvalidValue;
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
  return (int)(dtype == 1 ? ff::dispatch_mma(a) : ff::dispatch_fma(a));
}

}  // namespace

// dtype: 0 = float32 (FMA kernel, d <= 160), 1 = bfloat16 (tensor cores,
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
