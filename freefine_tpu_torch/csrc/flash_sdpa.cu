// flash_sdpa: streaming softmax attention with an optional per-key 0/1
// mask, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind `flash_sdpa`
// (freefine_tpu/ops/flash_attention.py:80 and :115).  Same function:
// q [B, Sq, H*D], k/v [B, Sk, H*D] in bf16 or float32, key_mask [B, Sk]
// float32 0/1 (or none) applied as a finite -1e9 bias on the scaled f32
// logit; output [B, Sq, H*D] in q's dtype.
//
// With an lse pointer the same kernels also write the per-row logsumexp
// m + log(max(l, 1e-30)) as float32 [B, H, Sq]: the forward of the
// differentiable attention, replacing `_flash_fwd_lse_kernel` (:307, via
// `_flash_fwd_lse` :442).  Exported as its own entry point
// (`flash_sdpa_fwd_lse`) and counted as its own kernel by the wrapper.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s f32 outside the
// tensor cores, 3.35 TB/s, about 4e12 exp/s from 16 SFU ops/clk/SM): the
// work is 4*Sq*Sk*D*B*H FLOPs and Sq*Sk*B*H exponentials against
// (|q|+|k|+|v|+|out|) bytes.  At the UNet's d=40, S=4096, B*H=24 that is
// 64 GFLOP (65 us on the tensor cores) and 0.4 G exps (100 us), so the
// softmax, not the matrix units, sets the bound; the VAE's f32 d=512 call
// (B*H=2, S=4096) is 69 GFLOP of f32 FMA (1 ms).  Everything is far above
// the memory line: attention at these shapes is compute bound.
//
// Design (first versions; wgmma/TMA and pipelined tiles are later work):
// one block per (64- or 32-query tile, b*h), a loop over key tiles, float32
// running max, sum and accumulators.  Head dims are zero-padded in shared
// memory, never copied in device memory; keys past Sk are excluded.
//   * bf16 (the UNet, d <= 160): 4 warps of 16 query rows; S = Q K^T and
//     O += P V on the tensor cores (mma.sync m16n8k16, f32 accumulate), the
//     Q fragments held in registers, V staged transposed so P.V reads key
//     pairs; online softmax on the accumulator fragments.
//   * float32 (the VAE, d = 512): FMA pipes, one key per lane, ROWS query
//     rows per warp; 32-key tiles keep the f32 K and V tiles inside shared
//     memory at d = 512 (no cast to bf16: the JAX package feeds f32 here).
// Against the bound: the tensor cores take both products, which leaves the
// exponentials (one __expf per logit, on the SFU) and the row max/sum
// shuffles as the kernel's own work; tile loads are not yet overlapped with
// compute.  Measured times against the bound: PERF.md.
#include "attention_common.cuh"

namespace ff {

// float32 version (FMA pipes).
template <int DP, int WARPS, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ key_mask, float* __restrict__ out,
                 float* __restrict__ lse, int heads, int sq, int sk, int d,
                 float scale) {
  constexpr int kLd = DP + 4;
  constexpr int kBQ = WARPS * ROWS;
  constexpr int kNC = (DP + 31) / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * kLd;
  float* vs = ks + kBK * kLd;
  float* ps = vs + kBK * kLd;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = WARPS * 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + (size_t)b * sq * e + h * d;
  const float* kb = k + (size_t)b * sk * e + h * d;
  const float* vb = v + (size_t)b * sk * e + h * d;
  const float* mb = key_mask ? key_mask + (size_t)b * sk : nullptr;

  load_tile<DP>(qs, qb, q0, kBQ, sq, e, d, tid, nthreads);

  float m[ROWS], l[ROWS], acc[ROWS][kNC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kMInit;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kNC; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + warp * ROWS * kLd;
  float* pw = ps + warp * ROWS * kBK;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q is in place)
    load_tile<DP>(ks, kb, k0, kBK, sk, e, d, tid, nthreads);
    load_tile<DP>(vs, vb, k0, kBK, sk, e, d, tid, nthreads);
    __syncthreads();

    // logits of this lane's key against the warp's ROWS queries
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* kr = ks + lane * kLd;
#pragma unroll 8
    for (int c = 0; c < DP; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * kLd + c);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
    const int j = k0 + lane;
    const bool valid = j < sk;

    // online softmax; l is a per-lane partial sum (the max is warp-uniform)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float sv = valid ? masked_logit(s[r], scale, mb, j) : -INFINITY;
      const float mn = fmaxf(m[r], warp_max(sv));
      const float corr = __expf(m[r] - mn);
      const float p = __expf(sv - mn);
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int i = 0; i < kNC; ++i) acc[r][i] *= corr;
      m[r] = mn;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] * v[j][c]; lane owns columns lane + 32 i
#pragma unroll 2
    for (int jj = 0; jj < kBK; jj += 4) {
      float vv[4][kNC];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int i = 0; i < kNC; ++i) {
          const int c = lane + 32 * i;
          vv[t][i] = (c < DP) ? vs[(jj + t) * kLd + c] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + r * kBK + jj);
#pragma unroll
        for (int i = 0; i < kNC; ++i) {
          float a = acc[r][i];
          a = fmaf(pp.x, vv[0][i], a);
          a = fmaf(pp.y, vv[1][i], a);
          a = fmaf(pp.z, vv[2][i], a);
          a = fmaf(pp.w, vv[3][i], a);
          acc[r][i] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float lt = fmaxf(warp_sum(l[r]), 1e-30f);
    const int qi = q0 + warp * ROWS + r;
    if (lse && lane == 0 && qi < sq) lse[(size_t)bh * sq + qi] = m[r] + logf(lt);
    if (qi < sq) {
      float* o = out + ((size_t)b * sq + qi) * e + h * d;
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        const int c = lane + 32 * i;
        if (c < d) o[c] = (acc[r][i] / lt);
      }
    }
  }
}

// Tensor-core version for bf16 operands (head dim <= 160): 4 warps, 16 query
// rows each; per key tile of BK keys, S = Q K^T and O += P V on mma.sync
// m16n8k16 with f32 accumulation.  DK is the head dim padded to the mma
// depth 16 (zeros in shared memory), DV the output width (multiple of 8).
template <int DK, int DV, int BK>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ key_mask,
                     bf16* __restrict__ out, float* __restrict__ lse, int heads, int sq, int sk,
                     int d, float scale) {
  constexpr int kBQ = 64;
  constexpr int kLdK = DK + 8, kLdV = BK + 8;
  constexpr int kKT = DK / 16, kNT = BK / 8, kOT = DV / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + kBQ * kLdK;
  bf16* vt = ks + BK * kLdK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int e = heads * d;
  const int q0 = blockIdx.x * kBQ;
  const bf16* kb = k + (size_t)b * sk * e + h * d;
  const bf16* vb = v + (size_t)b * sk * e + h * d;
  const float* mb = key_mask ? key_mask + (size_t)b * sk : nullptr;

  load_tile_bf16<DK>(qs, q + (size_t)b * sq * e + h * d, q0, kBQ, sq, e, d, tid, 128);
  __syncthreads();
  uint32_t qa[kKT][4];
  load_q_frags<kKT, kLdK>(qa, qs + warp * 16 * kLdK, g, t);

  float o[kOT][4], m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int ot = 0; ot < kOT; ++ot) o[ot][0] = o[ot][1] = o[ot][2] = o[ot][3] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();
    load_tile_bf16<DK>(ks, kb, k0, BK, sk, e, d, tid, 128);
    load_tile_bf16_t<DV, BK>(vt, vb, k0, sk, e, d, tid, 128);
    __syncthreads();

    float s[kNT][4];
    qk_tile<kKT, kNT, kLdK>(s, qa, ks, g, t);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + nt * 8 + 2 * t + (c & 1);
        s[nt][c] = col < sk ? masked_logit(s[nt][c], scale, mb, col) : -INFINITY;
      }
    }
    softmax_update<kNT, kOT>(s, o, m, l);
    pv_tile<kNT, kOT, kLdV>(o, s, vt, g, t);
  }

  finish_rows(l);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (lse && t == 0 && row < sq) lse[(size_t)bh * sq + row] = m[hh] + logf(l[hh]);
    if (row < sq) {
      bf16* orow = out + ((size_t)b * sq + row) * e + h * d;
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        const int col = ot * 8 + 2 * t;
        if (col < d) {
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[ot][2 * hh] / l[hh], o[ot][2 * hh + 1] / l[hh]);
        }
      }
    }
  }
}

template <int DK, int DV, int BK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* mask, void* out,
                       float* lse, int batch, int heads, int sq, int sk, int d, float scale,
                       cudaStream_t stream) {
  constexpr int kBQ = 64;
  const size_t smem = sizeof(bf16) * (size_t)((kBQ + BK) * (DK + 8) + DV * (BK + 8));
  auto kern = flash_fwd_mma_kernel<DK, DV, BK>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  kern<<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(out), lse, heads, sq, sk, d, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, const void* mask,
                         void* out, float* lse, int batch, int heads, int sq, int sk, int d,
                         float scale, cudaStream_t stream) {
#define FF_MMA_CASE(DK, DV)                                                                 \
  if (d <= DV)                                                                              \
    return launch_mma<DK, DV, 64>(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale,     \
                                  stream);
  FF_MMA_CASE(16, 16)
  FF_MMA_CASE(32, 32)
  FF_MMA_CASE(48, 40)
  FF_MMA_CASE(64, 64)
  FF_MMA_CASE(80, 80)
  FF_MMA_CASE(128, 128)
  FF_MMA_CASE(160, 160)
#undef FF_MMA_CASE
  return cudaErrorInvalidValue;
}

template <int DP, int WARPS, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   float* lse, int batch, int heads, int sq, int sk, int d, float scale,
                   cudaStream_t stream) {
  constexpr int kLd = DP + 4;
  constexpr int kBQ = WARPS * ROWS;
  const size_t smem = sizeof(float) * (size_t)(kBQ * kLd + 2 * kBK * kLd + kBQ * kBK);
  auto kern = flash_fwd_kernel<DP, WARPS, ROWS>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<float*>(out), lse, heads, sq, sk, d, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fma(const void* q, const void* k, const void* v, const void* mask,
                         void* out, float* lse, int batch, int heads, int sq, int sk, int d,
                         float scale, cudaStream_t stream) {
#define FF_FLASH_CASE(DP, W, R) \
  if (d <= DP)                     \
    return launch<DP, W, R>(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, stream);
  FF_FLASH_CASE(16, 8, 8)
  FF_FLASH_CASE(32, 8, 8)
  FF_FLASH_CASE(64, 8, 8)
  FF_FLASH_CASE(128, 8, 8)
  FF_FLASH_CASE(512, 4, 4)
#undef FF_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace ff

namespace {

int fwd(const void* q, const void* k, const void* v, const void* mask, void* out, float* lse,
        int batch, int heads, int sq, int sk, int d, float scale, int dtype, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > (dtype == 1 ? 160 : 512)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? ff::dispatch_mma(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, s)
                   : ff::dispatch_fma(q, k, v, mask, out, lse, batch, heads, sq, sk, d, scale, s));
}

}  // namespace

// dtype: 0 = float32 (FMA kernel, d <= 512), 1 = bfloat16 (tensor cores,
// d <= 160); d a multiple of 8.  mask may be null.  Returns the CUDA error of
// the launch (0 = launched).
extern "C" int flash_sdpa_fwd(const void* q, const void* k, const void* v, const void* mask,
                              void* out, int batch, int heads, int sq, int sk, int d,
                              float scale, int dtype, void* stream) {
  return fwd(q, k, v, mask, out, nullptr, batch, heads, sq, sk, d, scale, dtype, stream);
}

// The same attention, also writing lse [batch, heads, sq] float32.
extern "C" int flash_sdpa_fwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, void* lse, int batch, int heads, int sq, int sk,
                                  int d, float scale, int dtype, void* stream) {
  return fwd(q, k, v, mask, out, static_cast<float*>(lse), batch, heads, sq, sk, d, scale, dtype,
             stream);
}
