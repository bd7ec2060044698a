// Shared pieces of the hand-written attention kernels (flash_sdpa.cu,
// tca_flash.cu and their backward kernels): tile loads from the [B, S, H*D]
// layout into shared memory, warp reductions, the mask rounding, the FMA
// product helpers and the dtype helpers.
//
// Conventions shared with the plain PyTorch twins in
// freefine_tpu_torch/ops/flash_attention.py:
//   * logits, softmax statistics and accumulators are float32;
//   * a masked key gets a finite -1e9 bias added to the scaled logit, the
//     running max starts at -1e30 and the output divides by max(l, 1e-30),
//     so a fully masked row comes out as uniform attention, never NaN;
//   * keys past the sequence end are excluded (probability exactly 0);
//   * with bf16 operands the probabilities are rounded to bf16 before the
//     P.V product, whose sum stays float32.
// The float32 pieces serve the FMA kernels; every bf16 route runs wgmma
// (hopper.cuh, attention_bwd.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ff {

constexpr float kMaskBias = 1e9f;   // magnitude of the finite mask bias
constexpr float kMInit = -1e30f;    // initial running max
constexpr int kBK = 32;             // keys per tile: one key per lane

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The scaled logit plus its key's mask bias (mask may be null), each step
// rounded on its own (no FMA contraction), in the order of the plain twins.
// The forward and the backward kernels must give a masked logit the same
// value: in a fully masked row every logit rounds to exactly -1e9, and the
// backward's exp(logit - lse) has to see that row as the forward did.
__device__ __forceinline__ float masked_logit(float s, float scale, const float* mask, int col) {
  const float x = __fmul_rn(s, scale);
  return mask ? __fadd_rn(x, (mask[col] - 1.0f) * kMaskBias) : x;
}

// The BG pass of TCA: the scaled logit with the keys of the FG mask (fg = 1)
// biased by -1e9, rounded step by step as `masked_logit` rounds the FG pass.
__device__ __forceinline__ float masked_logit_bg(float s, float scale, const float* fg, int col) {
  return __fadd_rn(__fmul_rn(s, scale), fg[col] * -kMaskBias);
}

// Eight consecutive floats (32-byte aligned: head dims are multiples of 8 and
// base pointers 16-byte aligned, checked by the wrappers).
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// float32 kernels: copy rows [row0, row0 + nrows) of one head into shared memory,
// row stride DP + 4 floats (DP = head dim padded to the template width).
// base points at element (s = 0, c = 0) of the head; rows are `stride`
// elements apart.  Rows past `rows_valid` and columns past `d` are zero,
// so the padding never reaches a dot product.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int row0, int nrows,
                                          int rows_valid, int stride, int d, int tid,
                                          int nthreads) {
  constexpr int kChunks = DP / 8;
  constexpr int kLd = DP + 4;
  for (int idx = tid; idx < nrows * kChunks; idx += nthreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    float v[8];
    const int s = row0 + r;
    if (s < rows_valid && c < d) {
      load8(base + (size_t)s * stride + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    float* o = dst + r * kLd + c;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// bf16 storage type of the kernels' operands.
using bf16 = __nv_bfloat16;

// Two floats -> packed bf16x2 (lo in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Backward kernels, float32: dot product of two rows of DP floats in shared
// memory, in the forward's order (fmaf over the columns from 0), so the
// logits match it bit for bit.
template <int DP>
__device__ __forceinline__ float row_dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// acc[r][i] += sum_j w[r][j] * x[j][lane + 32 i] over a 32-row tile x.
template <int DP, int ROWS>
__device__ __forceinline__ void accumulate_rows(float (&acc)[ROWS][(DP + 31) / 32], const float* w,
                                                const float* x, int lane) {
  constexpr int kLd = DP + 4;
  constexpr int kNC = (DP + 31) / 32;
#pragma unroll
  for (int jj = 0; jj < kBK; jj += 4) {
    float xx[4][kNC];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        const int c = lane + 32 * i;
        xx[u][i] = (c < DP) ? x[(jj + u) * kLd + c] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 ww = *reinterpret_cast<const float4*>(w + r * kBK + jj);
#pragma unroll
      for (int i = 0; i < kNC; ++i) {
        float a = acc[r][i];
        a = fmaf(ww.x, xx[0][i], a);
        a = fmaf(ww.y, xx[1][i], a);
        a = fmaf(ww.z, xx[2][i], a);
        a = fmaf(ww.w, xx[3][i], a);
        acc[r][i] = a;
      }
    }
  }
}

template <int DP, int ROWS>
__device__ __forceinline__ void store_rows(float* base, const float (&acc)[ROWS][(DP + 31) / 32],
                                           int row0, int nrows, int stride, int d, float mul,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row0 + r < nrows) {
      float* o = base + (size_t)(row0 + r) * stride;
#pragma unroll
      for (int i = 0; i < (DP + 31) / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < d) o[c] = acc[r][i] * mul;
      }
    }
  }
}

// Opt a kernel in to `smem` bytes of dynamic shared memory, once.
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = err == cudaSuccess;
  return err;
}

// Full row sums of the two rows from the per-lane partials.
__device__ __forceinline__ void finish_rows(float (&l)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
  }
}

}  // namespace ff

extern "C" const char* ff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
