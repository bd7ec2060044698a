// Shared pieces of the hand-written attention kernels (flash_sdpa.cu,
// tca_flash.cu and their backward kernels): tile loads from the [B, S, H*D]
// layout into shared memory, warp reductions, the mask rounding, the
// tensor-core and FMA product helpers and the dtype helpers.
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
// The mma.sync pieces below serve the TCA backward kernels and the float32
// pieces the FMA kernels; the forward kernels' bf16 routes and the flash
// backward's run wgmma (hopper.cuh).
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

// ---------------------------------------------------------------------------
// Tensor-core pieces for the bf16 kernels: mma.sync m16n8k16 (bf16 in, f32
// accumulate).  Fragment layout, with g = lane / 4 and t = lane % 4:
//   A (16x16, row major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                         a3 = (g+8, 2t+8..)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g)
//   C (16x8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// Shared-memory tiles are bf16 with rows padded by 8 elements, which makes the
// 32-bit fragment loads of the 8 rows x 4 columns a warp touches hit 32
// distinct banks for every width that is a multiple of 16.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> packed bf16x2 (lo in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + nrows) of one head into a bf16 tile [nrows][COLS + 8],
// 16 bytes per copy; rows past rows_valid and columns past d are zero.
template <int COLS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* base, int row0, int nrows,
                                               int rows_valid, int stride, int d, int tid,
                                               int nthreads) {
  constexpr int kChunks = COLS / 8;
  constexpr int kLd = COLS + 8;
  for (int idx = tid; idx < nrows * kChunks; idx += nthreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 8;
    const int s = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < rows_valid && c < d) v = *reinterpret_cast<const uint4*>(base + (size_t)s * stride + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = v;
  }
}

// The same rows stored transposed: dst[c][r] with row stride NROWS + 8, so
// that P.V reads V's columns as contiguous pairs of keys.
template <int COLS, int NROWS>
__device__ __forceinline__ void load_tile_bf16_t(bf16* dst, const bf16* base, int row0,
                                                 int rows_valid, int stride, int d, int tid,
                                                 int nthreads) {
  constexpr int kChunks = COLS / 8;
  constexpr int kLd = NROWS + 8;
  for (int idx = tid; idx < NROWS * kChunks; idx += nthreads) {
    const int r = idx % NROWS;  // consecutive threads: consecutive keys
    const int c = (idx / NROWS) * 8;
    const int s = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < rows_valid && c < d) v = *reinterpret_cast<const uint4*>(base + (size_t)s * stride + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * kLd + r] = e[i];
  }
}

// o[16 x 8*OT] += P (16 x 8*NT, rounded to bf16) . V_tile; V stored
// transposed in shared memory as vt[8*OT][LDV].
template <int NT, int OT, int LDV>
__device__ __forceinline__ void pv_tile(float (&o)[OT][4], const float (&p)[NT][4],
                                        const bf16* vt, int g, int t) {
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kt][0], p[2 * kt][1]), pack_bf16(p[2 * kt][2], p[2 * kt][3]),
        pack_bf16(p[2 * kt + 1][0], p[2 * kt + 1][1]),
        pack_bf16(p[2 * kt + 1][2], p[2 * kt + 1][3])};
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      const bf16* vr = vt + (ot * 8 + g) * LDV + kt * 16 + 2 * t;
      mma_bf16(o[ot], pa, ld_u32(vr), ld_u32(vr + 8));
    }
  }
}

// c[16 x 8*NT] = A . B^T with A the 16 rows at `as` and B the 8*NT rows at
// `bs`, both bf16 in shared memory with row stride LD and depth 16*KT.
template <int KT, int NT, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const bf16* as, const bf16* bs, int g,
                                        int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const bf16* r0 = as + g * LD + kt * 16 + 2 * t;
    const bf16* r1 = r0 + 8 * LD;
    const uint32_t a[4] = {ld_u32(r0), ld_u32(r1), ld_u32(r0 + 8), ld_u32(r1 + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* br = bs + (nt * 8 + g) * LD + kt * 16 + 2 * t;
      mma_bf16(c[nt], a, ld_u32(br), ld_u32(br + 8));
    }
  }
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
