// group_norm: GroupNorm with float32 statistics, per-channel affine and an
// optional SiLU, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gn_kernel` behind `group_norm_silu`
// (freefine_tpu/ops/group_norm.py:86, via `_fused_gn_impl` :187).  Same
// function: x [B, C, H, W] (channels-last here, NHWC there) in bf16 or float32, scale
// and bias float32 [C]; per (batch, group) the mean and the population
// variance over its C/G channels and H*W positions in float32, then
// (x - mean) * rsqrt(var + eps) * scale[c] + bias[c], then y * sigmoid(y) if
// asked; output in x's dtype.
//
// Bound on an H100 SXM (3.35 TB/s): reading x once and writing y once.  At
// the UNet's 64^2 x 320, batch 3, bf16 that is 15.7 MB, about 4.7 us; the
// work is a few operations per element, far below the tensor cores' line,
// so the kernel is bound by bytes (and, at these sizes, by launch latency).
//
// Design (first version: simple and right; one resident pass is later work).
// x comes channels-last (NHWC in memory: the pipeline's latents are NHWC,
// and the convolutions pass that layout on; the wrapper copies any other
// input to it), so a group is strided: its C/G channels at every one of
// the H*W positions.  Three launches:
//   * Statistics pass: the threads of a block each own 16 bytes of channels
//     and walk the positions of one of `nsplit` position splits (chosen by
//     the wrapper to fill the 132 SMs), keeping per channel a Welford
//     (count, mean, M2); the block's 8 rows merge in a fixed order into one
//     partial per channel and split (Chan et al.).  No E[x^2] - mean^2
//     cancellation, which over a million f32 values (the 512^2 VAE slabs)
//     can lose the variance.
//   * Finalize: one block per (batch, group) merges its channels' partials
//     in fixed trees (no atomics: deterministic) into the group's mean and
//     rstd, and writes each channel's affine coefficients
//     (a = rstd * scale, s = bias - mean * a).
//   * Normalise pass: y = x * a + s, then the SiLU and the cast, each
//     thread keeping its channels' coefficients in registers.  x is read
//     twice; for the UNet's shapes the second read mostly hits the 50 MB L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kApplyPositions = 64;  // positions per block of the normalise pass

struct Stats {
  float n, mean, m2;
};

// Chan's merge of two (count, mean, M2) triples; an empty side is the identity.
__device__ __forceinline__ Stats merge(const Stats a, const Stats b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float wb = b.n / n;
  const float delta = b.mean - a.mean;
  return Stats{n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

// Butterfly over the warp; the lower lane of each pair is always the left
// operand, so both lanes of a pair compute the same value and every lane
// ends with the warp's merge in one fixed order.
__device__ __forceinline__ Stats warp_merge(Stats s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Stats t{__shfl_xor_sync(0xffffffffu, s.n, o), __shfl_xor_sync(0xffffffffu, s.mean, o),
                  __shfl_xor_sync(0xffffffffu, s.m2, o)};
    s = (lane & o) ? merge(t, s) : merge(s, t);
  }
  return s;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// VEC consecutive elements (16 bytes when VEC > 1; the wrapper checks the
// alignment) to float32 and back.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(*p);
  } else {
    static_assert(sizeof(T) * VEC == 16, "16-byte vectors");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f<T>(v[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// Statistics pass.  x is [B, HW, C] in memory; grid
// (ceil(C / VEC / 32), nsplit, B), block (32, 8): thread (tx, ty) owns the
// VEC channels of vector cv = blockIdx.x * 32 + tx and positions p0 + ty,
// p0 + ty + 8, ... of the split's [p0, p0 + pchunk).  Writes (count, mean,
// M2) per channel to partials[((b * nsplit + split) * C + c) * 3].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials, int hw,
                     int channels, int pchunk) {
  constexpr int kRows = kThreads / 32;
  __shared__ float row_mean[kRows][32][VEC], row_m2[kRows][32][VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int cv = blockIdx.x * 32 + tx;
  const bool active = cv < channels / VEC;
  const int p0 = blockIdx.y * pchunk;
  const int p1 = p0 + pchunk < hw ? p0 + pchunk : hw;
  float mean[VEC], m2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) mean[j] = m2[j] = 0.f;
  if (active) {
    const T* base = x + (size_t)blockIdx.z * hw * channels + (size_t)cv * VEC;
    int k = 0;
    for (int p = p0 + ty; p < p1; p += kRows) {
      float v[VEC];
      load_vec<T, VEC>(base + (size_t)p * channels, v);
      const float inv = 1.f / (float)(++k);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[j] - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (v[j] - mean[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    row_mean[ty][tx][j] = mean[j];
    row_m2[ty][tx][j] = m2[j];
  }
  __syncthreads();
  if (ty == 0 && active) {
    float* out = partials + (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * channels +
                             (size_t)cv * VEC) * 3;
    for (int j = 0; j < VEC; ++j) {
      Stats s{0.f, 0.f, 0.f};
      for (int r = 0; r < kRows; ++r) {
        const int rows_n = p0 + r < p1 ? (p1 - p0 - r + kRows - 1) / kRows : 0;
        s = merge(s, Stats{(float)rows_n, row_mean[r][tx][j], row_m2[r][tx][j]});
      }
      out[j * 3] = s.n;
      out[j * 3 + 1] = s.mean;
      out[j * 3 + 2] = s.m2;
    }
  }
}

// Finalize: one block per (batch, group) merges its cpg channels x
// nsplit partials (thread t takes items t, t + 256, ... in turn, then the
// warps' and the block's fixed trees) into the group's mean and rstd, and
// writes each of its channels' coefficients coef[b, c] = (a, s),
// a = rstd * scale[c], s = bias[c] - mean * a, so that the normalise pass
// is y = x * a + s.
__global__ void __launch_bounds__(kThreads)
gn_finalize_kernel(const float* __restrict__ partials, const float* __restrict__ scale,
                        const float* __restrict__ bias, float* __restrict__ coef, int channels,
                        int groups, int nsplit, float eps) {
  __shared__ Stats warp_stats[kWarps];
  __shared__ Stats group_stats;
  const int bg = blockIdx.x;
  const int b = bg / groups, g = bg % groups, cpg = channels / groups;
  Stats s{0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < cpg * nsplit; i += kThreads) {
    const float* p = partials + (((size_t)b * nsplit + i / cpg) * channels + g * cpg + i % cpg) * 3;
    s = merge(s, Stats{p[0], p[1], p[2]});
  }
  s = warp_merge(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_stats[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_merge(lane < kWarps ? warp_stats[lane] : Stats{0.f, 0.f, 0.f});
    if (lane == 0) group_stats = s;
  }
  __syncthreads();
  s = group_stats;
  const float rstd = rsqrtf(s.m2 / s.n + eps);
  for (int c = g * cpg + threadIdx.x; c < (g + 1) * cpg; c += kThreads) {
    const float a = rstd * scale[c];
    coef[((size_t)b * channels + c) * 2] = a;
    coef[((size_t)b * channels + c) * 2 + 1] = bias[c] - s.mean * a;
  }
}

// Normalise pass, mapped as the statistics pass: grid
// (ceil(C / VEC / 32), ceil(HW / kApplyPositions), B), block (32, 8);
// thread (tx, ty) keeps the coefficients of its VEC channels in registers
// and walks positions p0 + ty, p0 + ty + 8, ... of its block's span, so a
// warp reads and writes 32 neighbouring 16-byte vectors of one position.
// y = x * a + s with the channel's coefficients from the finalize pass.
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                     T* __restrict__ y, int hw, int channels) {
  constexpr int kRows = kThreads / 32;
  const int cv = blockIdx.x * 32 + threadIdx.x;
  if (cv >= channels / VEC) return;
  const int p0 = blockIdx.y * kApplyPositions;
  const int p1 = p0 + kApplyPositions < hw ? p0 + kApplyPositions : hw;
  const float* cf = coef + ((size_t)blockIdx.z * channels + (size_t)cv * VEC) * 2;
  float a[VEC], sh[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = cf[2 * j];
    sh[j] = cf[2 * j + 1];
  }
  const size_t base = (size_t)blockIdx.z * hw * channels + (size_t)cv * VEC;
  for (int p = p0 + threadIdx.y; p < p1; p += kRows) {
    float v[VEC];
    load_vec<T, VEC>(x + base + (size_t)p * channels, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float t = fmaf(v[j], a[j], sh[j]);
      if (SILU) t = t / (1.f + __expf(-t));
      v[j] = t;
    }
    store_vec<T, VEC>(y + base + (size_t)p * channels, v);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y,
                   float* partials, float* coef, int batch, int channels, int hw, int groups,
                   float eps, int nsplit, int pchunk, bool silu, cudaStream_t stream) {
  const int cvs = channels / VEC;
  gn_stats_kernel<T, VEC><<<dim3((cvs + 31) / 32, nsplit, batch), dim3(32, kThreads / 32), 0,
                            stream>>>(static_cast<const T*>(x), partials, hw, channels, pchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<batch * groups, kThreads, 0, stream>>>(partials, scale, bias, coef,
                                                               channels, groups, nsplit, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((cvs + 31) / 32, (hw + kApplyPositions - 1) / kApplyPositions, batch);
  const dim3 block(32, kThreads / 32);
  if (silu) {
    gn_apply_kernel<T, VEC, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), coef, static_cast<T*>(y), hw, channels);
  } else {
    gn_apply_kernel<T, VEC, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), coef, static_cast<T*>(y), hw, channels);
  }
  return cudaGetLastError();
}

}  // namespace gn

// dtype: 0 = float32 (vec 4 or 1), 1 = bfloat16 (vec 8 or 1); x and y
// channels-last, 16-byte aligned for vec > 1, which needs channels % vec ==
// 0; nsplit splits of `chunk` positions; scratch holds batch * nsplit *
// channels * 3 + batch * channels * 2 floats.  Returns the CUDA error of the
// launches (0 = launched).
extern "C" int group_norm_silu_fwd(const void* x, const void* scale, const void* bias, void* y,
                                   void* scratch, int batch, int channels, int hw, int groups,
                                   float eps, int nsplit, int chunk, int silu, int dtype, int vec,
                                   void* stream) {
  if (batch <= 0 || hw <= 0 || groups <= 0 || channels % groups != 0 || nsplit < 1 ||
      chunk <= 0 || vec <= 0 || channels % vec != 0 || nsplit > 65535 || batch > 65535 ||
      (long long)nsplit * chunk < hw ||
      (hw + gn::kApplyPositions - 1) / gn::kApplyPositions > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bs = static_cast<const float*>(bias);
  float* part = static_cast<float*>(scratch);
  float* coef = part + (size_t)batch * nsplit * channels * 3;
#define GN_CASE(T, VEC)                                                                    \
  return (int)gn::launch<T, VEC>(x, sc, bs, y, part, coef, batch, channels, hw, groups, eps, \
                                 nsplit, chunk, silu != 0, s)
  if (dtype == 1 && vec == 8) GN_CASE(gn::bf16, 8);
  if (dtype == 1 && vec == 1) GN_CASE(gn::bf16, 1);
  if (dtype == 0 && vec == 4) GN_CASE(float, 4);
  if (dtype == 0 && vec == 1) GN_CASE(float, 1);
#undef GN_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
