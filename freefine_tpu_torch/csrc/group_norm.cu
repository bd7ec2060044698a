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
// Design: one launch, one thread-block cluster per unit of work.
//   * A unit is one batch image times a block of whole groups (`gb` groups,
//     `cb` channels).  Groups are independent, so no reduction crosses a
//     unit.  On the TMA route the block's row is a multiple of 16 bytes and
//     at most 256 elements (the TMA box limit); every SD-1.5 width allows it
//     (320 channels: 4 groups, 80 bytes; 960: 4 groups, 240 bytes).
//   * The unit's H*W positions are split over the cluster's CTAs (1 to 16,
//     picked by the wrapper), each a contiguous range of `rows_per_cta`
//     positions.  A CTA stages its range in shared memory as TMA boxes of
//     `box_rows` positions x `cb` channels over x seen as (C, H*W, B)
//     (`hopper::make_rows_map`), one mbarrier per box.
//   * Statistics: each thread owns one 16-byte vector of channels and every
//     `phases`-th position of a box, and sums x - k and (x - k)^2 per
//     channel, k the channel's value at the CTA's first position (shifted
//     data: the sums stay of the order of the channel's spread, so no
//     E[x^2] - mean^2 cancellation, which over a million float32 values
//     (the 512^2 VAE slabs) can lose the variance).  The CTA sums the
//     threads' slots per channel in a fixed two-level order, takes each
//     channel's mean and M2, then each group's (equal counts: the mean of
//     the channel means, M2 = sum of M2_c + n (mean_c - mean)^2); the
//     cluster merges its CTAs' (count, mean, M2) by Chan et al. through
//     distributed shared memory, every CTA reading all of them in rank
//     order, so that all hold the same mean and rstd.  No atomics and no
//     global scratch: two calls give the same bits.
//   * Normalise: y = x * a + s per channel (a = rstd * scale, s = bias -
//     mean * a), the SiLU and the cast, from shared memory, written with
//     16-byte stores.
// Two routes share the kernel:
//   * resident: the CTA's boxes all fit in shared memory (every UNet shape):
//     x is read once;
//   * streamed: they do not (the VAE's 512^2 slabs, some 256^2): the boxes
//     pass through a ring of `stages` boxes twice, once for the statistics
//     and once to normalise; the second pass's first boxes load while the
//     cluster merges.  One launch, two reads, no global partials.
// A third, for layouts TMA cannot take (a position's channels not a
// multiple of 16 bytes, or x not 16-byte aligned): the same partition and
// merges with one element per thread and ordinary loads from global memory,
// x read twice.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <map>
#include <utility>

#include "hopper.cuh"

namespace gn {

namespace cg = cooperative_groups;
namespace hopper = ff::hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;        // with cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kMaxSmem = 232448;       // dynamic shared memory of one CTA (227 KB)
constexpr int kMaxBox = 256;           // TMA box edge, elements

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// VEC consecutive elements (16 bytes when VEC > 1) to float32 and back.
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

// 1 / x for x in [1, 1e30] without the SFU: an integer first guess (about
// 4 correct bits) and three Newton steps r (2 - x r), each doubling the
// bits (at most 1.5e-7 relative error).  The SiLU's exponential takes the
// SFU (16 operations per clock and SM, an eighth of the FMA pipe's rate);
// its reciprocal runs here on the FMA pipe beside it instead of taking the
// SFU a second time.
__device__ __forceinline__ float recip(float x) {
  float r = __int_as_float(0x7EF311C3 - __float_as_int(x));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = r * fmaf(-x, r, 2.f);
  return r;
}

template <int VEC>
__device__ __forceinline__ void normalise(float (&v)[VEC], const float (&a)[VEC],
                                          const float (&s)[VEC], bool silu) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float t = fmaf(v[j], a[j], s[j]);
    // y * sigmoid(y); below y = -69 sigmoid is under 1e-30 and is taken as
    // 1e-30 (the product stays below 1e-28)
    if (silu) t *= recip(1.f + fminf(__expf(-t), 1e30f));
    v[j] = t;
  }
}

struct Params {
  const void* x;
  void* y;
  const float* scale;
  const float* bias;
  int hw;            // positions per image
  int channels;
  int cpg;           // channels per group
  int cb;            // channels per block: gb whole groups
  int gb;            // groups per block
  int blocks;        // channel blocks per image
  int rows_per_cta;  // positions per CTA (staged: a multiple of box_rows)
  int box_rows;      // positions per TMA box, one ring stage (staged)
  int stages;        // ring stages (0 on the plain-load route)
  int stage_bytes;   // one box, rounded up to 128 bytes
  int stat_floats;   // per-thread sum slots: max(kThreads * VEC, cb)
  float eps;
  int silu;
};

// Dynamic shared memory: the ring (stages x stage_bytes), then float32
// s1[stat_floats] and s2[stat_floats] (each thread's shifted sums per
// channel and position phase), shift[max(kThreads, cb)] (each channel's
// shift), the CTA's per-group partials cta[3 gb] and the groups' mean and
// rstd grp[2 gb], then one mbarrier per stage.
inline __host__ __device__ int stats_bytes(int stat_floats, int cb, int gb) {
  return ((2 * stat_floats + (cb > kThreads ? cb : kThreads) + 5 * gb) * 4 + 7) / 8 * 8;
}
inline __host__ __device__ int smem_bytes(int stages, int stage_bytes, int stat_floats, int cb,
                                          int gb) {
  return stages * stage_bytes + stats_bytes(stat_floats, cb, gb) + 8 * stages;
}

// grid (cluster, batch * blocks), cluster (cluster, 1, 1): blockIdx.y is the
// unit (batch b, channel block), the CTA's rank its range of positions.
// Thread t owns channel vector v0 = t % tpr of the block (VEC channels; the
// plain route also v0 + tpr, ...) and positions r0, r0 + phases, ... of
// each box (plain route: of its range), r0 = t / tpr.
template <typename T, int VEC, bool STAGED>
__global__ void __launch_bounds__(kThreads)
gn_cluster_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  const int ncta = (int)cluster.num_blocks();
  const int b = blockIdx.y / p.blocks, c0 = (blockIdx.y % p.blocks) * p.cb;
  const int nv = p.cb / VEC;
  const int tpr = nv < kThreads ? nv : kThreads;
  const int phases = kThreads / tpr;
  const int r0 = tid / tpr, v0 = tid % tpr;
  const bool active = r0 < phases;
  const int row0 = rank * p.rows_per_cta;
  const int row_end = min(p.hw, row0 + p.rows_per_cta);
  const int nrows = max(0, row_end - row0);
  const size_t img = (size_t)b * p.hw;

  unsigned char* ring = smem;
  float* s1 = reinterpret_cast<float*>(smem + p.stages * p.stage_bytes);
  float* s2 = s1 + p.stat_floats;
  float* shift = s2 + p.stat_floats;
  float* cta = shift + (p.cb > kThreads ? p.cb : kThreads);
  float* grp = cta + 3 * p.gb;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes +
                                               stats_bytes(p.stat_floats, p.cb, p.gb));

  // Staged routes: box i of the sequence (i < nchunks: the statistics pass;
  // streamed, i >= nchunks: the normalise pass, box i - nchunks again) goes
  // to stage i % stages.  Resident: every box has a stage of its own and
  // the normalise pass reads them where they are.
  const int nchunks = STAGED ? (nrows + p.box_rows - 1) / p.box_rows : 0;
  const bool resident = nchunks <= p.stages;
  const int loads = resident ? nchunks : 2 * nchunks;
  const CUtensorMap* tmap = &map;
  auto issue = [&](int i) {
    const int s = i % p.stages;
    hopper::mbar_arrive_tx(&full[s], (uint32_t)(p.box_rows * p.cb * sizeof(T)));
    hopper::tma_load_3d(ring + s * p.stage_bytes, tmap, &full[s], c0,
                        row0 + (i % nchunks) * p.box_rows, b);
  };
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);

  // ---- statistics, pass 1: each thread's sums of (x - k) and (x - k)^2
  // per channel over its positions, k the channel's value at the CTA's
  // first position (so the sums stay of the order of the channel's spread:
  // no E[x^2] - mean^2 cancellation)
  if constexpr (STAGED) {
    if (tid == 0) {
      hopper::prefetch_map(tmap);
      for (int s = 0; s < p.stages; ++s) hopper::mbar_init(&full[s], 1);
      hopper::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < min(p.stages, loads); ++i) issue(i);
    float k[VEC], a1[VEC], a2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) k[j] = a1[j] = a2[j] = 0.f;
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % p.stages;
      hopper::mbar_wait(&full[s], (uint32_t)((i / p.stages) & 1));
      const int valid = min(p.box_rows, nrows - i * p.box_rows);
      if (active) {
        const T* tile = reinterpret_cast<const T*>(ring + s * p.stage_bytes) + v0 * VEC;
        if (i == 0) load_vec<T, VEC>(tile, k);
#pragma unroll 4
        for (int r = r0; r < valid; r += phases) {
          float v[VEC];
          load_vec<T, VEC>(tile + (size_t)r * p.cb, v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float d = v[j] - k[j];
            a1[j] += d;
            a2[j] = fmaf(d, d, a2[j]);
          }
        }
      }
      if (!resident) {
        __syncthreads();  // every thread is done with stage s
        if (tid == 0 && i + p.stages < loads) issue(i + p.stages);
      }
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1[r0 * p.cb + v0 * VEC + j] = a1[j];
        s2[r0 * p.cb + v0 * VEC + j] = a2[j];
        if (r0 == 0) shift[v0 * VEC + j] = k[j];
      }
    }
  } else {
    if (active) {
      for (int v = v0; v < nv; v += tpr) {
        const T* col = x + (img + row0) * p.channels + c0 + v * VEC;
        float k[VEC], a1[VEC], a2[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) k[j] = a1[j] = a2[j] = 0.f;
        if (nrows > 0) load_vec<T, VEC>(col, k);
#pragma unroll 8
        for (int r = r0; r < nrows; r += phases) {
          float e[VEC];
          load_vec<T, VEC>(col + (size_t)r * p.channels, e);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float d = e[j] - k[j];
            a1[j] += d;
            a2[j] = fmaf(d, d, a2[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1[r0 * p.cb + v * VEC + j] = a1[j];
          s2[r0 * p.cb + v * VEC + j] = a2[j];
          if (r0 == 0) shift[v * VEC + j] = k[j];
        }
      }
    }
  }
  __syncthreads();

  // ---- pass 2: per channel over the position phases, in a fixed order
  // (phase q, q + nq, ... into slot q by one thread each, then the nq
  // slots), then the channel's mean k + S1 / n and M2 = S2 - S1^2 / n over
  // the CTA's n positions, in slot 0
  const int nq = min(phases, max(1, kThreads / p.cb));
  for (int e = tid; e < nq * p.cb; e += kThreads) {
    const int q = e / p.cb, c = e % p.cb;
    float t1 = 0.f, t2 = 0.f;
    for (int ph = q; ph < phases; ph += nq) {
      t1 += s1[ph * p.cb + c];
      t2 += s2[ph * p.cb + c];
    }
    s1[q * p.cb + c] = t1;  // only this thread reads column c of rows q (mod nq)
    s2[q * p.cb + c] = t2;
  }
  __syncthreads();
  const float n = (float)nrows;
  for (int c = tid; c < p.cb; c += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < nq; ++q) {
      t1 += s1[q * p.cb + c];
      t2 += s2[q * p.cb + c];
    }
    const float d = nrows > 0 ? t1 / n : 0.f;
    s1[c] = shift[c] + d;
    s2[c] = fmaxf(t2 - t1 * d, 0.f);
  }
  __syncthreads();

  // ---- pass 3: per group over its channels (equal counts: the mean of
  // the channel means, and M2 = sum of M2_c + n (mean_c - mean)^2), one
  // warp per group, lanes over channels and a fixed butterfly; the CTA's
  // (count, mean, M2) per group in cta[]
  for (int g = warp; g < p.gb; g += kWarps) {
    const float* mc = s1 + g * p.cpg;
    const float* m2c = s2 + g * p.cpg;
    float t = 0.f;
    for (int c = lane; c < p.cpg; c += 32) t += mc[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    const float mean = t / (float)p.cpg;
    t = 0.f;
    for (int c = lane; c < p.cpg; c += 32) {
      const float d = mc[c] - mean;
      t += fmaf(n * d, d, m2c[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) {
      cta[3 * g] = n * (float)p.cpg;
      cta[3 * g + 1] = mean;
      cta[3 * g + 2] = t;
    }
  }

  // ---- the cluster's: every CTA merges all CTAs' partials (Chan et al.)
  // in rank order through distributed shared memory, so all hold the same
  // bits
  if (ncta > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();  // every CTA's partials are written
  } else {
    __syncthreads();
  }
  if (tid < p.gb) {
    Stats s{0.f, 0.f, 0.f};
    for (int r = 0; r < ncta; ++r) {
      const float* peer = ncta > 1 ? cluster.map_shared_rank(cta, r) : cta;
      s = merge(s, Stats{peer[3 * tid], peer[3 * tid + 1], peer[3 * tid + 2]});
    }
    grp[2 * tid] = s.mean;
    grp[2 * tid + 1] = rsqrtf(s.m2 / s.n + p.eps);
  }
  if (ncta > 1) hopper::cluster_arrive();  // done reading the peers' shared memory
  __syncthreads();

  // ---- normalise: y = x * a + s, the SiLU, the cast
  if constexpr (STAGED) {
    float a[VEC], sh[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int cl = active ? v0 * VEC + j : 0;
      const int g = cl / p.cpg;
      a[j] = grp[2 * g + 1] * p.scale[c0 + cl];
      sh[j] = p.bias[c0 + cl] - grp[2 * g] * a[j];
    }
    for (int j = 0; j < nchunks; ++j) {
      const int i = resident ? j : nchunks + j;
      const int s = i % p.stages;
      if (!resident) hopper::mbar_wait(&full[s], (uint32_t)((i / p.stages) & 1));
      const int valid = min(p.box_rows, nrows - j * p.box_rows);
      if (active) {
        const T* tile = reinterpret_cast<const T*>(ring + s * p.stage_bytes) + v0 * VEC;
        T* out = y + (img + row0 + (size_t)j * p.box_rows) * p.channels + c0 + v0 * VEC;
#pragma unroll 4
        for (int r = r0; r < valid; r += phases) {
          float v[VEC];
          load_vec<T, VEC>(tile + (size_t)r * p.cb, v);
          normalise<VEC>(v, a, sh, p.silu != 0);
          store_vec<T, VEC>(out + (size_t)r * p.channels, v);
        }
      }
      if (!resident) {
        __syncthreads();
        if (tid == 0 && i + p.stages < loads) issue(i + p.stages);
      }
    }
  } else {
    if (active) {
      for (int v = v0; v < nv; v += tpr) {
        float a[VEC], sh[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int cl = v * VEC + j, g = cl / p.cpg;
          a[j] = grp[2 * g + 1] * p.scale[c0 + cl];
          sh[j] = p.bias[c0 + cl] - grp[2 * g] * a[j];
        }
        const size_t at = (img + row0) * p.channels + c0 + v * VEC;
#pragma unroll 8
        for (int r = r0; r < nrows; r += phases) {
          float e[VEC];
          load_vec<T, VEC>(x + at + (size_t)r * p.channels, e);
          normalise<VEC>(e, a, sh, p.silu != 0);
          store_vec<T, VEC>(y + at + (size_t)r * p.channels, e);
        }
      }
    }
  }
  if (ncta > 1) hopper::cluster_wait();  // no CTA leaves while a peer may still read cta[]
}

namespace {  // internal linkage: each loaded copy of the library keeps its own state

template <typename T, int VEC, bool STAGED>
cudaError_t configure() {
  static cudaError_t state = cudaErrorNotReady;
  if (state == cudaErrorNotReady) {
    state = cudaFuncSetAttribute(gn_cluster_kernel<T, VEC, STAGED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (state == cudaSuccess)
      state = cudaFuncSetAttribute(gn_cluster_kernel<T, VEC, STAGED>,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return state;
}

inline void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cluster,
                           int units, int smem, cudaStream_t stream) {
  memset(cfg, 0, sizeof(*cfg));
  cfg->gridDim = dim3(cluster, units, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// A launch's configuration: a cluster of one CTA is launched as a plain grid
// (an implicit cluster of one: the cluster barriers and this_cluster() still
// hold), which takes less time to launch.
inline void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cluster,
                          int units, int smem, cudaStream_t stream) {
  cluster_config(cfg, attr, cluster, units, smem, stream);
  if (cluster == 1) cfg->numAttrs = 0;
}

// Clusters of `cluster` CTAs with `smem` bytes each that the card can hold at
// once (cudaOccupancyMaxActiveClusters), or minus the CUDA error.  Asked once
// per instantiation and shape, then kept, so that a call under CUDA graph
// capture queries nothing.
template <typename T, int VEC, bool STAGED>
int active_clusters(int cluster, int smem) {
  static std::map<std::pair<int, int>, int> known;
  const auto key = std::make_pair(cluster, smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  cudaError_t err = configure<T, VEC, STAGED>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, 1, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gn_cluster_kernel<T, VEC, STAGED>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  known[key] = n;
  return n;
}

template <typename T, int VEC, bool STAGED>
cudaError_t launch(const Params& p, int batch, int cluster, int smem, cudaStream_t stream) {
  const int active = active_clusters<T, VEC, STAGED>(cluster, smem);
  if (active < 0) return static_cast<cudaError_t>(-active);
  if (active == 0) return cudaErrorInvalidConfiguration;  // the cluster shape fits no GPC
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (STAGED) {
    const cudaError_t err = hopper::make_rows_map(&map, p.x, sizeof(T) == 4, batch, p.hw,
                                                  p.channels, p.cb, p.box_rows);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, cluster, batch * p.blocks, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, VEC, STAGED>, map, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

}  // namespace gn

// The four instantiations: dtype 0 float32, 1 bfloat16; staged (stages >
// 0: TMA boxes in shared memory, 16-byte vectors, vec 16 / element size)
// or the plain-load route (one element per thread from global memory).
#define GN_DISPATCH(CALL, OTHERWISE)                                  \
  if (dtype == 1 && vec == 8 && staged) return CALL(gn::bf16, 8, true);   \
  if (dtype == 0 && vec == 4 && staged) return CALL(float, 4, true);      \
  if (dtype == 1 && vec == 1 && !staged) return CALL(gn::bf16, 1, false); \
  if (dtype == 0 && vec == 1 && !staged) return CALL(float, 1, false);    \
  return OTHERWISE

// Clusters of `cluster` CTAs of `smem_bytes` dynamic shared memory that the
// card holds at once for the instantiation (as group_norm_silu_fwd picks
// it from dtype, vec and stages), or minus the CUDA error.
extern "C" int group_norm_active_clusters(int dtype, int vec, int stages, int cluster,
                                          int smem_bytes) {
  const bool staged = stages > 0;
  if (cluster < 1 || cluster > gn::kMaxCluster || smem_bytes < 0 || smem_bytes > gn::kMaxSmem)
    return -(int)cudaErrorInvalidValue;
#define GN_ACTIVE(T, VEC, STAGED) gn::active_clusters<T, VEC, STAGED>(cluster, smem_bytes)
  GN_DISPATCH(GN_ACTIVE, -(int)cudaErrorInvalidValue);
#undef GN_ACTIVE
}

// One launch of the cluster kernel.  dtype: 0 = float32, 1 = bfloat16; x
// and y channels-last [batch, hw, channels].  stages > 0: the staged
// routes (resident or streamed), vec 16 / element size, x and y 16-byte
// aligned, the channels and a block of groups_per_block groups multiples
// of 16 bytes, the block at most 256 elements, TMA boxes of `box_rows`
// positions (rows_per_cta a multiple of it) and a ring of `stages` boxes;
// stages 0: the plain-load route, vec 1 (box_rows unused).  `cluster` CTAs
// of `rows_per_cta` positions per (batch, block).  smem_bytes must be the
// layout's size (`gn::smem_bytes`), as the wrapper's plan works it out.
// Returns the CUDA error of the launch (0 = launched): invalid value for
// arguments outside these rules, invalid configuration where the card can
// hold no cluster of this shape.
extern "C" int group_norm_silu_fwd(const void* x, const void* scale, const void* bias, void* y,
                                   int batch, int channels, int hw, int groups, float eps,
                                   int groups_per_block, int cluster, int rows_per_cta,
                                   int box_rows, int stages, int smem_bytes, int silu, int dtype,
                                   int vec, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  const bool staged = stages > 0;
  if (batch <= 0 || hw <= 0 || groups <= 0 || channels % groups != 0 || groups_per_block <= 0 ||
      groups % groups_per_block != 0 || groups_per_block > gn::kThreads || cluster < 1 ||
      cluster > gn::kMaxCluster || rows_per_cta <= 0 || stages < 0 ||
      (long long)cluster * rows_per_cta < hw || (long long)batch * (groups / groups_per_block) > 65535)
    return (int)cudaErrorInvalidValue;
  const int cb = groups_per_block * (channels / groups);
  if (vec > 1 && (vec * es != 16 || (cb * es) % 16 != 0 || (channels * es) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (staged && (vec == 1 || cb > gn::kMaxBox || box_rows <= 0 || box_rows > gn::kMaxBox ||
                 rows_per_cta % box_rows != 0))
    return (int)cudaErrorInvalidValue;
  gn::Params p;
  p.x = x;
  p.y = y;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.hw = hw;
  p.channels = channels;
  p.cpg = channels / groups;
  p.cb = cb;
  p.gb = groups_per_block;
  p.blocks = groups / groups_per_block;
  p.rows_per_cta = rows_per_cta;
  p.box_rows = staged ? box_rows : 0;
  p.stages = stages;
  p.stage_bytes = staged ? (box_rows * cb * es + 127) / 128 * 128 : 0;
  p.stat_floats = gn::kThreads * vec > cb ? gn::kThreads * vec : cb;
  p.eps = eps;
  p.silu = silu;
  const int need = gn::smem_bytes(stages, p.stage_bytes, p.stat_floats, cb, p.gb);
  if (need != smem_bytes || need > gn::kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GN_LAUNCH(T, VEC, STAGED) \
  (int)gn::launch<T, VEC, STAGED>(p, batch, cluster, smem_bytes, s)
  GN_DISPATCH(GN_LAUNCH, (int)cudaErrorInvalidValue);
#undef GN_LAUNCH
}

#undef GN_DISPATCH

extern "C" const char* ff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
