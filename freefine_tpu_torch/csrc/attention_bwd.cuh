// Shared pieces of the warp-specialised wgmma backward kernels
// (flash_sdpa_bwd.cu: the flash dQ and dK/dV; tca_flash_bwd.cu: the TCA dQ
// and dK/dV).  Each of them keeps 64 rows per consumer warpgroup resident
// (queries for dQ, keys for dK/dV), streams tiles of the other operands
// through a TMA ring, runs the logit and dP products as SS wgmma and the
// gradient products as RS wgmma with the streamed operand read MN-major.
// The pieces here: those products over a padded head dim or a tile,
// accumulators packed to bf16 A fragments, the epilogue's row stores, the
// ring's barriers, and the grid rule picking 1 to 3 consumer warpgroups.
#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace ff {
namespace wgb {

constexpr float kLog2e = 1.4426950408889634f;
using hopper::kPanel;

// acc[64 x N] (+)= A . B^T over the padded head dim DK: A the 64 rows at
// `a` of a K-major operand of a_rows rows a panel, B the N rows of a K-major
// tile at `b`.  Issued, not committed.
template <int N, int DK>
__device__ __forceinline__ void ss_issue(float (&acc)[N / 2], uint32_t a, int a_rows, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the panel
    const uint64_t da = hopper::desc_sw128(a + (kk / 4) * a_rows * 128 + off, 16, 1024);
    const uint64_t db = hopper::desc_sw128(b + (kk / 4) * N * 128 + off, 16, 1024);
    hopper::Wgmma<N>::ss(acc, da, db, kk > 0);
  }
}

// acc[64 x DV] += A . B over the BT rows of a tile: A bf16 fragments in
// registers, B the tile at `b` read MN-major (its 64-column panels BT * 128
// bytes apart).  Issued, not committed.
template <int DV, int BT>
__device__ __forceinline__ void rs_issue(float (&acc)[DV / 2], const uint32_t (&a)[BT / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    hopper::WgmmaRS<DV>::rs(acc, a[kk], hopper::desc_sw128(b + kk * 16 * 128, BT * 128, 1024));
}

// An accumulator of a 64 x N tile as the A fragments of a product over its
// N columns, rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
  }
}

// A consumer thread's two rows of a 64 x DV accumulator -> bf16 row-major
// global rows (stride e), times `mul`; columns past d and rows past `rows`
// are not written.
template <int DV>
__device__ __forceinline__ void store_acc_rows(bf16* dst, const float (&acc)[DV / 2], int row0,
                                               int rows, int e, int d, float mul, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= rows) continue;
    bf16* orow = dst + (size_t)row * e;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[4 * i + 2 * hh] * mul, acc[4 * i + 2 * hh + 1] * mul);
    }
  }
}

// Barriers: full[s] completes when the producer warp's 32 lanes have arrived
// and the stage's bytes have landed; empty[s] when every consumer thread has
// released the stage; res when the resident operands have landed.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* res,
                                              int stages, int consumers) {
  for (int s = 0; s < stages; ++s) {
    hopper::mbar_init(&full[s], 32);
    hopper::mbar_init(&empty[s], consumers);
  }
  hopper::mbar_init(res, 1);
  hopper::mbar_fence_init();
}

// The SMs of the current device (the grid rule's yardstick), read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// Consumer warpgroups per CTA, of 1 .. max_nc: the fewest waves of CTAs
// over the SMs (one CTA an SM), ties to fewer warpgroups, whose CTAs finish
// sooner.  `grids` CTAs per row block (the TCA dK/dV grid runs one per key
// set).  A warpgroup's tile loop is bound by its own latency, so a CTA of
// more warpgroups takes little longer: S 4096 at batch 1 takes two (256
// CTAs, two waves), at batch 3 three (528 CTAs, four waves); S 1024 at batch
// 1 takes one (128 CTAs, one wave, where two would leave half the SMs idle).
inline int warpgroups(int rows, int bh, int max_nc, int grids = 1) {
  int best = 1;
  long best_waves = -1;
  for (int nc = 1; nc <= max_nc; ++nc) {
    const long ctas = (long)((rows + 64 * nc - 1) / (64 * nc)) * bh * grids;
    const long waves = (ctas + sm_count() - 1) / sm_count();
    if (best_waves < 0 || waves < best_waves) best = nc, best_waves = waves;
  }
  return best;
}

}  // namespace wgb
}  // namespace ff
