// Shared device helpers of the repro_torch kernels: the PSU sort key, the
// one-warp stable counting-sort rank, and the block reduction into one
// atomicAdd.  Everything here is integer arithmetic, so results are exact
// whatever the order in which blocks run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // warps per block
constexpr int THREADS = 32 * WARPS;

// Sort-key parameters of one PSU launch: ACC (k == 0) keys on the exact
// popcount of the low `width` bits (W+1 buckets), APP on p*k/(W+1).
struct KeySpec {
  unsigned mask;
  int width;
  int k;
  int nb;
  int desc;
};

__host__ __device__ inline KeySpec make_key_spec(int width, int k, int desc) {
  KeySpec s;
  s.mask = (width >= 32) ? 0xffffffffu : ((1u << width) - 1u);
  s.width = width;
  s.k = k;
  s.nb = k == 0 ? width + 1 : k;
  s.desc = desc;
  return s;
}

__device__ __forceinline__ int psu_key(unsigned bits, const KeySpec& s) {
  const int p = __popc(bits & s.mask);
  const int key = s.k == 0 ? p : (p * s.k) / (s.width + 1);
  return s.desc ? s.nb - 1 - key : key;
}

// Stable counting-sort ranks of one packet row of n elements, by one warp.
// Pass 1 builds the <= 17-bucket histogram (one leader lane per distinct key
// in each 32-element chunk adds its match count), a warp scan turns it into
// bucket start addresses, and pass 2 gives every element
//   rank = start[key] + #earlier elements with the same key
// (earlier chunks through the running start, this chunk through the match
// mask below the lane).  `hist` is this warp's 32-int shared scratch.
// visit(i, rank) is called once per element.
template <typename T, typename Visit>
__device__ __forceinline__ void warp_rank(const T* __restrict__ row, int n,
                                          const KeySpec& s, int* hist,
                                          Visit visit) {
  const int lane = threadIdx.x & 31;
  hist[lane] = 0;
  __syncwarp();
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    // lanes past the row get a unique key >= 32: they match nothing
    const int key = i < n ? psu_key((unsigned)row[i], s) : 32 + lane;
    const unsigned same = __match_any_sync(FULL, key);
    if (i < n && lane == __ffs(same) - 1) hist[key] += __popc(same);
    __syncwarp();
  }
  const int h = hist[lane];
  int incl = h;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  hist[lane] = incl - h;  // exclusive prefix: the running start per bucket
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int key = i < n ? psu_key((unsigned)row[i], s) : 32 + lane;
    const unsigned same = __match_any_sync(FULL, key);
    if (i < n) visit(i, hist[key] + __popc(same & below));
    __syncwarp();
    if (i < n && lane == __ffs(same) - 1) hist[key] += __popc(same);
    __syncwarp();
  }
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

}  // namespace repro
