// Shared device helpers of the repro_torch kernels: the PSU sort key, the
// one-warp stable counting-sort ranks from the keys' bit-plane ballots, and
// the warp sum.  Everything here is integer arithmetic, so results are exact
// whatever the order in which blocks run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // warps per block
constexpr int THREADS = 32 * WARPS;
// blocks per SM the layout kernels are compiled for: at most 64 registers
// a thread, so four 256-thread blocks (32 warps) stay resident per SM
constexpr int MIN_BLOCKS = 4;
constexpr int KEY_BITS = 5;               // keys < 17 need at most 5 bits
constexpr int RANK_CHUNKS = 32;           // 32-element chunks of a 1,024-element row
constexpr int BAL_WORDS = RANK_CHUNKS * KEY_BITS;  // per-warp ballot scratch

// Sort-key parameters of one PSU launch: ACC (k == 0) keys on the exact
// popcount of the low `width` bits (W+1 buckets), APP on p*k/(W+1), taken
// as (p*k*mul) >> 16 with mul = ceil(2**16 / (W+1)) — exact for p*k <= 272
// and W+1 <= 17, and no division.  `bits` counts the bits of the largest
// key, nb - 1.
struct KeySpec {
  unsigned mask;
  int k;
  int nb;
  int desc;
  unsigned mul;
  int bits;
};

__host__ __device__ inline KeySpec make_key_spec(int width, int k, int desc) {
  KeySpec s;
  s.mask = (width >= 32) ? 0xffffffffu : ((1u << width) - 1u);
  s.k = k;
  s.nb = k == 0 ? width + 1 : k;
  s.desc = desc;
  s.mul = (65536u + (unsigned)width) / (unsigned)(width + 1);
  s.bits = 0;
  while ((1 << s.bits) < s.nb) ++s.bits;
  return s;
}

__device__ __forceinline__ unsigned psu_key(unsigned bits, const KeySpec& s) {
  const unsigned p = __popc(bits & s.mask);
  const unsigned key = s.k == 0 ? p : (p * (unsigned)s.k * s.mul) >> 16;
  return s.desc ? (unsigned)s.nb - 1u - key : key;
}

// x / d without a division instruction: d's multiply-high reciprocal,
// exact for x, d <= 4,096 (flit and lane indices of a packet).
struct FastDiv {
  unsigned d, m;
};

__host__ __device__ inline FastDiv make_fast_div(unsigned d) {
  FastDiv f;
  f.d = d;
  f.m = d > 1 ? 0xFFFFFFFFu / d + 1u : 0u;
  return f;
}

__device__ __forceinline__ unsigned fast_div(unsigned x, const FastDiv& f) {
  return f.d == 1 ? x : __umulhi(x, f.m);
}

// The ranking code below takes the key width BITS (0 .. KEY_BITS) as a
// template argument, so its per-bit loops unroll to exactly the ballots
// and mask steps a key needs; with_key_bits calls f(KeyBits<bits>()) for
// a width known only at run time.
template <int B>
struct KeyBits {
  static constexpr int value = B;
};

template <typename F>
__device__ __forceinline__ void with_key_bits(int bits, F f) {
  switch (bits) {
    case 0: f(KeyBits<0>()); break;
    case 1: f(KeyBits<1>()); break;
    case 2: f(KeyBits<2>()); break;
    case 3: f(KeyBits<3>()); break;
    case 4: f(KeyBits<4>()); break;
    default: f(KeyBits<5>()); break;
  }
}

// The ballots of a key's bit planes: B[b] holds bit b of every lane's key.
template <int BITS>
__device__ __forceinline__ void key_ballots(unsigned key, unsigned* B) {
#pragma unroll
  for (int b = 0; b < BITS; ++b) B[b] = __ballot_sync(FULL, (key >> b) & 1u);
}

// Among the lanes of `among`, those whose key equals `key` (eq) and those
// whose key is smaller (lt), from the bit-plane ballots, MSB first.
template <int BITS>
__device__ __forceinline__ void key_masks(const unsigned* B, unsigned key, unsigned among,
                                          unsigned& lt, unsigned& eq) {
  lt = 0u;
  eq = among;
#pragma unroll
  for (int b = BITS - 1; b >= 0; --b) {
    const unsigned mine = 0u - ((key >> b) & 1u);
    lt |= eq & ~B[b] & mine;
    eq &= ~(B[b] ^ mine);
  }
}

// Stable rank of each lane's key inside its segment `seg` of the warp (the
// lanes of one packet; a lane outside every packet passes seg = 0 and gets
// no meaningful rank): #smaller keys + #equal keys on lower lanes.  One
// pass, several short packets per warp.  Every lane of the warp calls it.
template <int BITS>
__device__ __forceinline__ int seg_rank(unsigned key, unsigned seg) {
  unsigned B[BITS > 0 ? BITS : 1], lt, eq;
  key_ballots<BITS>(key, B);
  key_masks<BITS>(B, key, seg, lt, eq);
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  return __popc(lt) + __popc(eq & below);
}

// The same for one packet row of 32 < n <= 64 elements, in registers and
// one pass: each lane keeps the key of its element in each 32-element
// chunk and every chunk's ballots, and its element's rank is
//   sum over chunks d of #smaller keys in d
//   + #equal keys in the chunks before its own + #equal keys below it.
// key_of(i) is called once per element, visit(i, rank) once per element.
constexpr int FEW_CHUNKS = 2;
template <int BITS, typename KeyOf, typename Visit>
__device__ __forceinline__ void warp_rank_few(int n, KeyOf key_of, Visit visit) {
  constexpr int NB = BITS > 0 ? BITS : 1;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned key[FEW_CHUNKS], B[FEW_CHUNKS][NB], valid[FEW_CHUNKS];
#pragma unroll
  for (int c = 0; c < FEW_CHUNKS; ++c) {
    const int left = n - c * 32;
    valid[c] = left >= 32 ? FULL : (left > 0 ? (1u << left) - 1u : 0u);
    key[c] = lane < left ? key_of(c * 32 + lane) : 0u;
    if (left > 0) key_ballots<BITS>(key[c], B[c]);
  }
#pragma unroll
  for (int c = 0; c < FEW_CHUNKS; ++c) {
    if (c * 32 >= n) break;
    unsigned r = 0;
#pragma unroll
    for (int d = 0; d < FEW_CHUNKS; ++d) {
      if (d * 32 >= n) break;
      unsigned lt, eq;
      key_masks<BITS>(B[d], key[c], valid[d], lt, eq);
      r += __popc(lt) + (d < c ? __popc(eq) : (d == c ? __popc(eq & below) : 0u));
    }
    if (c * 32 + lane < n) visit(c * 32 + lane, (int)r);
  }
}

// Stable counting-sort ranks of one packet row of 64 < n <= 1,024
// elements by one warp, each key computed once (key_of(i), called once per
// element).  Pass 1 takes every 32-element chunk's bit-plane ballots, keeps
// them in the warp's `bal` scratch (BAL_WORDS words) and counts each bucket
// in the lane of its key; a warp scan turns the counts into bucket starts.
// Pass 2 rebuilds each lane's key from the kept ballots and gives it
//   rank = start[key] + #same key in earlier chunks + #same key below the lane,
// the first two from the running start in lane `key`.  visit(i, rank) is
// called once per element.
template <int BITS, typename KeyOf, typename Visit>
__device__ __forceinline__ void warp_rank_long(int n, int nb, unsigned* bal, KeyOf key_of,
                                               Visit visit) {
  constexpr int NB = BITS > 0 ? BITS : 1;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool bucket = lane < nb;  // lane b counts key b
  unsigned cnt = 0, B[NB], lt, eq;
  for (int base = 0, c = 0; base < n; base += 32, ++c) {
    const int i = base + lane;
    const unsigned valid = n - base >= 32 ? FULL : (1u << (n - base)) - 1u;
    key_ballots<BITS>(i < n ? key_of(i) : 0u, B);
    if (lane < BITS) {
      unsigned mine = 0;
#pragma unroll
      for (int b = 0; b < BITS; ++b) mine = lane == b ? B[b] : mine;
      bal[c * KEY_BITS + lane] = mine;
    }
    key_masks<BITS>(B, (unsigned)lane, valid, lt, eq);
    if (bucket) cnt += __popc(eq);
  }
  unsigned incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  unsigned run = incl - cnt;  // lane b: where the next key-b element goes
  __syncwarp();
  for (int base = 0, c = 0; base < n; base += 32, ++c) {
    const int i = base + lane;
    const unsigned valid = n - base >= 32 ? FULL : (1u << (n - base)) - 1u;
    unsigned key = 0;
#pragma unroll
    for (int b = 0; b < BITS; ++b) {
      B[b] = bal[c * KEY_BITS + b];
      key |= ((B[b] >> lane) & 1u) << b;
    }
    key_masks<BITS>(B, key, valid, lt, eq);
    const unsigned r = __shfl_sync(FULL, run, (int)key) + __popc(eq & below);
    key_masks<BITS>(B, (unsigned)lane, valid, lt, eq);
    if (bucket) run += __popc(eq);
    if (i < n) visit(i, (int)r);
  }
  __syncwarp();  // the scratch is free for the next row
}

// Stable counting-sort ranks of one packet row of 1 <= n <= 1,024 elements
// by one warp: seg_rank for n <= 32, warp_rank_few up to 64, else
// warp_rank_long.
template <int BITS, typename KeyOf, typename Visit>
__device__ __forceinline__ void warp_rank_row(int n, int nb, unsigned* bal, KeyOf key_of,
                                              Visit visit) {
  if (n <= 32) {
    const int lane = threadIdx.x & 31;
    const bool in = lane < n;
    const unsigned key = in ? key_of(lane) : 0u;
    const int r = seg_rank<BITS>(key, __ballot_sync(FULL, in));
    if (in) visit(lane, r);
  } else if (n <= 32 * FEW_CHUNKS) {
    warp_rank_few<BITS>(n, key_of, visit);
  } else {
    warp_rank_long<BITS>(n, nb, bal, key_of, visit);
  }
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

}  // namespace repro
