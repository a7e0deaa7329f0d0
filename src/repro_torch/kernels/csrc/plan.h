// Host-side launch plans of the kernels: plain C++ with no CUDA, so that the
// CPU tests build this header with the host compiler and check the plans
// (tests/test_torch_kernel_plans.py).  The .cu sources include it.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define REPRO_HD __host__ __device__
#else
#define REPRO_HD
#endif

namespace repro {

// bt_count on a contiguous stream of `rows` rows of `lanes` elements of
// `isz` bytes at address `base`: element i (i < ncmp = (rows - 1) * lanes)
// is compared with element i + lanes.  Elements [0, head) come before the
// first 16-byte aligned word and [tail, ncmp) after the last body word; the
// nw body words in between are read as 16-byte words, each with its partner
// window lanes * isz bytes on: aligned word pw (relative to the body word)
// and, when r > 0, the next one, r bytes into them.  The body stops where
// the partner window's last word would pass the stream's end.
struct FlatPlan {
  long long ncmp, head, nw, tail, pw;
  int r;
};

inline FlatPlan flat_plan(uintptr_t base, long long rows, long long lanes, long long isz) {
  FlatPlan p;
  p.ncmp = (rows - 1) * lanes;
  p.head = (long long)(((16 - (base & 15)) & 15) / isz);
  if (p.head > p.ncmp) p.head = p.ncmp;
  const long long avail = (p.ncmp - p.head) * isz;  // compared bytes from the body on
  const long long lb = lanes * isz;
  p.r = (int)(lb & 15);
  p.nw = avail < 16 ? 0 : (p.r ? (avail + p.r - 16) / 16 : avail / 16);
  p.tail = p.head + p.nw * 16 / isz;
  p.pw = (lb - p.r) / 16;
  return p;
}

// bt_count on a row-strided stream (rows `stride` elements apart): the
// widest vector v in {16, 8, 4} bytes that every row start allows (its
// address and the row stride) and that a row fills, nv of them a row, the
// rest of the row element by element; 2**gl threads (at most `threads`)
// share a row pair, enough for its nv + rest loads.
struct RowsPlan {
  int v, nv, gl;
};

inline RowsPlan rows_plan(uintptr_t base, long long lanes, long long stride, long long isz,
                          int threads) {
  RowsPlan p;
  const long long lb = lanes * isz;
  p.v = 0;
  for (int c = 16; c >= 4 && !p.v; c >>= 1)
    if (c <= lb && base % c == 0 && (stride * isz) % c == 0) p.v = c;
  p.nv = p.v ? (int)(lb / p.v) : 0;
  const long long units = p.nv + (lb - (long long)p.nv * p.v) / isz;  // loads per row pair
  p.gl = 0;
  while ((1LL << p.gl) < units && (1 << p.gl) < threads) ++p.gl;
  return p;
}

// Bytes of a block's flit image: bpk packets of `flits` rows, each padded
// to an odd number of 32-bit words, rounded up to 16.
REPRO_HD inline size_t image_words_bytes(int bpk, int flits, int lanes) {
  return ((size_t)bpk * flits * 4 * (((lanes + 3) >> 2) | 1) + 15) & ~(size_t)15;
}

// Bytes of byte packets staged after the image: each side's packets from a
// 16-byte boundary (none for int32 packets, which the layout reads in place).
inline size_t staged_bytes(int bpk, int n, int paired, int isz) {
  const size_t side = ((size_t)bpk * n + 15) & ~(size_t)15;
  return isz == 1 ? side * (paired ? 2 : 1) : 0;
}

// The activity kernel's dynamic shared memory: the image, then the staged
// packets or, once the image is laid out, the bus-invert (partition,
// 32-row step) cells of `cell_bytes` each — room for at least one config's
// cells (pmax partitions over the block's steps) and `min_cells`.
struct ActSmem {
  size_t bytes;
  int ncells;
};

inline ActSmem act_smem(int bpk, int flits, int lanes, int n, int paired, int isz, int pmax,
                        int min_cells, int cell_bytes) {
  ActSmem a;
  const int steps = (bpk * flits + 31) >> 5;
  a.ncells = pmax * steps > min_cells ? pmax * steps : min_cells;
  const size_t cells = (size_t)a.ncells * cell_bytes;
  const size_t staged = staged_bytes(bpk, n, paired, isz);
  a.bytes = image_words_bytes(bpk, flits, lanes) + (staged > cells ? staged : cells);
  return a;
}

// psu_stream on P packets of n elements of `isz` bytes, il input lanes and
// wl (0 or il) weight lanes: persistent blocks walk tiles of tp whole
// packets.  A tile's spans in x and w (tp*n*isz bytes each), in order and
// rank (tp*n*4) and in the stream (tp*n*lanes/il) start 16-byte aligned
// when the bases are: tp is a multiple of the quantum q.  tp is the largest
// such count whose x span fits STREAM_TILE_BYTES, cut (when the card's SM
// count `sms` is > 0) to the smallest count that leaves no more than
// STREAM_TILES_PER_SM tiles per SM: a batch too small for full tiles
// everywhere (the transmit path's) still spreads over every SM.  Two tiles
// an SM, each walked by its own block, measured faster on the H100 at every
// transmit-path shape than one, three (a tile per block slot) or six: a
// tile's and a block's fixed steps against the packets a warp ranks in
// turn.  One block's dynamic shared memory: two stages, each holding for
// each side the `head` bytes before the tile (its last n elements are the
// packet before the tile) and the tile; a row (`pad`) that ends where the
// flit image begins and holds the flit before the tile's first; the image
// (tp*F rows of `lanes` bytes); for n > 32 a row of n ints per warp for
// `order`.
constexpr int STREAM_TILE_BYTES = 8192;
constexpr int STREAM_TILES_PER_SM = 2;

struct StreamPlan {
  int q, tp;
  long long tiles;
  size_t head, stage, pad, image, wbuf, smem;
};

inline size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

inline StreamPlan stream_plan(long long P, int n, int isz, int il, int wl, int warps, int sms) {
  StreamPlan p;
  const int lanes = il + wl;
  const int per_elem = isz < lanes / il ? isz : lanes / il;  // fewest bytes an element spans
  int g = 16;
  while ((n * per_elem) % g) g >>= 1;
  p.q = 16 / g;
  const int fit = STREAM_TILE_BYTES / (n * isz) / p.q * p.q;
  p.tp = fit > p.q ? fit : p.q;
  if (sms > 0) {
    const long long most = (long long)STREAM_TILES_PER_SM * sms;
    const long long cap = (P + most - 1) / most;
    const long long cut = (cap + p.q - 1) / p.q * p.q;
    if (cut < p.tp) p.tp = (int)cut;
  }
  p.tiles = (P + p.tp - 1) / p.tp;
  const size_t elems = (size_t)p.tp * n;
  p.head = round16((size_t)n * isz);
  p.stage = p.head + round16(elems * isz);
  p.pad = round16((size_t)lanes);
  p.image = round16(elems * lanes / il);
  p.wbuf = n > 32 ? (size_t)warps * n * 4 : 0;
  p.smem = 2 * p.stage * (wl ? 2 : 1) + p.pad + p.image + p.wbuf;
  return p;
}

}  // namespace repro
