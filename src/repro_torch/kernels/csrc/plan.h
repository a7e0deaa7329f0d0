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

}  // namespace repro
