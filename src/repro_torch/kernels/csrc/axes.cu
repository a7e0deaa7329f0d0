// The multi-axis BT core in its measurement modes (the fused transmit
// stream is csrc/stream.cu).
//
// 1. bt_axes: the jagged link x ordering x codec measurement — per link of
// an (L, P, N) batch with a real packet count per link, and per config of
// a static (ordering, codec) list, the (input, weight, invert-line) BT
// totals, plus the carry that chunked streaming threads across calls.
//
// Replaces the TPU kernel repro/kernels/axes.py:bt_axes_pallas in its
// measurement modes (b) and (c): the (link, packet-block) grid of
// _axes_block with every config unrolled, bus-invert's two entry branches
// from _bus_invert_bits, and the inter-block fold of
// repro/kernels/ops.py:_fold_axes.  Two kernels, one launch entry
// (repro_bt_axes):
//   * bt_axes_kernel, one block per (link, packet block) and ordering —
//     the orderings on the grid, and the wrapper cuts the packets per block
//     until a small batch gives at least two blocks per SM.  The block
//     stages its byte packets in shared memory with 16-byte loads and lays
//     them out under its ordering as a flit image whose rows are padded to
//     an odd number of 32-bit words (the ballot counting sort of
//     common.cuh, each key computed once, and a byte scatter; integer
//     addressing only, so no TF32 hazard).  One pass over the image's
//     words then counts every stateless config of the ordering at once,
//     four lanes per word, in registers: the data XOR for 'none', gray as
//     d ^ ((d >> 1) & 0x7f7f7f7f) of it, sign-magnitude by byte masks,
//     transition as the data popcount; one block reduction at the end.  Bus-invert runs on
//     all warps, each on its own segment of rows, one row a lane (the odd
//     row stride keeps that free of bank conflicts): from a 32-row step's
//     ballots of "HD > half" and "HD == half" (HD from word XOR-popcounts)
//     a row's invert state is the parity of the first since the step's
//     last tie, or the entering state XOR that parity — for both states
//     entering the segment; one thread per (config, partition) item then
//     composes the eight segment maps for both entry branches.  The
//     ordering's configs and items come from its record in the config
//     table.  It writes per-(block, config, branch) partials, first/last
//     wire flits and first/last invert states.
//   * bt_axes_fold_kernel, one warp per (link, config, partition), folds
//     that link's valid blocks as _fold_axes does, one block per lane: the
//     boundary into each block from the previous block's last wire flit
//     (the carried one for block 0, none on a cold start), partials summed
//     by a warp reduction, and bus-invert's entry branch per block as an
//     inclusive warp scan of the maps "branch of block g given the branch
//     of block g-1"; blocks past the link's valid rows leave the carry as
//     it was.
//
// Bound on this card: integer operations at the scale shapes (each byte is
// read once from device memory, then touched once per distinct ordering
// to lay out and a few times per config to count: ~4 operations per valid
// byte per sorted ordering and ~3 per config, 0.105 ms for the 256 x 16,384
// x 64 batch under 14 configs), bytes for few configs.  What the kernel
// spends is instruction issue: the stable ranking (some 50-130
// instructions a warp per 64-byte packet, by key width), the byte scatter
// and the per-row bus-invert steps, across five blocks per packet block.
// The block partials and edge flits are the only intermediates in device
// memory; the fold re-reads them once.
//
// 2. bt_axes_activity: the same measurement with per-wire activity windows
// — per (link, config) the toggles of every wire (lane*8 + bit, LSB first,
// then the PMAX invert lines) in each window of W global flit rows, and
// each wire's valid rows at level 1.
//
// Replaces the TPU kernel's mode (d) (num_windows > 0: _axes_block's
// per-block (NW, WIRES) slabs for both bus-invert branches, a float32
// one-hot product per window scatter) and its fold (_fold_axes: the window
// scatter of block-boundary toggles, the per-partition branch select, the
// transition parity against the carried entry parity).  Here the slabs
// would be quadratic in the stream (every block a full NW x WIRES slab),
// so the design is a rerun instead (launch entry repro_bt_axes_activity):
//   * bt_axes_kernel as above, which also writes each transition config's
//     block data parity per lane (XOR of its valid rows);
//   * bt_axes_fold_kernel as above, which also records per (link, block,
//     config) the state the block is entered in: the previous wire flit
//     (for transition: the entry parity of every wire, the carried parity
//     prefix-XORed with the earlier blocks' parities), each partition's
//     bus-invert entry branch and previous invert state, and whether the
//     boundary into the block's first row counts; it carries the parity;
//   * bt_axes_activity_kernel, one block per (link, packet block,
//     ordering) — the orderings on the grid's y axis, as a short stream
//     has few packet blocks — stages and lays the block out again as
//     bt_axes_kernel does (build_image), then counts all configs of the
//     ordering at once.  Bus-invert states are built by the whole
//     block: every warp ballots [2 HD > half] and [2 HD == half] for 32
//     rows of one (partition, step) cell, HD from word XOR-popcounts, for
//     every partition of every bus-invert config of the ordering; one
//     warp per partition then scans its steps' state maps (a tie forces 0,
//     HD > half flips) for the state entering each step and derives the
//     step's 32 row states as one word from its two ballots (a prefix XOR
//     with resets, by shifts).  All (config, column) pairs are
//     then dealt to the warps at once: a column is one 32-bit word of the
//     flit row (32 wires) or of a config's invert lines, walked 32 rows a
//     step, one row a lane.  Per row the wire levels are the coded word
//     (for 'transition' the entry parity XOR a warp prefix XOR of the data
//     words; for bus-invert the data XOR the row-state bytes) and the
//     toggles that word XOR the row before it (a shuffle from the lane
//     below; the block's entry state for row 0).  Both are counted per
//     wire in bit-sliced SWAR counters (nibble fields spilled to bytes)
//     and summed over the warp by a reduce-scatter when a window closes,
//     so each lane adds one wire's count with one atomicAdd per (wire,
//     window); walks of a few steps, and steps that cross a window edge,
//     transpose the step's 32 x 32 bits instead and count per window span.
//     Integer adds commute, so the result is exact in any block order; no
//     float arithmetic touches a count.
// Memory: the result plus O(L * G * C * (lanes + 2 PMAX)) bytes of entry
// state.  Bound on this card: integer operations (a few per valid row x
// wire x config) at the scale shapes; the result's bytes (written once by
// the zero fill, then by atomics) for short windows.  What the kernel
// spends is latency: the layout (the same per ordering as bt_axes_kernel's)
// and the column walks, each a chain of dependent shared-memory loads,
// shuffles and adds over its block's rows.
#include "common.cuh"
#include "plan.h"

namespace repro {

constexpr int MAX_ROW_WORDS = 512;  // 32-bit words of a flit row (lanes <= 2 * MAX_N)
constexpr int BI_BATCH = 24;  // bus-invert (config, partition) items walked between barriers
// activity mode: (bus-invert item, 32-row step) cells a batch holds at least,
// and the dynamic shared memory a launch takes without opting in to more
constexpr int ACT_CELLS = 512;
constexpr int SHORT_WALK = 4;  // 32-row steps up to which a column walk transposes
constexpr size_t ACT_SMEM_DEFAULT = 40 * 1024;

enum { CODEC_NONE = 0, CODEC_GRAY = 1, CODEC_SM = 2, CODEC_TRANSITION = 3, CODEC_BI = 4 };
constexpr int COL_INVERT = 5;  // activity mode: a column of bus-invert lines
enum { KEY_NONE = 0, KEY_COLUMN_MAJOR = 1, KEY_ACC = 2, KEY_APP = 3 };

// The stateless byte maps of repro/core/coding.py on one wire byte (the
// other schemes drive the data byte itself).
__device__ __forceinline__ unsigned code_byte(unsigned v, int codec) {
  if (codec == CODEC_GRAY) return (v ^ (v >> 1)) & 0xFFu;
  if (codec == CODEC_SM && v >= 0x80u) return 0x80u | (((0x100u - v) & 0xFFu) & 0x7Fu);
  return v;
}

// Bytes [lo, hi) of a 32-bit word as a bit mask (bounds clamped to [0, 4]).
__device__ __forceinline__ unsigned byte_span(int lo, int hi) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > 4 ? 4 : hi;
  if (hi <= lo) return 0u;
  const unsigned up = hi == 4 ? FULL : ((1u << (8 * hi)) - 1u);
  return up & ~((1u << (8 * lo)) - 1u);
}

// code_byte's sign-magnitude map on the four bytes of a word at once.
__device__ __forceinline__ unsigned sm_word(unsigned v) {
  const unsigned sel = ((v & 0x80808080u) >> 7) * 0xFFu;  // bytes >= 0x80
  const unsigned mag = ((~v & 0x7F7F7F7Fu) + 0x01010101u) & 0x7F7F7F7Fu;
  return (v & ~sel) | ((mag | 0x80808080u) & sel);
}

// Layout of the per-(block, config) outputs; `cell` = block * C + config.
__device__ __forceinline__ long long part_at(long long cell, int b, int q, int pmax) {
  return ((cell * 2 + b) * pmax + q) * 3;
}
__device__ __forceinline__ long long edge_at(long long cell, int b, int last, int lanes) {
  return ((cell * 2 + b) * 2 + last) * lanes;
}
__device__ __forceinline__ long long inv_at(long long cell, int b, int last, int pmax) {
  return ((cell * 2 + b) * 2 + last) * pmax;
}

// Compose two bus-invert state maps, `m` after `e`.  A map is encoded as
// bit x = the state after entry state x: 0b00 tie (forced 0), 0b01 flip,
// 0b10 keep, 0b11 forced 1.
__device__ __forceinline__ unsigned compose(unsigned m, unsigned e) {
  return ((m >> (e & 1u)) & 1u) | (((m >> ((e >> 1) & 1u)) & 1u) << 1);
}

// This warp's segment of the block's boundary rows for partition q of a
// bus-invert config (lanes [q*pw, (q+1)*pw) of the (vr, lw)-word image).
// Row t's invert state is v_t = tie_t ? 0 : (h_t ? !v_{t-1} : v_{t-1}) with
// h_t = [2 HD_t > 8 pw], tie_t = [2 HD_t == 8 pw] and HD_t the data Hamming
// distance of the partition between rows t-1 and t (word XOR-popcounts).
// The rows 1 .. vr-1 are cut into WARPS segments of whole 32-row steps;
// each lane takes one row of a step, and with H and T the step's ballots of
// h and tie, the state before a lane's row is the parity of H since the
// step's last tie before it, or (no tie yet) the state entering the step
// XOR that parity — no shuffle chain; the row flips the state iff
// tie ? v_{t-1} : h.  Entered in state 1 instead of 0 the segment's states
// are complements up to its first tie and equal from there, so the two
// entries' flips differ only at that row: the walk follows entry 0 and
// keeps that row's difference.  It writes out[0] bit x = the state after
// the segment entered in state x, and out[1 + 3x + k] the segment's
// (input, weight, invert-line) flips.
__device__ void bus_invert_segment(const unsigned* img32, int lw, int vr, int split, int pw,
                                   int q, unsigned* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = ((vr - 1 + WARPS - 1) / WARPS + 31) & ~31;
  const int r0 = 1 + warp * seg;
  const int r1 = r0 + seg < vr ? r0 + seg : vr;
  const int j0 = q * pw;
  const int n_in = split - j0 < 0 ? 0 : (split - j0 > pw ? pw : split - j0);
  const unsigned lbits = 8u * pw;
  const int wa = j0 >> 2, wb = (j0 + pw + 3) >> 2;  // the words the partition touches
  // the input-side and weight-side bytes of the partition in its first
  // NEAR words, once (a partition of up to 13 lanes touches at most 4)
  constexpr int NEAR = 4;
  unsigned m_in[NEAR], m_wg[NEAR];
#pragma unroll
  for (int k = 0; k < NEAR; ++k) {
    const int wi = wa + k;
    const unsigned pm = byte_span(j0 - 4 * wi, j0 + pw - 4 * wi);
    const unsigned im = byte_span(0, split - 4 * wi);
    m_in[k] = pm & im;
    m_wg[k] = pm & ~im;
  }
  const unsigned before = (1u << lane) - 1u;  // the step's rows before this lane's
  unsigned v = 0u;      // entry 0: the state before the step
  int tied = -1;        // the lane of the segment's first tie, once met
  unsigned acc[3] = {0u, 0u, 0u}, diff[3] = {0u, 0u, 0u};  // entry 0; entry 1 - entry 0
  for (int base = r0; base < r1; base += 32) {
    const int t = base + lane;
    const bool active = t < r1;
    unsigned s_in = 0, s_wg = 0;
    if (active) {
      const unsigned* cur = img32 + t * lw;
#pragma unroll
      for (int k = 0; k < NEAR; ++k) {
        if (wa + k < wb) {
          const unsigned d = cur[wa + k] ^ cur[wa + k - lw];
          s_in += __popc(d & m_in[k]);
          s_wg += __popc(d & m_wg[k]);
        }
      }
      for (int wi = wa + NEAR; wi < wb; ++wi) {
        const unsigned d = (cur[wi] ^ cur[wi - lw]) & byte_span(j0 - 4 * wi, j0 + pw - 4 * wi);
        const unsigned im = byte_span(0, split - 4 * wi);
        s_in += __popc(d & im);
        s_wg += __popc(d & ~im);
      }
    }
    const unsigned hd2 = 2u * (s_in + s_wg);
    const bool h = active && hd2 > lbits, tie = active && hd2 == lbits;
    // rows past the segment are neither: they keep the state
    const unsigned H = __ballot_sync(FULL, h);
    const unsigned T = __ballot_sync(FULL, tie);
    // the state after the rows of `mask` (a prefix of the step), from the
    // state entering the step
    auto state = [&](unsigned mask) {
      const unsigned tm = T & mask;
      const unsigned since = tm ? mask & ~(FULL >> __clz(tm)) : mask;  // rows after the last tie
      return (__popc(H & since) & 1u) ^ (tm ? 0u : v);
    };
    const unsigned flip = tie ? state(before) : (unsigned)h;  // v_t ^ v_{t-1}
    const unsigned c_in = flip ? 8u * n_in - s_in : s_in;
    const unsigned c_wg = flip ? 8u * (pw - n_in) - s_wg : s_wg;
    if (active) {
      acc[0] += c_in;
      acc[1] += c_wg;
      acc[2] += flip;
    }
    if (tied < 0 && T) {  // the segment's first tie: entry 1 flips the other way there
      tied = __ffs(T) - 1;
      if (lane == tied) {
        diff[0] = (flip ? s_in : 8u * n_in - s_in) - c_in;
        diff[1] = (flip ? s_wg : 8u * (pw - n_in) - s_wg) - c_wg;
        diff[2] = (flip ? 0u : 1u) - flip;
      }
    }
    v = state(FULL);
  }
  for (int k = 0; k < 3; ++k) {
    acc[k] = warp_sum(acc[k]);
    diff[k] = __shfl_sync(FULL, diff[k], tied < 0 ? 0 : tied);  // zero without a tie
  }
  if (lane == 0) {
    out[0] = v | ((tied >= 0 ? v : v ^ 1u) << 1);
    for (int k = 0; k < 3; ++k) {
      out[1 + k] = acc[k];
      out[4 + k] = acc[k] + diff[k];
    }
  }
}

// Copy `len` bytes from device memory into 16-byte aligned shared memory
// with the whole block: 16-byte loads when the source is aligned.
__device__ __forceinline__ void stage_bytes(unsigned char* dst, const unsigned char* src,
                                            int len) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = len & ~15;
    for (int i = threadIdx.x; i < (len >> 4); i += THREADS)
      reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  }
  for (int i = done + threadIdx.x; i < len; i += THREADS) dst[i] = src[i];
}

// Lay the block's vp valid packets (rows of n elements from x and, paired,
// w) out under one ordering as the (vp * flits, stride) flit image in
// shared memory: per packet one warp, the counting-sort rank of psu_stream
// ('acc' / 'app') or the fixed 'none' / 'column_major' slots, each byte
// scattered to its cell.
template <typename T>
__device__ void lay_out(const T* x, const T* w, int vp, int n, int il, int wl, int flits,
                        int stride, int pack_row, int key, const KeySpec& s,
                        unsigned (*bal)[BAL_WORDS], unsigned char* img) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const FastDiv div = make_fast_div(pack_row ? il : flits);
  const FastDiv div_il = make_fast_div(il);
  with_key_bits(key >= KEY_ACC ? s.bits : 0, [&](auto kb) {
  constexpr int BITS = decltype(kb)::value;
  for (int pk = warp; pk < vp; pk += WARPS) {
    const T* xr = x + pk * n;
    const T* wr = wl ? w + pk * n : nullptr;
    unsigned char* pimg = img + pk * flits * stride;
    auto place = [&](int i, int r) {
      int f, c;
      if (pack_row) {
        f = (int)fast_div(r, div);
        c = r - f * il;
      } else {
        c = (int)fast_div(r, div);
        f = r - c * flits;
      }
      unsigned char* cell = pimg + f * stride + c;
      cell[0] = (unsigned char)xr[i];
      if (wl) cell[il] = (unsigned char)wr[i];
    };
    if (key >= KEY_ACC) {
      warp_rank_row<BITS>(n, s.nb, bal[warp], [&](int i) { return psu_key((unsigned)xr[i], s); },
                          place);
    } else {
      for (int i = lane; i < n; i += 32) {
        // column-major: slot l*F + f carries element f*L + l
        const int f0 = (int)fast_div(i, div_il);
        place(i, key == KEY_COLUMN_MAJOR ? (i - f0 * il) * flits + f0 : i);
      }
    }
  }
  });
}

// The block's vp valid packets (at x + off and, paired, w + off) laid out
// under one ordering as the (vp * flits, lw)-word image in shared memory,
// rows padded with zero bytes (which code to 0) to the odd word count lw:
// the pad words are zeroed first (the layout then writes the lanes' bytes
// over them), and byte packets are staged in shared memory with 16-byte
// loads, so the layout's scattered reads wait on one load instead of one a
// packet.  Every thread calls it; it ends with a barrier.
template <typename T>
__device__ void build_image(const T* x, const T* w, long long off, int vp, int n, int il,
                            int wl, int flits, int lanes, int lw, int bpk, int pack_row,
                            int key, const KeySpec& s, unsigned (*bal)[BAL_WORDS],
                            unsigned char* img) {
  const int vr = vp * flits;
  unsigned* img_w = reinterpret_cast<unsigned*>(img);
  for (int t = threadIdx.x; t < vr; t += THREADS)
    for (int wi = lanes >> 2; wi < lw; ++wi) img_w[t * lw + wi] = 0u;
  const T* xb = x + off;
  const T* wb = wl ? w + off : nullptr;
  if (sizeof(T) == 1) {
    unsigned char* raw = img + image_words_bytes(bpk, flits, lanes);
    stage_bytes(raw, reinterpret_cast<const unsigned char*>(xb), vp * n);
    xb = reinterpret_cast<const T*>(raw);
    if (wl) {  // the weights' copy starts 16-byte aligned too
      unsigned char* wraw = raw + ((vp * n + 15) & ~15);
      stage_bytes(wraw, reinterpret_cast<const unsigned char*>(wb), vp * n);
      wb = reinterpret_cast<const T*>(wraw);
    }
  }
  __syncthreads();
  lay_out(xb, wb, vp, n, il, wl, flits, lw * 4, pack_row, key, s, bal, img);
  __syncthreads();
}

// tab: O orderings as (key, k, descending), then C configs as (ordering,
// codec, partitions, lanes per partition), then per ordering a record
// (stateless codec bits, offset and count of its stateless configs, offset
// and count of its bus-invert items) and the lists the records point to:
// config indices, and (config, partition) pairs.  One block per (link, packet
// block) and ordering, the ordering varying fastest along the grid so that
// the blocks that read the same packets run side by side (the second and
// later reads come from L2).  The image rows are padded with zero bytes
// (which code to 0) to an odd number lw of 32-bit words, ls = 4 lw bytes,
// so the bus-invert walk's one row a lane reads without bank conflicts.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bt_axes_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ valid, long long P, int n, int width, int il,
               int wl, int split, int pack_row, int bpk, int G,
               const int* __restrict__ tab, int O, int C, int pmax,
               int* __restrict__ part, uint8_t* __restrict__ edge,
               uint8_t* __restrict__ inv, uint8_t* __restrict__ bpar) {
  extern __shared__ uint4 smem_axes[];
  unsigned char* img = reinterpret_cast<unsigned char*>(smem_axes);
  __shared__ unsigned bal[WARPS][BAL_WORDS];
  __shared__ unsigned red[WARPS][8];
  __shared__ unsigned tot[8];
  __shared__ unsigned segs[BI_BATCH][WARPS][7];
  __shared__ unsigned fins[BI_BATCH];
  __shared__ unsigned parw[MAX_ROW_WORDS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned bk = blockIdx.x / (unsigned)O;  // (link, packet block)
  const int o = (int)(blockIdx.x - bk * O);
  const long long blk = bk;
  const long long l = bk / (unsigned)G;
  const int g = (int)(bk - (unsigned)l * G);
  const int lanes = il + wl;
  const int lw = ((lanes + 3) >> 2) | 1;  // an odd word count: a lane per row is conflict-free
  const int ls = lw * 4;
  const int flits = n / il;
  const long long p_lo = (long long)g * bpk;
  const long long left = (long long)valid[l] - p_lo;
  // a block holding none of the link's valid packets is never read by the fold
  if (left <= 0) return;
  const int vp = left < bpk ? (int)left : bpk;
  const int vr = vp * flits;
  const int* cfgs = tab + 3 * O;
  // this ordering's record: its stateless codecs (one bit each), its
  // stateless configs and its bus-invert (config, partition) items
  const int* rec = cfgs + 4 * C + 5 * o;
  const unsigned need = (unsigned)rec[0];
  const int* stateless = tab + rec[1];
  const int n_stateless = rec[2];
  const int* items = tab + rec[3];
  const int n_items = rec[4];
  const bool par = bpar && (need & (1u << CODEC_TRANSITION));

  const int key = tab[3 * o];
  const KeySpec s = make_key_spec(width, key == KEY_APP ? tab[3 * o + 1] : 0, tab[3 * o + 2]);
  // the same staging and layout as build_image, written out: calling it
  // here measured slower at the scale batch, force-inlined or not
  unsigned* img_w = reinterpret_cast<unsigned*>(img);
  for (int t = threadIdx.x; t < vr; t += THREADS)
    for (int wi = lanes >> 2; wi < lw; ++wi) img_w[t * lw + wi] = 0u;
  if (par)
    for (int i = threadIdx.x; i < lw; i += THREADS) parw[i] = 0;
  const long long off = ((long long)l * P + p_lo) * n;
  const T* xb = x + off;
  const T* wb = wl ? w + off : nullptr;
  if (sizeof(T) == 1) {
    unsigned char* raw = img + ((bpk * flits * ls + 15) & ~15);
    stage_bytes(raw, reinterpret_cast<const unsigned char*>(xb), vp * n);
    xb = reinterpret_cast<const T*>(raw);
    if (wl) {  // the weights' copy starts 16-byte aligned too
      unsigned char* wraw = raw + ((vp * n + 15) & ~15);
      stage_bytes(wraw, reinterpret_cast<const unsigned char*>(wb), vp * n);
      wb = reinterpret_cast<const T*>(wraw);
    }
  }
  __syncthreads();
  lay_out(xb, wb, vp, n, il, wl, flits, ls, pack_row, key, s, bal, img);
  __syncthreads();
  const unsigned* img32 = reinterpret_cast<const unsigned*>(img);

  // every stateless codec of the ordering in one pass over the words:
  // thread -> (first row, word column), THREADS / lw rows per step; a row
  // wider than the block gives each thread whole word columns
  if (need) {
    unsigned acc[4][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}, {0u, 0u}};
    const bool wide = lw > THREADS;
    const int rstep = wide ? 1 : THREADS / lw;
    const int t0 = wide ? 0 : threadIdx.x / lw;
    if (t0 < rstep) {
      for (int wc = wide ? threadIdx.x : threadIdx.x - t0 * lw; wc < lw; wc += THREADS) {
        const unsigned im = byte_span(0, split - 4 * wc);  // input-side bytes
        unsigned px = 0;
        for (int t = t0; t < vr; t += rstep) {
          const unsigned cur = img32[t * lw + wc];
          px ^= cur;
          if (t == 0) continue;
          const unsigned prev = img32[(t - 1) * lw + wc];
          const unsigned d = cur ^ prev;
          if (need & (1u << CODEC_NONE)) {
            acc[CODEC_NONE][0] += __popc(d & im);
            acc[CODEC_NONE][1] += __popc(d & ~im);
          }
          if (need & (1u << CODEC_GRAY)) {  // gray(a) ^ gray(b) = gray(a ^ b)
            const unsigned e = d ^ ((d >> 1) & 0x7F7F7F7Fu);
            acc[CODEC_GRAY][0] += __popc(e & im);
            acc[CODEC_GRAY][1] += __popc(e & ~im);
          }
          if (need & (1u << CODEC_SM)) {
            const unsigned e = sm_word(cur) ^ sm_word(prev);
            acc[CODEC_SM][0] += __popc(e & im);
            acc[CODEC_SM][1] += __popc(e & ~im);
          }
          if (need & (1u << CODEC_TRANSITION)) {  // the wire toggles where the data is 1
            acc[CODEC_TRANSITION][0] += __popc(cur & im);
            acc[CODEC_TRANSITION][1] += __popc(cur & ~im);
          }
        }
        // activity mode: the block's data parity per lane (transition's wire
        // levels are the running parity, prefix-XORed by the fold)
        if (par) atomicXor(&parw[wc], px);
      }
    }
    for (int k = 0; k < 8; ++k) {
      if (!((need >> (k >> 1)) & 1u)) continue;  // a codec the ordering does not use
      const unsigned v = warp_sum(acc[k >> 1][k & 1]);
      if (lane == 0) red[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < 8) {
      unsigned v = 0;
      for (int i = 0; i < WARPS; ++i) v += red[i][threadIdx.x];
      tot[threadIdx.x] = v;
    }
    __syncthreads();
    for (int k = 0; k < n_stateless; ++k) {
      const int c = stateless[k];
      const int codec = cfgs[4 * c + 1];
      const long long cell = blk * C + c;
      if (threadIdx.x == 0) {
        int* pp = part + part_at(cell, 0, 0, pmax);
        pp[0] = (int)tot[2 * codec];
        pp[1] = (int)tot[2 * codec + 1];
        pp[2] = 0;
      }
      for (int j = threadIdx.x; j < lanes; j += THREADS) {
        edge[edge_at(cell, 0, 0, lanes) + j] = (uint8_t)code_byte(img[j], codec);
        edge[edge_at(cell, 0, 1, lanes) + j] = (uint8_t)code_byte(img[(vr - 1) * ls + j], codec);
        if (par && codec == CODEC_TRANSITION)
          bpar[cell * lanes + j] = (uint8_t)(parw[j >> 2] >> (8 * (j & 3)));
      }
    }
  }

  // bus-invert: every warp walks its row segment of each (config,
  // partition) item of the ordering, BI_BATCH items between barriers; then
  // one thread per item composes the eight segment maps for both entry
  // branches, and the block writes the items' edge flits
  for (int first = 0; first < n_items; first += BI_BATCH) {
    const int batch = n_items - first < BI_BATCH ? n_items - first : BI_BATCH;
    for (int k = 0; k < batch; ++k) {
      const int c = items[2 * (first + k)], q = items[2 * (first + k) + 1];
      bus_invert_segment(img32, lw, vr, split, cfgs[4 * c + 3], q, segs[k][warp]);
    }
    __syncthreads();
    if ((int)threadIdx.x < batch) {
      const int c = items[2 * (first + threadIdx.x)], q = items[2 * (first + threadIdx.x) + 1];
      const unsigned (*sg)[7] = segs[threadIdx.x];
      const long long cell = blk * C + c;
      unsigned fin = 0;  // bit b: the state of the block's last row under entry branch b
      for (int b = 0; b < 2; ++b) {
        unsigned a[3] = {0u, 0u, 0u}, e = (unsigned)b;
        for (int k = 0; k < WARPS; ++k) {
          for (int i = 0; i < 3; ++i) a[i] += sg[k][1 + 3 * e + i];
          e = (sg[k][0] >> e) & 1u;
        }
        int* pp = part + part_at(cell, b, q, pmax);
        pp[0] = (int)a[0];
        pp[1] = (int)a[1];
        pp[2] = (int)a[2];
        inv[inv_at(cell, b, 0, pmax) + q] = (uint8_t)b;
        inv[inv_at(cell, b, 1, pmax) + q] = (uint8_t)e;
        fin |= e << b;
      }
      fins[threadIdx.x] = fin;
    }
    __syncthreads();
    for (int k = 0; k < batch; ++k) {
      const int c = items[2 * (first + k)], q = items[2 * (first + k) + 1];
      const int pw = cfgs[4 * c + 3];
      const long long cell = blk * C + c;
      const unsigned fin = fins[k];
      for (int jj = threadIdx.x; jj < pw; jj += THREADS) {
        const int j = q * pw + jj;
        const unsigned v0 = img[j], v1 = img[(vr - 1) * ls + j];
        for (int b = 0; b < 2; ++b) {
          edge[edge_at(cell, b, 0, lanes) + j] = (uint8_t)(v0 ^ (b ? 0xFFu : 0u));
          edge[edge_at(cell, b, 1, lanes) + j] = (uint8_t)(v1 ^ ((fin >> b) & 1u ? 0xFFu : 0u));
        }
      }
    }
  }
}

// One warp per (link, config, partition): the fold over the link's valid
// blocks that _fold_axes does in order, here across the warp's lanes, one
// block per lane, 32 blocks per step.  wire / invc hold the carry (last
// wire flit per lane, last invert state per partition) and are updated in
// place; the totals are added with atomics (unsigned: wraps like the int32
// sums).  Stateless codecs: each lane adds its blocks' partials and the
// boundary flips into them from the previous block's last wire flit (the
// carried flit for block 0; none on a cold start).  Bus-invert: block g's
// entry branch is a map of block g-1's — bit x = [2 HD > 8 pw] between g's
// first data flit and g-1's last wire flit under branch x; block 0's is a
// constant from the carried flit, 0 on a cold start — so an inclusive warp
// scan of those maps gives every block's branch, and each lane then adds
// the partials of its block's branch and the boundary into it.
// With `ent` (activity mode) it also records each block's entry state
// (see the entry-state layout below) and threads `parity`, each wire's
// transition level as 0/1 per wire (C, L, lanes*8), through the block
// parities `bpar` by a warp XOR scan.
__global__ void __launch_bounds__(THREADS)
bt_axes_fold_kernel(const int* __restrict__ valid, long long L, int bpk, int G, int lanes,
                    int split, const int* __restrict__ tab, int O, int C, int pmax,
                    const int* __restrict__ part, const uint8_t* __restrict__ edge,
                    const uint8_t* __restrict__ inv, const int* __restrict__ started_in,
                    int* __restrict__ started_out, int* wire, int* invc, unsigned* totals,
                    const uint8_t* __restrict__ bpar, uint8_t* ent, int es, int* parity) {
  const int lane = threadIdx.x & 31;
  const long long idx = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (idx >= L * C * pmax) return;  // whole warps
  const int q = (int)(idx % pmax);
  const int c = (int)((idx / pmax) % C);
  const long long l = idx / ((long long)pmax * C);
  const int* cf = tab + 3 * O + 4 * c;
  const int codec = cf[1], npart = cf[2], pw = cf[3];
  const int v = valid[l];
  const int st0 = started_in[l] != 0;
  if (c == 0 && q == 0 && lane == 0) started_out[l] = (st0 || v > 0) ? 1 : 0;
  if (codec == CODEC_BI ? q >= npart : q > 0) return;
  const int nblk = v > 0 ? (v + bpk - 1) / bpk : 0;
  int* cw = wire + ((long long)c * L + l) * lanes;
  unsigned t_in = 0, t_wg = 0, t_aux = 0;
  if (codec != CODEC_BI) {
    for (int g = lane; g < nblk; g += 32) {
      const long long cell = (l * G + g) * C + c;
      const int* pp = part + part_at(cell, 0, 0, pmax);
      t_in += (unsigned)pp[0];
      t_wg += (unsigned)pp[1];
      const uint8_t* first = edge + edge_at(cell, 0, 0, lanes);
      const uint8_t* prev = g > 0 ? edge + edge_at(cell - C, 0, 1, lanes) : nullptr;
      if (ent) {
        uint8_t* e = ent + cell * es;
        if (codec != CODEC_TRANSITION)  // the wire flit before the block
          for (int j = 0; j < lanes; ++j) e[j] = prev ? prev[j] : (uint8_t)cw[j];
        e[lanes + 2 * pmax] = (uint8_t)(g > 0 || st0);
      }
      if (g == 0 && !st0) continue;  // no boundary into the first flit ever sent
      for (int j = 0; j < lanes; ++j) {
        const unsigned before = prev ? prev[j] : (unsigned)cw[j];
        const unsigned f = codec == CODEC_TRANSITION ? __popc((unsigned)first[j])
                                                     : __popc((first[j] ^ before) & 0xFFu);
        if (j < split) t_in += f; else t_wg += f;
      }
    }
    if (ent && codec == CODEC_TRANSITION) {
      // each block's entry parity: the carried parity XOR the earlier
      // blocks' data parities (an exclusive XOR scan per lane byte)
      int* par = parity + ((long long)c * L + l) * lanes * 8;
      for (int j = 0; j < lanes; ++j) {
        unsigned carry = 0;
        for (int k = 0; k < 8; ++k) carry |= (unsigned)(par[j * 8 + k] & 1) << k;
        for (int g0 = 0; g0 < nblk; g0 += 32) {
          const int g = g0 + lane;
          const long long cell = (l * G + g) * C + c;
          const unsigned b = g < nblk ? bpar[cell * lanes + j] : 0u;
          unsigned incl = b;
          for (int o = 1; o < 32; o <<= 1) {
            const unsigned u = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl ^= u;
          }
          if (g < nblk) ent[cell * es + j] = (uint8_t)(carry ^ incl ^ b);
          carry ^= __shfl_sync(FULL, incl, 31);
        }
        __syncwarp();
        if (lane < 8) par[j * 8 + lane] = (carry >> lane) & 1u;
      }
    }
    __syncwarp();  // every lane has read the carried flit
    if (nblk > 0) {
      const uint8_t* last = edge + edge_at((l * G + nblk - 1) * C + c, 0, 1, lanes);
      for (int j = lane; j < lanes; j += 32) cw[j] = last[j];
    }
  } else {
    const int j0 = q * pw;
    int* civ = invc + ((long long)c * L + l) * pmax + q;
    const int iv0 = *civ;
    const unsigned lbits = 8u * pw;
    unsigned bcar = 0;  // the branch of the block before this step
    for (int g0 = 0; g0 < nblk; g0 += 32) {
      const int g = g0 + lane;
      const bool in = g < nblk;
      const long long cell = (l * G + g) * C + c;
      const uint8_t* first = edge + edge_at(cell, 0, 0, lanes) + j0;  // = the data flit
      unsigned m = 2u;  // lanes past the last block keep the branch
      if (in && g == 0) {
        unsigned hd = 0;
        for (int jj = 0; jj < pw; ++jj) hd += __popc((first[jj] ^ (unsigned)cw[j0 + jj]) & 0xFFu);
        m = (st0 && 2u * hd > lbits) ? 3u : 0u;  // forced 0 on a cold start
      } else if (in) {
        m = 0u;
        for (int x = 0; x < 2; ++x) {
          const uint8_t* lw = edge + edge_at(cell - C, x, 1, lanes) + j0;
          unsigned hd = 0;
          for (int jj = 0; jj < pw; ++jj) hd += __popc((first[jj] ^ lw[jj]) & 0xFFu);
          m |= (2u * hd > lbits ? 1u : 0u) << x;
        }
      }
      for (int o = 1; o < 32; o <<= 1) {  // m := m o (maps of earlier blocks)
        const unsigned e = __shfl_up_sync(FULL, m, o);
        if (lane >= o) m = compose(m, e);
      }
      const unsigned b = (m >> bcar) & 1u;
      unsigned bp = __shfl_up_sync(FULL, b, 1);
      if (lane == 0) bp = bcar;
      if (in) {
        const uint8_t* lastw = g > 0 ? edge + edge_at(cell - C, bp, 1, lanes) + j0 : nullptr;
        const int ivp = g > 0 ? inv[inv_at(cell - C, bp, 1, pmax) + q] : iv0;
        const int st = g > 0 || st0;
        if (ent) {
          uint8_t* e = ent + cell * es;
          for (int jj = 0; jj < pw; ++jj)
            e[j0 + jj] = lastw ? lastw[jj] : (uint8_t)cw[j0 + jj];
          e[lanes + q] = (uint8_t)b;
          e[lanes + pmax + q] = (uint8_t)ivp;
          if (q == 0) e[lanes + 2 * pmax] = (uint8_t)st;
        }
        if (st) {
          for (int jj = 0; jj < pw; ++jj) {
            const unsigned before = lastw ? lastw[jj] : (unsigned)cw[j0 + jj];
            const unsigned f = __popc((before ^ first[jj] ^ (b ? 0xFFu : 0u)) & 0xFFu);
            if (j0 + jj < split) t_in += f; else t_wg += f;
          }
          t_aux += (unsigned)ivp != b;
        }
        const int* pp = part + part_at(cell, b, q, pmax);
        t_in += (unsigned)pp[0];
        t_wg += (unsigned)pp[1];
        t_aux += (unsigned)pp[2];
      }
      bcar = __shfl_sync(FULL, b, 31);
    }
    __syncwarp();  // every lane has read the carried flit and state
    if (nblk > 0) {
      const long long cl = (l * G + nblk - 1) * C + c;
      const uint8_t* lastw = edge + edge_at(cl, bcar, 1, lanes) + j0;
      for (int jj = lane; jj < pw; jj += 32) cw[j0 + jj] = lastw[jj];
      if (lane == 0) *civ = inv[inv_at(cl, bcar, 1, pmax) + q];
    }
  }
  t_in = warp_sum(t_in);
  t_wg = warp_sum(t_wg);
  t_aux = warp_sum(t_aux);
  if (lane == 0) {
    unsigned* tot = totals + (l * C + c) * 3;
    atomicAdd(tot, t_in);
    atomicAdd(tot + 1, t_wg);
    atomicAdd(tot + 2, t_aux);
  }
}

// ---- activity mode ----
//
// Entry state of one (link, block, config) cell, `es` = lanes + 2 PMAX + 1
// bytes at ent + cell * es: [0, lanes) the wire flit before the block's
// first row (for 'transition': each lane's entry parity byte, bit b = the
// level of wire lane*8 + b), [lanes, lanes + PMAX) each bus-invert
// partition's entry branch, [lanes + PMAX, lanes + 2 PMAX) its previous
// invert state, and [lanes + 2 PMAX] whether the boundary into the first
// row counts (something was sent before it).

// Per-wire counters of one lane of a warp over the rows it walks, bit-sliced
// (vertical) in SWAR fields: add(x) counts bit b of x for wire b, as nibble
// fields (wire 4f + k in nibble f of nib[k]) spilled every 15 adds into
// byte fields (wire 8m + u in byte m of byt[u]; at most 128 rows a lane, so
// a byte never overflows).  reduce() sums the 32 wires over the warp's
// lanes by a reduce-scatter of the fields (23 shuffles) and returns wire
// `lane`'s total on each lane; every lane of the warp calls it.
struct WireCounts {
  unsigned nib[4], byt[8];
  int n;
  bool any;  // an add since the last reduce (the same on every lane)

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < 4; ++k) nib[k] = 0u;
#pragma unroll
    for (int u = 0; u < 8; ++u) byt[u] = 0u;
    n = 0;
    any = false;
  }
  __device__ __forceinline__ void spill() {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      byt[k] += nib[k] & 0x0F0F0F0Fu;
      byt[4 + k] += (nib[k] >> 4) & 0x0F0F0F0Fu;
      nib[k] = 0u;
    }
    n = 0;
  }
  __device__ __forceinline__ void add(unsigned x) {
#pragma unroll
    for (int k = 0; k < 4; ++k) nib[k] += (x >> k) & 0x11111111u;
    any = true;
    if (++n == 15) spill();
  }
  __device__ __forceinline__ unsigned reduce() {
    const int lane = threadIdx.x & 31;
    spill();
    // lane bit 4 picks bytes {0, 1} or {2, 3} of each word (as 16-bit fields)
    unsigned f[8];
    const bool b4 = lane & 16;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned w = byt[u];
      const unsigned lo = (w & 0xFFu) | ((w & 0xFF00u) << 8);
      const unsigned hi = ((w >> 16) & 0xFFu) | ((w >> 8) & 0xFF0000u);
      f[u] = (b4 ? hi : lo) + __shfl_xor_sync(FULL, b4 ? lo : hi, 16);
    }
    // lane bit 3 picks the field: c[u] is wire 8 * (lane >> 3) + u
    unsigned c[8];
    const bool b3 = lane & 8;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned lo = f[u] & 0xFFFFu, hi = f[u] >> 16;
      c[u] = (b3 ? hi : lo) + __shfl_xor_sync(FULL, b3 ? lo : hi, 8);
    }
    // lane bits 2, 1, 0 pick u
#pragma unroll
    for (int h = 4; h >= 1; h >>= 1) {
      const bool b = lane & h;
#pragma unroll
      for (int i = 0; i < h; ++i)
        c[i] = (b ? c[h + i] : c[i]) + __shfl_xor_sync(FULL, b ? c[i] : c[h + i], h);
    }
    clear();
    return c[0];
  }
};

// Lane i's bit b -> lane b's bit i, across the warp (a 32 x 32 bit
// transpose: five exchanges of off-diagonal blocks).
__device__ __forceinline__ unsigned transpose32(unsigned x) {
  const int lane = threadIdx.x & 31;
  const unsigned lo_masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int j = 16 >> k;
    const unsigned mlo = lo_masks[k];
    const unsigned y = __shfl_xor_sync(FULL, x, j);
    x = (lane & j) ? ((x & ~mlo) | ((y >> j) & mlo)) : ((x & mlo) | ((y << j) & ~mlo));
  }
  return x;
}

// The invert states of a 32-row step (bit i: row i) from its ballots H =
// [2 HD > half] and T = [2 HD == half] and the state v entering it: a tie
// forces 0, HD > half flips, so row i's state is the XOR of H over the rows
// after the last tie up to i, or v XOR that over rows 0..i with no tie yet.
// P is the prefix XOR of H, F carries P's value at each tie forward to the
// next tie, and R marks the rows with a tie at or before them.
__device__ __forceinline__ unsigned row_states(unsigned H, unsigned T, unsigned v) {
  unsigned P = H, R = T, D = T;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    P ^= P << s;
    R |= R << s;
  }
  unsigned F = P & T;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    F |= (F << s) & ~D;
    D |= D << s;
  }
  return ((P ^ F) & R) | ((P ^ (0u - v)) & ~R);
}

// One bus-invert (item, step) cell: the ballots of its 32 rows' [2 HD >
// half] and [2 HD == half], and the rows' states (bit i: row i).
struct InvCell {
  unsigned h, t, s;
};
constexpr int INV_CELL_BYTES = 12;
static_assert(sizeof(InvCell) == INV_CELL_BYTES, "act_smem's cell size");

// One warp walks one activity column of the block: data word j of config c
// (wires 32 j .. 32 j + 31, four lanes) or, for bus-invert, word j of its
// invert lines (wires lanes*8 + 32 j + b, bit b = partition 32 j + b), 32
// rows a step, one row a lane.  Per row it forms the word of wire levels
// (the coded data, the parity prefix for 'transition', the invert states)
// and the word of toggles at the boundary into the row (the previous row's
// word from the lane below, the block's entry state for row 0), and counts
// both per wire in WireCounts.  A step inside one window only adds; the
// toggles are reduced when the window closes and added with one atomicAdd
// per (wire, window).  A step that crosses a window edge (W < 32, or rows
// not aligned to it), and every step of a walk of at most SHORT_WALK steps
// (where the reductions would cost more than the steps), is transposed so
// that lane b holds wire b's 32 rows, counted per window span.  cells: the
// config's bus-invert cells, partition q's at cells + q * steps.
template <int COL>
__device__ void activity_column(const unsigned* img32, int lw, int vr, int lanes, int pmax,
                                int npart, int pw, int j, const uint8_t* e,
                                const InvCell* cells, int steps, long long row0, int W,
                                int nwires, unsigned* tog_out, unsigned* ones_out) {
  constexpr bool INV = COL == COL_INVERT;
  const int lane = threadIdx.x & 31;
  const bool st = e[lanes + 2 * pmax] != 0;
  int wire0, nb = 0;
  unsigned vmask, carry = 0u;  // carry: the word of the row before the step
  if (INV) {
    wire0 = lanes * 8 + 32 * j;
    nb = npart - 32 * j < 32 ? npart - 32 * j : 32;
    vmask = nb == 32 ? FULL : (1u << nb) - 1u;
    for (int b = 0; b < nb; ++b) carry |= (unsigned)(e[lanes + pmax + 32 * j + b] & 1u) << b;
  } else {
    wire0 = 32 * j;
    vmask = byte_span(0, lanes - 4 * j);
    for (int k = 0; k < 4 && 4 * j + k < lanes; ++k) carry |= (unsigned)e[4 * j + k] << (8 * k);
  }
  // bus-invert data word: the partitions of its four lanes
  const int q0 = COL == CODEC_BI ? (4 * j) / pw : 0;
  const int q3 = COL == CODEC_BI ? (4 * j + 3 < lanes ? 4 * j + 3 : lanes - 1) / pw : 0;
  // a walk of a few steps transposes each step's words (lane b then holds
  // wire b's 32 rows) instead of counting in WireCounts and reducing at the end
  const bool swar = steps > SHORT_WALK;
  WireCounts togc, lvlc;
  togc.clear();
  lvlc.clear();
  unsigned run = 0;   // wire `lane`'s toggles in window run_w, not yet added
  unsigned ones = 0;  // its rows at level 1 from transposed steps
  long long run_w = row0 / W;
  long long w_end = (run_w + 1) * W;  // the first global row past window run_w
  // every step only adds when the block's rows lie in one window
  const bool fast = swar && row0 + vr <= w_end;
  unsigned m0 = lane == 0 && !st ? 0u : FULL;  // no boundary into the first row ever sent
  const unsigned* src = img32 + lane * lw + j;
  for (int s = 0; s < steps; ++s) {
    const int t = s * 32 + lane;
    const unsigned vm = t < vr ? vmask : 0u;
    unsigned cur, tog;
    if (INV) {  // lane q holds partition q's row states: transpose them
      const int q = 32 * j + (nb == 1 ? 0 : lane);
      const unsigned rows = lane < nb || nb == 1 ? cells[q * steps + s].s : 0u;
      cur = nb == 1 ? (rows >> lane) & 1u : transpose32(rows);
    } else {
      const unsigned raw = t < vr ? src[s * 32 * lw] : 0u;
      if (COL == CODEC_TRANSITION) {
        // toggle = the data bit; level = entry parity ^ XOR of data up to t
        unsigned px = raw;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned v = __shfl_up_sync(FULL, px, o);
          if (lane >= o) px ^= v;
        }
        cur = carry ^ px;
        carry = __shfl_sync(FULL, cur, 31);
        tog = raw;
      } else if (COL == CODEC_GRAY) {
        cur = raw ^ ((raw >> 1) & 0x7F7F7F7Fu);
      } else if (COL == CODEC_SM) {
        cur = sm_word(raw);
      } else if (COL == CODEC_BI) {
        unsigned inv = 0u;
        for (int q = q0; q <= q3; ++q) {
          const unsigned v = 0u - ((cells[q * steps + s].s >> lane) & 1u);
          inv |= q0 == q3 ? v : v & byte_span(q * pw - 4 * j, (q + 1) * pw - 4 * j);
        }
        cur = raw ^ inv;
      } else {
        cur = raw;
      }
    }
    if (COL != CODEC_TRANSITION) {
      unsigned prev = __shfl_up_sync(FULL, cur, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(FULL, cur, 31);
      tog = cur ^ prev;
    }
    tog &= vm & m0;
    m0 = FULL;
    const unsigned lvl = cur & vm;
    if (fast) {
      togc.add(tog);
      lvlc.add(lvl);
      continue;
    }
    if (swar)
      lvlc.add(lvl);
    else
      ones += __popc(transpose32(lvl));
    const int nrow = vr - s * 32 < 32 ? vr - s * 32 : 32;
    const long long g0 = row0 + s * 32;  // global row of the step's first row
    if (g0 >= w_end) {  // the step opens a later window: close this one
      if (togc.any) run += togc.reduce();
      if (run) atomicAdd(tog_out + run_w * nwires + wire0 + lane, run);
      run = 0;
      while (g0 >= w_end) {
        ++run_w;
        w_end += W;
      }
    }
    if (swar && g0 + nrow <= w_end) {
      togc.add(tog);
    } else {  // a short walk, or a step across a window edge: per wire and window span
      if (togc.any) run += togc.reduce();
      const unsigned tm = transpose32(tog);
      for (int i = 0; i < nrow;) {
        if (g0 + i == w_end) {  // row i opens the next window
          if (run) atomicAdd(tog_out + run_w * nwires + wire0 + lane, run);
          run = 0;
          ++run_w;
          w_end += W;
        }
        const long long stop = w_end - g0;
        const int iend = stop < nrow ? (int)stop : nrow;
        const unsigned span = (iend >= 32 ? FULL : ((1u << iend) - 1u)) & ~((1u << i) - 1u);
        run += __popc(tm & span);
        i = iend;
      }
    }
  }
  if (togc.any) run += togc.reduce();
  if (run) atomicAdd(tog_out + run_w * nwires + wire0 + lane, run);
  if (swar) ones += lvlc.reduce();
  if (ones) atomicAdd(ones_out + wire0 + lane, ones);
}

// One block per (link, packet block) and ordering (blockIdx.y), after the
// fold has filled `ent`: the image of that ordering again (the same staging
// and layout as bt_axes_kernel), then all of its configs at once.  Bus-
// invert items are taken in batches whose (item, step) cells fit `ncells`:
// per batch every warp first ballots the [2 HD > half] / [2 HD == half]
// rows of (item, step) cells, HD from the partition's word XOR-popcounts;
// one warp per item then scans its steps' state maps for the state entering
// each step and turns it into the step's 32 row states (row_states); then
// all warps walk the columns (activity_column) of the stateless configs
// (with the first batch) and of the batch's bus-invert configs, round
// robin.  toggles (L, C, NW, nwires) and ones (L, C, nwires) are zeroed or
// hold earlier chunks' counts; base_row is the global row of this call's
// first flit row.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bt_axes_activity_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ valid, long long P, int n, int width, int il,
                        int wl, int pack_row, int bpk, int G, const int* __restrict__ tab,
                        int O, int C, int pmax, const uint8_t* __restrict__ ent, int es,
                        long long base_row, int W, int NW, unsigned* __restrict__ toggles,
                        unsigned* __restrict__ ones, int ncells) {
  extern __shared__ uint4 smem_act[];
  unsigned char* img = reinterpret_cast<unsigned char*>(smem_act);
  __shared__ unsigned bal[WARPS][BAL_WORDS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long blk = blockIdx.x;
  const long long l = blk / G;
  const int g = (int)(blk - l * G);
  const int lanes = il + wl;
  const int lw = ((lanes + 3) >> 2) | 1;
  const int flits = n / il;
  const long long p_lo = (long long)g * bpk;
  const long long left = (long long)valid[l] - p_lo;
  if (left <= 0) return;
  const int vp = left < bpk ? (int)left : bpk;
  const int vr = vp * flits;
  const int steps = (vr + 31) >> 5;
  const int words = (lanes + 3) >> 2;  // data words of a row
  const int* cfgs = tab + 3 * O;
  const int o = blockIdx.y;
  const int* rec = cfgs + 4 * C + 5 * o;
  const int* stateless = tab + rec[1];
  const int n_stateless = rec[2];
  const int* items = tab + rec[3];
  const int n_items = rec[4];
  const int nwires = lanes * 8 + pmax;
  const long long row0 = base_row + p_lo * flits;
  const int key = tab[3 * o];
  const KeySpec s = make_key_spec(width, key == KEY_APP ? tab[3 * o + 1] : 0, tab[3 * o + 2]);
  // the cells reuse the staged packets' room once the image is laid out
  InvCell* cells = reinterpret_cast<InvCell*>(img + image_words_bytes(bpk, flits, lanes));
  build_image(x, w, ((long long)l * P + p_lo) * n, vp, n, il, wl, flits, lanes, lw, bpk,
              pack_row, key, s, bal, img);
  const unsigned* img32 = reinterpret_cast<const unsigned*>(img);
  const uint8_t* ent_blk = ent + blk * C * es;

  int first = 0;  // the batch's items [first, last)
  do {
    int last = first;
    while (last < n_items) {  // whole configs while their cells fit
      const int npart = cfgs[4 * items[2 * last] + 2];
      if (last > first && (last + npart - first) * steps > ncells) break;
      last += npart;
    }
    const int nbi = last - first;
    for (int p = warp; p < nbi * steps; p += WARPS) {
      const int i = p / steps, st = p - i * steps;
      const int c = items[2 * (first + i)], q = items[2 * (first + i) + 1];
      const int pw = cfgs[4 * c + 3];
      const int t = st * 32 + lane;
      bool h = false, tie = false;
      if (t == 0) {  // row 0 is in the block's entry branch
        h = ent_blk[c * es + lanes + q] != 0;
      } else if (t < vr) {
        const int j0 = q * pw;
        const unsigned* cur = img32 + t * lw;
        unsigned hd = 0;
        if (((j0 | pw) & 3) == 0) {  // whole words
          for (int wi = j0 >> 2; wi < (j0 + pw) >> 2; ++wi) hd += __popc(cur[wi] ^ cur[wi - lw]);
        } else {
          for (int wi = j0 >> 2; wi < ((j0 + pw + 3) >> 2); ++wi)
            hd += __popc((cur[wi] ^ cur[wi - lw]) & byte_span(j0 - 4 * wi, j0 + pw - 4 * wi));
        }
        h = 2u * hd > 8u * pw;
        tie = 2u * hd == 8u * pw;
      }
      const unsigned H = __ballot_sync(FULL, h), Tb = __ballot_sync(FULL, tie);
      if (lane == 0) {
        cells[p].h = H;
        cells[p].t = Tb;
      }
    }
    __syncthreads();
    // one warp per item: the state entering each step by a warp scan of the
    // steps' state maps, 32 steps a pass, then every row's state
    for (int i = warp; i < nbi; i += WARPS) {
      unsigned v = 0u;  // the state entering the pass
      for (int base = 0; base < steps; base += 32) {
        const int st = base + lane;
        InvCell* cl = cells + i * steps + (st < steps ? st : 0);
        const unsigned H = st < steps ? cl->h : 0u, Tb = st < steps ? cl->t : 0u;
        // bit x: the state after the step entered in state x (a tie fixes it)
        unsigned m = Tb ? ((__popc(H & ~(FULL >> __clz(Tb))) & 1u) ? 3u : 0u)
                        : ((__popc(H) & 1u) ? 1u : 2u);
        for (int o = 1; o < 32; o <<= 1) {  // m := m o (maps of earlier steps)
          const unsigned e = __shfl_up_sync(FULL, m, o);
          if (lane >= o) m = compose(m, e);
        }
        const unsigned before = __shfl_up_sync(FULL, m, 1);
        const unsigned vin = lane == 0 ? v : (before >> v) & 1u;
        if (st < steps) cl->s = row_states(H, Tb, vin);
        v = (__shfl_sync(FULL, m, 31) >> v) & 1u;
      }
    }
    __syncthreads();
    // the columns of this round, dealt to the warps in turn: the stateless
    // configs' (with the first batch), then each bus-invert config's data
    // words and invert-line words
    const int n_sl = first == 0 ? n_stateless * words : 0;
    int ntask = n_sl;
    for (int i = first; i < last; i += cfgs[4 * items[2 * i] + 2])
      ntask += words + ((cfgs[4 * items[2 * i] + 2] + 31) >> 5);
    for (int task = warp; task < ntask; task += WARPS) {
      int c, j, col;
      const InvCell* cl = nullptr;
      if (task < n_sl) {
        c = stateless[task / words];
        j = task - (task / words) * words;
        col = cfgs[4 * c + 1];
      } else {
        int r = task - n_sl, i = first;
        for (;;) {
          c = items[2 * i];
          const int np = cfgs[4 * c + 2], nt = words + ((np + 31) >> 5);
          if (r < nt) break;
          r -= nt;
          i += np;
        }
        cl = cells + (i - first) * steps;
        col = r < words ? CODEC_BI : COL_INVERT;
        j = r < words ? r : r - words;
      }
      const int npart = cfgs[4 * c + 2], pw = cfgs[4 * c + 3];
      const uint8_t* e = ent_blk + c * es;
      unsigned* tog = toggles + ((long long)l * C + c) * NW * nwires;
      unsigned* one = ones + ((long long)l * C + c) * nwires;
      switch (col) {
#define REPRO_WALK(K) \
  case K: \
    activity_column<K>(img32, lw, vr, lanes, pmax, npart, pw, j, e, cl, steps, row0, W, \
                       nwires, tog, one); \
    break;
        REPRO_WALK(CODEC_NONE)
        REPRO_WALK(CODEC_GRAY)
        REPRO_WALK(CODEC_SM)
        REPRO_WALK(CODEC_TRANSITION)
        REPRO_WALK(CODEC_BI)
        REPRO_WALK(COL_INVERT)
#undef REPRO_WALK
      }
    }
    first = last;
    if (first < n_items) __syncthreads();  // the next batch rewrites the cells
  } while (first < n_items);
}

}  // namespace repro

namespace {

// The activity mode's extra buffers (null `ent` = the BT measurement only).
struct ActivityArgs {
  void* bpar;     // L*G*C*lanes bytes: each transition block's data parity
  void* ent;      // L*G*C*es bytes: entry states, written by the fold
  int es;
  void* parity;   // C*L*lanes*8 int32: the carried transition levels
  long long base_row;
  int W, NW;
  void* toggles;  // (L, C, NW, lanes*8 + pmax) int32, accumulated
  void* ones;     // (L, C, lanes*8 + pmax) int32, accumulated
};

template <typename T>
int launch_axes(const void* x, const void* w, long long L, long long P, int n,
                const void* valid, int width, int il, int wl, int split, int pack_row, int bpk,
                int G, const void* tab, int O, int C, int pmax, void* part, void* edge,
                void* inv, const void* started_in, void* started_out, void* wire, void* invc,
                void* totals, const ActivityArgs* act, cudaStream_t st) {
  using namespace repro;
  const int lanes = il + wl;
  const int flits = n / il;
  // the image, rows padded to an odd word count, then (byte packets) the
  // staged packets
  const size_t img_words = image_words_bytes(bpk, flits, lanes);
  const size_t staged = staged_bytes(bpk, n, wl > 0, sizeof(T));
  const unsigned blocks = (unsigned)(L * G);
  bt_axes_kernel<T><<<blocks * O, THREADS, img_words + staged, st>>>(
      (const T*)x, (const T*)w, (const int*)valid, P, n, width, il, wl, split, pack_row, bpk,
      G, (const int*)tab, O, C, pmax, (int*)part, (uint8_t*)edge, (uint8_t*)inv,
      act ? (uint8_t*)act->bpar : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = L * C * pmax;  // one warp per (link, config, partition)
  const unsigned fold_blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  bt_axes_fold_kernel<<<fold_blocks, THREADS, 0, st>>>(
      (const int*)valid, L, bpk, G, lanes, split, (const int*)tab, O, C, pmax,
      (const int*)part, (const uint8_t*)edge, (const uint8_t*)inv, (const int*)started_in,
      (int*)started_out, (int*)wire, (int*)invc, (unsigned*)totals,
      act ? (const uint8_t*)act->bpar : nullptr, act ? (uint8_t*)act->ent : nullptr,
      act ? act->es : 0, act ? (int*)act->parity : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || !act) return (int)err;
  const ActSmem a = act_smem(bpk, flits, lanes, n, wl > 0, sizeof(T), pmax, ACT_CELLS,
                             INV_CELL_BYTES);
  const size_t smem = a.bytes;
  const int ncells = a.ncells;
  auto kern = bt_axes_activity_kernel<T>;
  if (smem > ACT_SMEM_DEFAULT) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3(blocks, O), THREADS, smem, st>>>(
      (const T*)x, (const T*)w, (const int*)valid, P, n, width, il, wl, pack_row, bpk, G,
      (const int*)tab, O, C, pmax, (const uint8_t*)act->ent, act->es, act->base_row, act->W,
      act->NW, (unsigned*)act->toggles, (unsigned*)act->ones, ncells);
  return (int)cudaGetLastError();
}

}  // namespace

// The measurement's launch entry: the block kernel, then the fold.  dtype:
// 0 = uint8, 1 = int32; w may be null when wl == 0; valid holds L packet
// counts clamped to [0, P]; part / edge / inv are the block outputs
// (L*G*C*2*pmax*3 int32, L*G*C*4*lanes and L*G*C*4*pmax bytes);
// the carry is started_in / started_out (L int32 each), wire (C*L*lanes
// int32) and invc (C*L*pmax int32), and totals the zeroed (L, C, 3) int32
// result.
extern "C" int repro_bt_axes(const void* x, const void* w, int dtype, long long L,
                             long long P, int n, const void* valid, int width, int il,
                             int wl, int split, int pack_row, int bpk, int G,
                             const void* tab, int O, int C, int pmax, void* part,
                             void* edge, void* inv, const void* started_in,
                             void* started_out, void* wire, void* invc, void* totals,
                             void* stream) {
  auto fn = dtype == 0 ? &launch_axes<uint8_t> : &launch_axes<int32_t>;
  return fn(x, w, L, P, n, valid, width, il, wl, split, pack_row, bpk, G, tab, O, C, pmax,
            part, edge, inv, started_in, started_out, wire, invc, totals, nullptr,
            (cudaStream_t)stream);
}

// The activity mode: the same two kernels with the extra outputs, then the
// activity kernel.  bpar: L*G*C*lanes bytes; ent: L*G*C*es bytes (es =
// lanes + 2*pmax + 1); parity: the (C, L, lanes*8) int32 carry, updated in
// place; toggles / ones: the (L, C, NW, lanes*8 + pmax) and
// (L, C, lanes*8 + pmax) int32 sums, added into; base_row: the global flit
// row of this call's first row; W: flit rows per window.
extern "C" int repro_bt_axes_activity(const void* x, const void* w, int dtype, long long L,
                                      long long P, int n, const void* valid, int width,
                                      int il, int wl, int split, int pack_row, int bpk, int G,
                                      const void* tab, int O, int C, int pmax, void* part,
                                      void* edge, void* inv, const void* started_in,
                                      void* started_out, void* wire, void* invc,
                                      void* totals, void* bpar, void* ent, int es,
                                      void* parity, long long base_row, int W, int NW,
                                      void* toggles, void* ones, void* stream) {
  const ActivityArgs act{bpar, ent, es, parity, base_row, W, NW, toggles, ones};
  auto fn = dtype == 0 ? &launch_axes<uint8_t> : &launch_axes<int32_t>;
  return fn(x, w, L, P, n, valid, width, il, wl, split, pack_row, bpk, G, tab, O, C, pmax,
            part, edge, inv, started_in, started_out, wire, invc, totals, &act,
            (cudaStream_t)stream);
}
