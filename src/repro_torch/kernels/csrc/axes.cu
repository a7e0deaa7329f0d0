// The multi-axis BT core, in two modes.
//
// 1. psu_stream: the fused transmit path — sort, reorder, flit-pack and
// (input, weight) BT count of P paired packets in one launch.
//
// Replaces the TPU kernel repro/kernels/axes.py:bt_axes_pallas in its
// emit_stream mode (body _bt_axes_kernel -> _axes_block: one link, one
// uncoded 'acc'/'app' config), whose per-block BT partials and edge flits
// were folded across blocks by repro/kernels/ops.py:_fold_axes.  The TPU
// kernel reordered by a float32 permutation-matrix product; this kernel
// does no float arithmetic at all (a TF32 product would round payloads
// above 2**11).  One warp handles a run of PPW consecutive packets:
//   * it ranks each packet with the shared one-warp counting sort,
//   * scatters every input byte (and its paired weight byte) straight to
//     its flit cell in a shared-memory image of the packet — sorted slot
//     r sits at flit r % F, lane r / F ('lane' pack) or flit r / L,
//     lane r % L ('row' pack) — and scatters order[rank[i]] = i,
//   * writes the packet's F*lanes stream bytes out contiguously and
//     counts BT over every flit boundary it owns, including the boundary
//     from the previous packet's last flit (the first packet of a run
//     re-sorts its predecessor in shared memory to get that flit; no
//     cross-block fold is needed),
// and each block adds its two BT partials with one atomicAdd pair.
//
// Bound on this card: bytes.  Inputs are read once per side, order and
// rank are written as int32, the stream once as bytes:
// P*N*(2*itemsize + 8 + 2) bytes for paired packets, over 3.35 TB/s.
//
// 2. bt_axes: the jagged link x ordering x codec measurement — per link of
// an (L, P, N) batch with a real packet count per link, and per config of
// a static (ordering, codec) list, the (input, weight, invert-line) BT
// totals, plus the carry that chunked streaming threads across calls.
//
// Replaces the same TPU kernel in its measurement modes (b) and (c): the
// (link, packet-block) grid of _axes_block with every config unrolled,
// bus-invert's two entry branches from _bus_invert_bits, and the
// inter-block fold of repro/kernels/ops.py:_fold_axes.  Two kernels, one
// launch entry (repro_bt_axes):
//   * bt_axes_kernel, one block per (link, packet block).  For each
//     distinct ordering the block lays its valid packets out as a
//     shared-memory flit image (the warp counting sort and byte scatter of
//     psu_stream; integer addressing only, so no TF32 hazard), then for
//     every config of that ordering it counts BT over the block's internal
//     boundaries on the low byte of each lane: the byte maps (gray,
//     sign-magnitude) inline, transition signaling as the data popcount,
//     and bus-invert one warp per partition, 32 rows at a time, its
//     sequential decision as a warp scan over per-row state maps (a tie
//     forces 0, otherwise HD > half flips the previous state) for both
//     entry branches at once.  It writes per-(block, config, branch)
//     partials, first/last wire flits and first/last invert states.
//   * bt_axes_fold_kernel, one thread per (link, config, partition), walks
//     that link's valid blocks in order as _fold_axes does: the boundary
//     into each block from the carried last wire flit (none on a cold
//     start), bus-invert's entry branch from the previous *wire* flit, and
//     blocks past the link's valid rows leave the carry as it was.
//
// Bound on this card: integer operations at the scale shapes (each byte is
// read once from device memory, then touched once per distinct ordering
// to lay out and a few times per config to count), bytes for few configs.
// The block partials and edge flits are the only intermediates in device
// memory; the fold re-reads them once.
//
// 3. bt_axes_activity: the same measurement with per-wire activity windows
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
//     has few packet blocks — lays the block out again with the same
//     device code, rebuilds bus-invert's per-row invert states for the
//     known entry branch (one warp per partition, the same warp scan of
//     state maps), then walks the rows
//     with one warp per (config, lane) item (and per invert line): per 32
//     rows one __ballot_sync per bit of the toggle and level bytes, and
//     per wire a __popc of the mask over each window span, summed in a
//     register while the window stays the same (the walk tracks the
//     window's end row, no division per step) and added to the
//     (L, C, NW, WIRES) result with one atomicAdd per (wire, window) run.
//     Integer adds commute, so the result is exact in any block order; no
//     float arithmetic touches a count.
// Memory: the result plus O(L * G * C * (lanes + 2 PMAX)) bytes of entry
// state.  Bound on this card: integer operations (a few per valid row x
// wire x config) at the scale shapes; the result's bytes (written once by
// the zero fill, then by atomics) for short windows.
#include "common.cuh"

namespace repro {

constexpr int PPW = 8;  // consecutive packets per warp

template <typename T>
__global__ void __launch_bounds__(THREADS)
psu_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  long long P, int n, KeySpec s, int il, int wl, int pack_row,
                  int* __restrict__ order, int* __restrict__ rank,
                  uint8_t* __restrict__ out, unsigned* bt) {
  extern __shared__ unsigned char smem[];
  __shared__ int hist[WARPS][32];
  __shared__ unsigned part[WARPS][2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lanes = il + wl;
  const int flits = n / il;
  const int img_bytes = flits * lanes;
  unsigned char* img = smem + warp * ((img_bytes + lanes + 15) & ~15);
  unsigned char* last = img + img_bytes;  // previous packet's last flit

  // rank packet p and lay its bytes out as the (F, lanes) flit image
  auto place = [&](long long p, bool emit) {
    const T* xr = x + p * n;
    const T* wr = wl ? w + p * n : nullptr;
    int* orow = order + p * n;
    int* rrow = rank + p * n;
    warp_rank(xr, n, s, hist[warp], [&](int i, int r) {
      int f, l;
      if (pack_row) {
        f = r / il;
        l = r - f * il;
      } else {
        l = r / flits;
        f = r - l * flits;
      }
      unsigned char* cell = img + f * lanes + l;
      cell[0] = (unsigned char)xr[i];
      if (wl) cell[il] = (unsigned char)wr[i];
      if (emit) {
        rrow[i] = r;
        orow[r] = i;
      }
    });
    __syncwarp();
  };
  auto keep_last = [&]() {
    for (int c = lane; c < lanes; c += 32) last[c] = img[(flits - 1) * lanes + c];
    __syncwarp();
  };

  unsigned bt_in = 0, bt_wt = 0;
  const long long p0 = ((long long)blockIdx.x * WARPS + warp) * PPW;
  const long long p1 = p0 + PPW < P ? p0 + PPW : P;
  if (p0 < p1 && p0 > 0) {
    place(p0 - 1, false);
    keep_last();
  }
  for (long long p = p0; p < p1; ++p) {
    place(p, true);
    uint8_t* dst = out + p * img_bytes;
    for (int idx = lane; idx < img_bytes; idx += 32) {
      const int f = idx / lanes;
      const int c = idx - f * lanes;
      const unsigned char cur = img[idx];
      if (f > 0 || p > 0) {
        const unsigned char prev = f > 0 ? img[idx - lanes] : last[c];
        const unsigned flips = __popc((unsigned)(cur ^ prev));
        if (c < il) bt_in += flips; else bt_wt += flips;
      }
      dst[idx] = cur;
    }
    __syncwarp();
    keep_last();
  }

  bt_in = warp_sum(bt_in);
  bt_wt = warp_sum(bt_wt);
  if (lane == 0) {
    part[warp][0] = bt_in;
    part[warp][1] = bt_wt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned a = 0, b = 0;
    for (int i = 0; i < WARPS; ++i) {
      a += part[i][0];
      b += part[i][1];
    }
    atomicAdd(bt, a);
    atomicAdd(bt + 1, b);
  }
}

enum { CODEC_NONE = 0, CODEC_GRAY = 1, CODEC_SM = 2, CODEC_TRANSITION = 3, CODEC_BI = 4 };
enum { KEY_NONE = 0, KEY_COLUMN_MAJOR = 1, KEY_ACC = 2, KEY_APP = 3 };

// The stateless byte maps of repro/core/coding.py on one wire byte (the
// other schemes drive the data byte itself).
__device__ __forceinline__ unsigned code_byte(unsigned v, int codec) {
  if (codec == CODEC_GRAY) return (v ^ (v >> 1)) & 0xFFu;
  if (codec == CODEC_SM && v >= 0x80u) return 0x80u | (((0x100u - v) & 0xFFu) & 0x7Fu);
  return v;
}

// Sum two counters over the block; thread 0 holds the totals.
__device__ __forceinline__ void block_sum2(unsigned& a, unsigned& b, unsigned (*red)[2]) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp][0] = a;
    red[warp][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = 0;
    for (int i = 0; i < WARPS; ++i) {
      a += red[i][0];
      b += red[i][1];
    }
  }
  __syncthreads();
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

// One warp walks partition q of a bus-invert config over the block's `vr`
// image rows, for both entry states of row 0 at once.  Row t's state is
// v_t = tie_t ? 0 : (h_t ? !v_{t-1} : v_{t-1}) with h_t = [2 HD_t > 8 pw],
// tie_t = [2 HD_t == 8 pw] and HD_t the data Hamming distance of the
// partition's lanes between rows t-1 and t: a map of v_{t-1}, encoded as
// bit x = state after entry x (0b00 tie, 0b01 flip, 0b10 keep).  Each lane
// takes one row of a 32-row step; an inclusive warp scan composes the maps.
__device__ void bus_invert_walk(const unsigned char* img, int vr, int lanes, int split,
                                int pw, int q, int pmax, long long cell, int* part,
                                uint8_t* edge, uint8_t* inv) {
  const int lane = threadIdx.x & 31;
  const int j0 = q * pw;
  const int n_in = split - j0 < 0 ? 0 : (split - j0 > pw ? pw : split - j0);
  const unsigned lbits = 8u * pw;
  unsigned vin[2] = {0u, 1u};
  unsigned acc[2][3] = {{0u, 0u, 0u}, {0u, 0u, 0u}};
  for (int base = 1; base < vr; base += 32) {
    const int t = base + lane;
    const bool active = t < vr;
    unsigned s_in = 0, s_wg = 0, m = 2u;  // rows past vr keep the state
    if (active) {
      const unsigned char* cur = img + t * lanes + j0;
      const unsigned char* prev = cur - lanes;
      for (int jj = 0; jj < pw; ++jj) {
        const unsigned f = __popc((unsigned)(cur[jj] ^ prev[jj]));
        if (jj < n_in) s_in += f; else s_wg += f;
      }
      const unsigned hd2 = 2u * (s_in + s_wg);
      m = hd2 == lbits ? 0u : (hd2 > lbits ? 1u : 2u);
    }
    for (int o = 1; o < 32; o <<= 1) {  // m := m o (maps of earlier rows)
      const unsigned e = __shfl_up_sync(FULL, m, o);
      if (lane >= o) m = ((m >> (e & 1u)) & 1u) | (((m >> ((e >> 1) & 1u)) & 1u) << 1);
    }
    for (int b = 0; b < 2; ++b) {
      const unsigned vt = (m >> vin[b]) & 1u;
      unsigned vp = __shfl_up_sync(FULL, vt, 1);
      if (lane == 0) vp = vin[b];
      if (active) {
        const unsigned flip = vt ^ vp;
        acc[b][0] += flip ? 8u * n_in - s_in : s_in;
        acc[b][1] += flip ? 8u * (pw - n_in) - s_wg : s_wg;
        acc[b][2] += flip;
      }
      vin[b] = __shfl_sync(FULL, vt, 31);
    }
  }
  for (int b = 0; b < 2; ++b)
    for (int k = 0; k < 3; ++k) acc[b][k] = warp_sum(acc[b][k]);
  if (lane == 0) {
    for (int b = 0; b < 2; ++b) {
      int* pp = part + part_at(cell, b, q, pmax);
      pp[0] = (int)acc[b][0];
      pp[1] = (int)acc[b][1];
      pp[2] = (int)acc[b][2];
      inv[inv_at(cell, b, 0, pmax) + q] = (uint8_t)b;
      inv[inv_at(cell, b, 1, pmax) + q] = (uint8_t)vin[b];
    }
  }
  for (int jj = lane; jj < pw; jj += 32) {
    const int j = j0 + jj;
    const unsigned first = img[j], last = img[(vr - 1) * lanes + j];
    for (int b = 0; b < 2; ++b) {
      edge[edge_at(cell, b, 0, lanes) + j] = (uint8_t)(first ^ (b ? 0xFFu : 0u));
      edge[edge_at(cell, b, 1, lanes) + j] = (uint8_t)(last ^ (vin[b] ? 0xFFu : 0u));
    }
  }
}

// Lay the block's vp valid packets (from packet p_lo of link l) out under
// one ordering as the (vp * flits, lanes) flit image in shared memory: per
// packet one warp, the counting-sort rank of psu_stream ('acc' / 'app') or
// the fixed 'none' / 'column_major' slots, each byte scattered to its cell.
template <typename T>
__device__ void lay_out(const T* __restrict__ x, const T* __restrict__ w, long long l,
                        long long P, long long p_lo, int vp, int n, int il, int wl, int flits,
                        int lanes, int pack_row, int key, const KeySpec& s, int (*hist)[32],
                        unsigned char* img) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int pk = warp; pk < vp; pk += WARPS) {
    const long long off = ((long long)l * P + p_lo + pk) * n;
    const T* xr = x + off;
    const T* wr = wl ? w + off : nullptr;
    unsigned char* pimg = img + pk * flits * lanes;
    auto place = [&](int i, int r) {
      int f, c;
      if (pack_row) {
        f = r / il;
        c = r - f * il;
      } else {
        c = r / flits;
        f = r - c * flits;
      }
      unsigned char* cell = pimg + f * lanes + c;
      cell[0] = (unsigned char)xr[i];
      if (wl) cell[il] = (unsigned char)wr[i];
    };
    if (key >= KEY_ACC) {
      warp_rank(xr, n, s, hist[warp], place);
    } else {
      for (int i = lane; i < n; i += 32) {
        const int f0 = i / il;  // column-major: slot l*F + f carries element f*L + l
        place(i, key == KEY_COLUMN_MAJOR ? (i - f0 * il) * flits + f0 : i);
      }
    }
  }
}

// tab: O orderings as (key, k, descending), then C configs as (ordering,
// codec, partitions, lanes per partition).
template <typename T>
__global__ void __launch_bounds__(THREADS)
bt_axes_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ valid, long long P, int n, int width, int il,
               int wl, int split, int pack_row, int bpk, int G,
               const int* __restrict__ tab, int O, int C, int pmax,
               int* __restrict__ part, uint8_t* __restrict__ edge,
               uint8_t* __restrict__ inv, uint8_t* __restrict__ bpar) {
  extern __shared__ unsigned char img[];
  __shared__ int hist[WARPS][32];
  __shared__ unsigned red[WARPS][2];
  const int warp = threadIdx.x >> 5;
  const long long l = blockIdx.x / G;
  const int g = (int)(blockIdx.x - l * G);
  const int lanes = il + wl;
  const int flits = n / il;
  const long long p_lo = (long long)g * bpk;
  const long long left = (long long)valid[l] - p_lo;
  // a block holding none of the link's valid packets is never read by the fold
  if (left <= 0) return;
  const int vp = left < bpk ? (int)left : bpk;
  const int vr = vp * flits;
  const int* cfgs = tab + 3 * O;

  for (int o = 0; o < O; ++o) {
    const int key = tab[3 * o];
    const KeySpec s = make_key_spec(width, key == KEY_APP ? tab[3 * o + 1] : 0, tab[3 * o + 2]);
    lay_out(x, w, l, P, p_lo, vp, n, il, wl, flits, lanes, pack_row, key, s, hist, img);
    __syncthreads();

    // stateless codecs and transition signaling: every thread, block sums
    for (int c = 0; c < C; ++c) {
      const int codec = cfgs[4 * c + 1];
      if (cfgs[4 * c] != o || codec == CODEC_BI) continue;
      const long long cell = blockIdx.x * (long long)C + c;
      // thread -> (first row, lane), THREADS / lanes rows per pass; a flit
      // wider than the block gives each thread whole lane columns
      const bool wide = lanes > THREADS;
      const int rstep = wide ? 1 : THREADS / lanes;
      const int t0 = wide ? 0 : threadIdx.x / lanes;
      unsigned a_in = 0, a_wg = 0;
      if (t0 < rstep) {
        for (int j = wide ? threadIdx.x : threadIdx.x - t0 * lanes; j < lanes; j += THREADS) {
          unsigned a = 0;
          for (int t = 1 + t0; t < vr; t += rstep) {
            const unsigned cur = img[t * lanes + j];
            a += codec == CODEC_TRANSITION
                     ? __popc(cur)
                     : __popc(code_byte(cur, codec) ^ code_byte(img[(t - 1) * lanes + j], codec));
          }
          if (j < split) a_in += a; else a_wg += a;
        }
      }
      block_sum2(a_in, a_wg, red);
      if (threadIdx.x == 0) {
        int* pp = part + part_at(cell, 0, 0, pmax);
        pp[0] = (int)a_in;
        pp[1] = (int)a_wg;
        pp[2] = 0;
      }
      for (int j = threadIdx.x; j < lanes; j += THREADS) {
        edge[edge_at(cell, 0, 0, lanes) + j] = (uint8_t)code_byte(img[j], codec);
        edge[edge_at(cell, 0, 1, lanes) + j] =
            (uint8_t)code_byte(img[(vr - 1) * lanes + j], codec);
      }
      // activity mode: the block's data parity per lane (transition's wire
      // levels are the running parity, prefix-XORed by the fold)
      if (bpar && codec == CODEC_TRANSITION) {
        for (int j = threadIdx.x; j < lanes; j += THREADS) {
          unsigned px = 0;
          for (int t = 0; t < vr; ++t) px ^= img[t * lanes + j];
          bpar[cell * lanes + j] = (uint8_t)px;
        }
      }
    }

    // bus-invert: one warp per (config, partition)
    int item = 0;
    for (int c = 0; c < C; ++c) {
      if (cfgs[4 * c] != o || cfgs[4 * c + 1] != CODEC_BI) continue;
      const long long cell = blockIdx.x * (long long)C + c;
      for (int q = 0; q < cfgs[4 * c + 2]; ++q, ++item) {
        if (item % WARPS == warp)
          bus_invert_walk(img, vr, lanes, split, cfgs[4 * c + 3], q, pmax, cell, part, edge, inv);
      }
    }
    __syncthreads();  // the next ordering lays out over this image
  }
}

// One thread per (link, config, partition): the in-order walk over the
// link's valid blocks.  wire / invc hold the carry (last wire flit per
// lane, last invert state per partition) and are updated in place; the
// totals are added with atomics (unsigned: wraps like the int32 sums).
// With `ent` (activity mode) it also records each block's entry state
// (see the entry-state layout below) and threads `parity`, each wire's transition level as 0/1
// per wire (C, L, lanes*8), through the block parities `bpar`.
__global__ void bt_axes_fold_kernel(const int* __restrict__ valid, long long L, int bpk,
                                    int G, int lanes, int split,
                                    const int* __restrict__ tab, int O, int C, int pmax,
                                    const int* __restrict__ part,
                                    const uint8_t* __restrict__ edge,
                                    const uint8_t* __restrict__ inv,
                                    const int* __restrict__ started_in,
                                    int* __restrict__ started_out, int* wire, int* invc,
                                    unsigned* totals, const uint8_t* __restrict__ bpar,
                                    uint8_t* ent, int es, int* parity) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= L * C * pmax) return;
  const int q = (int)(idx % pmax);
  const int c = (int)((idx / pmax) % C);
  const long long l = idx / ((long long)pmax * C);
  const int* cf = tab + 3 * O + 4 * c;
  const int codec = cf[1], npart = cf[2], pw = cf[3];
  const int v = valid[l];
  if (c == 0 && q == 0) started_out[l] = (started_in[l] != 0 || v > 0) ? 1 : 0;
  if (codec == CODEC_BI ? q >= npart : q > 0) return;
  const int nblk = v > 0 ? (v + bpk - 1) / bpk : 0;
  int st = started_in[l] != 0;
  int* cw = wire + ((long long)c * L + l) * lanes;
  unsigned t_in = 0, t_wg = 0, t_aux = 0;
  if (codec != CODEC_BI) {
    int* par = parity ? parity + ((long long)c * L + l) * lanes * 8 : nullptr;
    for (int g = 0; g < nblk; ++g) {
      const long long cell = (l * G + g) * C + c;
      const int* pp = part + part_at(cell, 0, 0, pmax);
      t_in += (unsigned)pp[0];
      t_wg += (unsigned)pp[1];
      const uint8_t* first = edge + edge_at(cell, 0, 0, lanes);
      const uint8_t* prev = g > 0 ? edge + edge_at(cell - C, 0, 1, lanes) : nullptr;
      if (ent) {
        uint8_t* e = ent + cell * es;
        for (int j = 0; j < lanes; ++j) {
          unsigned b;
          if (codec != CODEC_TRANSITION) {
            b = prev ? prev[j] : (unsigned)cw[j];  // the wire flit before the block
          } else if (g > 0) {  // entry parity: the previous block's, XOR its data
            b = ent[(cell - C) * es + j] ^ bpar[(cell - C) * lanes + j];
          } else {
            b = 0;
            for (int k = 0; k < 8; ++k) b |= (unsigned)(par[j * 8 + k] & 1) << k;
          }
          e[j] = (uint8_t)b;
        }
        e[lanes + 2 * pmax] = (uint8_t)(g > 0 || st);
      }
      if (g == 0 && !st) continue;  // no boundary into the first flit ever sent
      for (int j = 0; j < lanes; ++j) {
        const unsigned before = prev ? prev[j] : (unsigned)cw[j];
        const unsigned f = codec == CODEC_TRANSITION ? __popc((unsigned)first[j])
                                                     : __popc((first[j] ^ before) & 0xFFu);
        if (j < split) t_in += f; else t_wg += f;
      }
    }
    if (nblk > 0) {
      const long long cl = (l * G + nblk - 1) * C + c;
      const uint8_t* last = edge + edge_at(cl, 0, 1, lanes);
      for (int j = 0; j < lanes; ++j) cw[j] = last[j];
      if (ent && codec == CODEC_TRANSITION) {
        for (int j = 0; j < lanes; ++j) {
          const unsigned b = ent[cl * es + j] ^ bpar[cl * lanes + j];
          for (int k = 0; k < 8; ++k) par[j * 8 + k] = (b >> k) & 1u;
        }
      }
    }
  } else {
    const int j0 = q * pw;
    int* civ = invc + ((long long)c * L + l) * pmax + q;
    int iv = *civ;
    const uint8_t* lastw = nullptr;  // null: the carried wire flit
    for (int g = 0; g < nblk; ++g) {
      const long long cell = (l * G + g) * C + c;
      const uint8_t* first = edge + edge_at(cell, 0, 0, lanes) + j0;  // = the data flit
      unsigned hd = 0;
      for (int jj = 0; jj < pw; ++jj)
        hd += __popc((first[jj] ^ (lastw ? lastw[jj] : (unsigned)cw[j0 + jj])) & 0xFFu);
      // entry branch from the previous wire flit; forced 0 on a cold start
      const int b = st && 2u * hd > 8u * pw;
      if (ent) {
        uint8_t* e = ent + cell * es;
        for (int jj = 0; jj < pw; ++jj)
          e[j0 + jj] = lastw ? lastw[jj] : (uint8_t)cw[j0 + jj];
        e[lanes + q] = (uint8_t)b;
        e[lanes + pmax + q] = (uint8_t)iv;
        if (q == 0) e[lanes + 2 * pmax] = (uint8_t)st;
      }
      if (st) {
        for (int jj = 0; jj < pw; ++jj) {
          const unsigned before = lastw ? lastw[jj] : (unsigned)cw[j0 + jj];
          const unsigned f = __popc((before ^ first[jj] ^ (b ? 0xFFu : 0u)) & 0xFFu);
          if (j0 + jj < split) t_in += f; else t_wg += f;
        }
        t_aux += iv != b;
      }
      const int* pp = part + part_at(cell, b, q, pmax);
      t_in += (unsigned)pp[0];
      t_wg += (unsigned)pp[1];
      t_aux += (unsigned)pp[2];
      lastw = edge + edge_at(cell, b, 1, lanes) + j0;
      iv = inv[inv_at(cell, b, 1, pmax) + q];
      st = 1;
    }
    if (lastw) {
      for (int jj = 0; jj < pw; ++jj) cw[j0 + jj] = lastw[jj];
      *civ = iv;
    }
  }
  unsigned* tot = totals + (l * C + c) * 3;
  atomicAdd(tot, t_in);
  atomicAdd(tot + 1, t_wg);
  atomicAdd(tot + 2, t_aux);
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

// One warp: the invert states v_t of partition q over the block's vr image
// rows for the known entry branch b, into vst[t * pmax + q].  Row 0 is b;
// row t > 0 applies the map of bus_invert_walk (tie -> 0, HD > half ->
// flip, else keep), composed across the warp by the same scan.
__device__ void invert_states(const unsigned char* img, int vr, int lanes, int pw, int q,
                              int pmax, unsigned b, unsigned char* vst) {
  const int lane = threadIdx.x & 31;
  const int j0 = q * pw;
  const unsigned lbits = 8u * pw;
  unsigned vin = 0;  // state before the step's first row
  for (int base = 0; base < vr; base += 32) {
    const int t = base + lane;
    unsigned m = 2u;  // rows past vr keep the state
    if (t == 0) {
      m = b ? 3u : 0u;
    } else if (t < vr) {
      unsigned hd = 0;
      for (int jj = 0; jj < pw; ++jj)
        hd += __popc((unsigned)(img[t * lanes + j0 + jj] ^ img[(t - 1) * lanes + j0 + jj]));
      m = 2u * hd == lbits ? 0u : (2u * hd > lbits ? 1u : 2u);
    }
    for (int o = 1; o < 32; o <<= 1) {  // m := m o (maps of earlier rows)
      const unsigned e = __shfl_up_sync(FULL, m, o);
      if (lane >= o) m = ((m >> (e & 1u)) & 1u) | (((m >> ((e >> 1) & 1u)) & 1u) << 1);
    }
    const unsigned vt = (m >> vin) & 1u;
    if (t < vr) vst[t * pmax + q] = (unsigned char)vt;
    vin = __shfl_sync(FULL, vt, 31);
  }
}

// One warp walks one activity item over the block's rows, 32 at a time:
// data lane j (item < lanes; wires j*8 .. j*8+7) or, for bus-invert, the
// invert line of partition item - lanes.  Per row it forms the byte of
// toggles at the boundary into the row and the byte of wire levels; one
// ballot per bit gives lane b the masks of wire b, which counts its levels
// and, per window span of the 32 rows, its toggles — summed in a register
// while the window stays the same, added with one atomicAdd per run.
__device__ void activity_walk(const unsigned char* img, const unsigned char* vst, int vr,
                              int lanes, int pmax, int codec, int pw, int item,
                              const uint8_t* e, long long row0, int W, int nwires,
                              unsigned* tog_out, unsigned* ones_out) {
  const int lane = threadIdx.x & 31;
  const bool aux = item >= lanes;
  const int j = aux ? 0 : item;
  const int q = aux ? item - lanes : (codec == CODEC_BI ? item / pw : 0);
  const int nb = aux ? 1 : 8;
  const int wire0 = aux ? lanes * 8 + q : item * 8;
  const bool st = e[lanes + 2 * pmax] != 0;
  unsigned par = codec == CODEC_TRANSITION ? e[j] : 0u;  // parity before the step
  // the current run: its window, the first global row past that window
  // (advanced by adding W, so the walk divides once) and its count
  long long run_w = row0 / W;
  long long w_end = (run_w + 1) * W;
  unsigned ones = 0, run = 0;
  for (int base = 0; base < vr; base += 32) {
    const int t = base + lane;
    const bool active = t < vr;
    unsigned tog = 0, lvl = 0;
    if (codec == CODEC_TRANSITION) {
      // toggle = the data bit; level = entry parity ^ XOR of data up to t
      const unsigned d = active ? img[t * lanes + j] : 0u;
      unsigned px = d;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, px, o);
        if (lane >= o) px ^= v;
      }
      tog = d;
      lvl = active ? (par ^ px) & 0xFFu : 0u;
      par ^= __shfl_sync(FULL, px, 31);
    } else if (active && aux) {
      const unsigned vt = vst[t * pmax + q];
      tog = vt ^ (t > 0 ? (unsigned)vst[(t - 1) * pmax + q] : (unsigned)e[lanes + pmax + q]);
      lvl = vt;
    } else if (active) {
      unsigned cur, prev;
      if (codec == CODEC_BI) {
        cur = img[t * lanes + j] ^ (vst[t * pmax + q] ? 0xFFu : 0u);
        prev = t > 0 ? img[(t - 1) * lanes + j] ^ (vst[(t - 1) * pmax + q] ? 0xFFu : 0u)
                     : (unsigned)e[j];
      } else {
        cur = code_byte(img[t * lanes + j], codec);
        prev = t > 0 ? code_byte(img[(t - 1) * lanes + j], codec) : (unsigned)e[j];
      }
      tog = (cur ^ prev) & 0xFFu;
      lvl = cur & 0xFFu;
    }
    if (t == 0 && !st) tog = 0;  // no boundary into the first row ever sent
    unsigned tm = 0, lm = 0;
    for (int b = 0; b < nb; ++b) {
      const unsigned mt = __ballot_sync(FULL, (tog >> b) & 1u);
      const unsigned ml = __ballot_sync(FULL, (lvl >> b) & 1u);
      if (lane == b) {
        tm = mt;
        lm = ml;
      }
    }
    if (lane < nb) {
      ones += __popc(lm);
      const long long r0 = row0 + base;  // global row of this step's first row
      const int nrow = vr - base < 32 ? vr - base : 32;
      for (int i = 0; i < nrow;) {
        if (r0 + i == w_end) {  // row i opens the next window
          if (run) atomicAdd(tog_out + run_w * nwires + wire0 + lane, run);
          run = 0;
          ++run_w;
          w_end += W;
        }
        const long long stop = w_end - r0;
        const int iend = stop < nrow ? (int)stop : nrow;
        const unsigned span = (iend >= 32 ? FULL : ((1u << iend) - 1u)) & ~((1u << i) - 1u);
        run += __popc(tm & span);
        i = iend;
      }
    }
  }
  if (lane < nb) {
    if (run) atomicAdd(tog_out + run_w * nwires + wire0 + lane, run);
    if (ones) atomicAdd(ones_out + wire0 + lane, ones);
  }
}

// One block per (link, packet block) and ordering (blockIdx.y), after the
// fold has filled `ent`: the image of that ordering again, then per config
// of it its bus-invert states and its items, one warp each.  toggles (L, C, NW, nwires) and ones
// (L, C, nwires) are zeroed or hold earlier chunks' counts; base_row is the
// global row of this call's first flit row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bt_axes_activity_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ valid, long long P, int n, int width, int il,
                        int wl, int pack_row, int bpk, int G, const int* __restrict__ tab,
                        int O, int C, int pmax, const uint8_t* __restrict__ ent, int es,
                        long long base_row, int W, int NW, unsigned* __restrict__ toggles,
                        unsigned* __restrict__ ones) {
  extern __shared__ unsigned char img[];
  __shared__ int hist[WARPS][32];
  const int warp = threadIdx.x >> 5;
  const long long l = blockIdx.x / G;
  const int g = (int)(blockIdx.x - l * G);
  const int lanes = il + wl;
  const int flits = n / il;
  const long long p_lo = (long long)g * bpk;
  const long long left = (long long)valid[l] - p_lo;
  if (left <= 0) return;
  const int vp = left < bpk ? (int)left : bpk;
  const int vr = vp * flits;
  unsigned char* vst = img + (size_t)bpk * flits * lanes;  // (rows, pmax) invert states
  const int* cfgs = tab + 3 * O;
  const int nwires = lanes * 8 + pmax;
  const long long row0 = base_row + p_lo * flits;

  const int o = blockIdx.y;
  const int key = tab[3 * o];
  const KeySpec s = make_key_spec(width, key == KEY_APP ? tab[3 * o + 1] : 0, tab[3 * o + 2]);
  lay_out(x, w, l, P, p_lo, vp, n, il, wl, flits, lanes, pack_row, key, s, hist, img);
  __syncthreads();
  for (int c = 0; c < C; ++c) {
    if (cfgs[4 * c] != o) continue;
    const int codec = cfgs[4 * c + 1], npart = cfgs[4 * c + 2], pw = cfgs[4 * c + 3];
    const uint8_t* e = ent + (blockIdx.x * (long long)C + c) * es;
    if (codec == CODEC_BI) {
      for (int q = warp; q < npart; q += WARPS) invert_states(img, vr, lanes, pw, q, pmax, e[lanes + q], vst);
      __syncthreads();
    }
    unsigned* tog = toggles + ((long long)l * C + c) * NW * nwires;
    unsigned* one = ones + ((long long)l * C + c) * nwires;
    const int items = lanes + (codec == CODEC_BI ? npart : 0);
    for (int it = warp; it < items; it += WARPS)
      activity_walk(img, vst, vr, lanes, pmax, codec, pw, it, e, row0, W, nwires, tog, one);
    __syncthreads();  // the next config rebuilds vst
  }
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
  const size_t img = (size_t)bpk * (n / il) * lanes;
  const unsigned blocks = (unsigned)(L * G);
  bt_axes_kernel<T><<<blocks, THREADS, img, st>>>(
      (const T*)x, (const T*)w, (const int*)valid, P, n, width, il, wl, split, pack_row, bpk,
      G, (const int*)tab, O, C, pmax, (int*)part, (uint8_t*)edge, (uint8_t*)inv,
      act ? (uint8_t*)act->bpar : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = L * C * pmax;
  const unsigned fold_blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  bt_axes_fold_kernel<<<fold_blocks, THREADS, 0, st>>>(
      (const int*)valid, L, bpk, G, lanes, split, (const int*)tab, O, C, pmax,
      (const int*)part, (const uint8_t*)edge, (const uint8_t*)inv, (const int*)started_in,
      (int*)started_out, (int*)wire, (int*)invc, (unsigned*)totals,
      act ? (const uint8_t*)act->bpar : nullptr, act ? (uint8_t*)act->ent : nullptr,
      act ? act->es : 0, act ? (int*)act->parity : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || !act) return (int)err;
  const size_t smem = img + (size_t)bpk * (n / il) * pmax;
  bt_axes_activity_kernel<T><<<dim3(blocks, O), THREADS, smem, st>>>(
      (const T*)x, (const T*)w, (const int*)valid, P, n, width, il, wl, pack_row, bpk, G,
      (const int*)tab, O, C, pmax, (const uint8_t*)act->ent, act->es, act->base_row, act->W,
      act->NW, (unsigned*)act->toggles, (unsigned*)act->ones);
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

// dtype: 0 = uint8, 1 = int32; k == 0 selects ACC; wl is 0 or il (w may be
// null when wl == 0).  `bt` is two zeroed int32 on the device.
extern "C" int repro_psu_stream(const void* x, const void* w, int dtype,
                                long long P, int n, int width, int k, int desc,
                                int il, int wl, int pack_row, void* order,
                                void* rank, void* out, void* bt, void* stream) {
  using namespace repro;
  cudaStream_t st = (cudaStream_t)stream;
  const KeySpec s = make_key_spec(width, k, desc);
  const int lanes = il + wl;
  const int img_bytes = (n / il) * lanes;
  const size_t smem = (size_t)WARPS * ((img_bytes + lanes + 15) & ~15);
  const long long per_block = (long long)WARPS * PPW;
  const unsigned blocks = (unsigned)((P + per_block - 1) / per_block);
  if (dtype == 0) {
    psu_stream_kernel<uint8_t><<<blocks, THREADS, smem, st>>>(
        (const uint8_t*)x, (const uint8_t*)w, P, n, s, il, wl, pack_row,
        (int*)order, (int*)rank, (uint8_t*)out, (unsigned*)bt);
  } else {
    psu_stream_kernel<int32_t><<<blocks, THREADS, smem, st>>>(
        (const int32_t*)x, (const int32_t*)w, P, n, s, il, wl, pack_row,
        (int*)order, (int*)rank, (uint8_t*)out, (unsigned*)bt);
  }
  return (int)cudaGetLastError();
}
