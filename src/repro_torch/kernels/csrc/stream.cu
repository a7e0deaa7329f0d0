// psu_stream: the fused transmit path — sort, reorder, flit-pack and
// (input, weight) BT count of P paired packets in one launch.
//
// Replaces the TPU kernel repro/kernels/axes.py:bt_axes_pallas in its
// emit_stream mode (body _bt_axes_kernel -> _axes_block: one link, one
// uncoded 'acc'/'app' config), whose per-block BT partials and edge flits
// were folded across blocks by repro/kernels/ops.py:_fold_axes.  The TPU
// kernel reordered by a float32 permutation-matrix product; this kernel
// does no float arithmetic at all (a TF32 product would round payloads
// above 2**11).
//
// Bound on this card: bytes.  Inputs are read once per side, order and
// rank are written as int32, the stream once as bytes:
// P*N*(2*itemsize + 8 + 2) bytes for paired packets, over 3.35 TB/s; the
// int32 order and rank are 2/3 of them for byte packets.  The design keeps
// enough of those bytes in flight and the instructions per element few:
//   * persistent blocks (as many as fit on the SMs) walk a grid-stride loop
//     over tiles of whole packets (csrc/plan.h stream_plan: at most 8 KB of
//     x a tile, every span 16-byte aligned, and cut so that a batch too
//     small for full tiles everywhere still spreads over every SM, two
//     tiles an SM);
//   * a tile's x and w spans, each with the packet before the tile (from
//     the 16-byte boundary before it), arrive by bulk asynchronous copy
//     (cp.async.bulk, completing on an mbarrier) into a two-stage
//     shared-memory ring, one tile ahead: the next tile is in flight while
//     this one is ranked.  An unaligned base or a ragged last tile is
//     loaded element by element;
//   * ranks come from the keys' bit-plane ballots (common.cuh), each key
//     computed once from the staged element: for N <= 32 several packets
//     share a warp, up to 64 one warp ranks a packet in registers, above
//     with a bucket scan.  Each lane stores its rank (coalesced) and puts
//     its byte, and its weight byte, straight into its flit cell of a
//     shared-memory image of the whole tile — sorted slot r at flit r % F,
//     lane r / F ('lane' pack) or flit r / L, lane r % L ('row' pack);
//     `order[rank[i]] = i` lands in the warp's segment for N <= 32 and
//     otherwise in a per-warp shared row written out with 16-byte stores;
//   * the image is the tile's (tp*F, lanes) stream span, written with
//     16-byte stores.  BT compares each image row with the one before in
//     32-bit words, input and weight bytes apart by a per-word byte mask
//     (a byte loop when lanes % 4 != 0).  The row before the tile's first
//     is the last flit of packet first - 1, which one warp re-ranks from
//     the stage (1 packet in tp); no cross-block fold is needed.  Each
//     block adds its BT partials with one atomicAdd per nonzero side.
// order, rank and the stream are written with streaming (evict-first)
// stores: nothing in the kernel reads them back.
#include "common.cuh"
#include "plan.h"

namespace repro {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arm the barrier for `bytes` of bulk copies (and this thread's arrival).
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// three blocks per SM: 80 registers a thread hold the ranking without
// spills, measured faster on the H100 than four blocks at 64 registers
// with spills at every transmit-path shape
constexpr int STREAM_MIN_BLOCKS = 3;

template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS, STREAM_MIN_BLOCKS)
psu_stream_kernel(const T* __restrict__ x, const T* __restrict__ w, long long P, int n,
                  KeySpec s, int il, int wl, int pack_row, StreamPlan pl,
                  int* __restrict__ order, int* __restrict__ rank, uint8_t* __restrict__ out,
                  unsigned* bt) {
  extern __shared__ uint4 smem[];
  __shared__ unsigned bal[WARPS][BAL_WORDS];
  __shared__ __align__(8) unsigned long long full[2];
  __shared__ unsigned part[WARPS][2];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lanes = il + wl;
  const int flits = n / il;
  const int pkt_bytes = flits * lanes;
  const int sides = wl ? 2 : 1;
  unsigned char* img = sm + 2 * sides * pl.stage + pl.pad;
  unsigned char* prev = img - lanes;  // the flit before the tile's first
  int* wbuf = reinterpret_cast<int*>(img + pl.image) + warp * n;
  const FastDiv div = make_fast_div(pack_row ? il : flits);
  const long long total = P * n;
  const long long tile_elems = (long long)pl.tp * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (!wl || (reinterpret_cast<uintptr_t>(w) & 15) == 0);

  // byte offset of sorted slot r in its packet's flit image
  auto cell = [&](int r, int& f) {
    int l;
    if (pack_row) {
      f = (int)fast_div(r, div);
      l = r - f * il;
    } else {
      l = (int)fast_div(r, div);
      f = r - l * flits;
    }
    return f * lanes + l;
  };
  auto tile_elems_of = [&](long long t) {
    const long long left = total - t * tile_elems;
    return (int)(left < tile_elems ? left : tile_elems);
  };
  // the bulk path needs aligned bases and a whole number of 16-byte words
  auto bulk = [&](int ne) { return aligned && ((long long)ne * sizeof(T)) % 16 == 0; };
  // a stage holds, per side, the `head` bytes before the tile (ending with
  // the packet before it) and the tile; these point at the tile
  auto stage_x = [&](int st) {
    return reinterpret_cast<T*>(sm + st * sides * pl.stage + pl.head);
  };
  auto stage_w = [&](int st) {
    return reinterpret_cast<T*>(sm + (st * sides + 1) * pl.stage + pl.head);
  };
  auto issue = [&](long long t, int st) {  // one thread: tile t into stage st
    const int ne = tile_elems_of(t);
    if (!bulk(ne)) return;
    const unsigned head = t > 0 ? (unsigned)pl.head : 0u;
    const unsigned bytes = head + (unsigned)(ne * sizeof(T));
    mbar_expect(&full[st], bytes * sides);
    const long long e0 = t * tile_elems;
    bulk_load(reinterpret_cast<unsigned char*>(stage_x(st)) - head,
              reinterpret_cast<const unsigned char*>(x + e0) - head, bytes, &full[st]);
    if (wl)
      bulk_load(reinterpret_cast<unsigned char*>(stage_w(st)) - head,
                reinterpret_cast<const unsigned char*>(w + e0) - head, bytes, &full[st]);
  };

  // BT in 32-bit words when rows are whole words: thread c of each group of
  // wpr threads takes word column c of every rstep-th row, its input bytes
  // picked by in_mask
  const int wpr = lanes >> 2;
  const bool words = (lanes & 3) == 0 && wpr <= THREADS;
  const int col = words ? threadIdx.x % wpr : 0;
  const int rstep = words ? THREADS / wpr : 1;
  const int row0 = words ? threadIdx.x / wpr : 0;
  const int nin = il - 4 * col;  // input bytes in this thread's word
  const unsigned in_mask = nin >= 4 ? FULL : (nin <= 0 ? 0u : (1u << (8 * nin)) - 1u);

  // short packets: ppw per warp pass, this lane's packet j and element i
  const int ppw = n <= 32 ? 32 / n : 1;
  const int j = lane / n;
  const int i = lane - j * n;
  const unsigned seg_bits = n >= 32 ? FULL : ((1u << n) - 1u) << (j * n);

  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  unsigned bt_in = 0, bt_wt = 0;
  unsigned parity = 0;  // bit st: the phase of stage st's barrier to wait for
  long long t = blockIdx.x;
  if (threadIdx.x == 0 && t < pl.tiles) issue(t, 0);
  for (int st = 0; t < pl.tiles; t += gridDim.x, st ^= 1) {
    if (threadIdx.x == 0 && t + gridDim.x < pl.tiles) issue(t + gridDim.x, st ^ 1);
    const long long e0 = t * tile_elems;
    const long long p0 = t * pl.tp;
    const int ne = tile_elems_of(t);
    const int tpk = ne / n;
    T* xs = stage_x(st);
    T* ws = stage_w(st);
    if (bulk(ne)) {
      mbar_wait(&full[st], (parity >> st) & 1u);
      parity ^= 1u << st;
    } else {
      for (int e = (int)threadIdx.x - (p0 > 0 ? n : 0); e < ne; e += THREADS) {
        xs[e] = x[e0 + e];
        if (wl) ws[e] = w[e0 + e];
      }
      __syncthreads();
    }

    // the boundary flit: the last flit of packet p0 - 1 (staged before the
    // tile), re-ranked
    if (warp == WARPS - 1 && p0 > 0) {
      const T* xr = xs - n;
      const T* wr = ws - n;
      warp_rank_row<BITS>(n, s.nb, bal[warp], [&](int e) { return psu_key((unsigned)xr[e], s); },
                          [&](int e, int r) {
        int f;
        const int c = cell(r, f) - (flits - 1) * lanes;
        if (f == flits - 1) {
          prev[c] = (unsigned char)xr[e];
          if (wl) prev[c + il] = (unsigned char)wr[e];
        }
      });
    }

    // rank every packet of the tile into rank, order and the image
    int* rb = rank + e0;
    int* ob = order + e0;
    if (n <= 32) {
      for (int grp = warp; grp * ppw < tpk; grp += WARPS) {
        const int pk = grp * ppw + j;
        const bool in = j < ppw && pk < tpk;
        const int e = pk * n + i;
        const T v = in ? xs[e] : T(0);
        const int r = seg_rank<BITS>(psu_key((unsigned)v, s), in ? seg_bits : 0u);
        if (in) {
          __stcs(rb + e, r);
          __stcs(ob + pk * n + r, i);
          int f;
          unsigned char* c = img + pk * pkt_bytes + cell(r, f);
          c[0] = (unsigned char)v;
          if (wl) c[il] = (unsigned char)ws[e];
        }
      }
    } else {
      for (int pk = warp; pk < tpk; pk += WARPS) {
        const T* xr = xs + pk * n;
        const T* wr = ws + pk * n;
        int* rrow = rb + pk * n;
        unsigned char* pimg = img + pk * pkt_bytes;
        auto key_of = [&](int e) { return psu_key((unsigned)xr[e], s); };
        auto visit = [&](int e, int r) {
          __stcs(rrow + e, r);
          wbuf[r] = e;
          int f;
          unsigned char* c = pimg + cell(r, f);
          c[0] = (unsigned char)xr[e];
          if (wl) c[il] = (unsigned char)wr[e];
        };
        if (n <= 32 * FEW_CHUNKS) {
          warp_rank_few<BITS>(n, key_of, visit);
          __syncwarp();
        } else {
          warp_rank_long<BITS>(n, s.nb, bal[warp], key_of, visit);
        }
        int* orow = ob + pk * n;
        if ((n & 3) == 0) {
          for (int v = lane; v < n / 4; v += 32)
            __stcs(reinterpret_cast<int4*>(orow) + v, reinterpret_cast<const int4*>(wbuf)[v]);
        } else {
          for (int v = lane; v < n; v += 32) __stcs(orow + v, wbuf[v]);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // BT over the image rows, the first against the boundary flit (none
    // before the stream's first row), then the image out as the stream
    const int rows = tpk * flits;
    if (words) {
      const unsigned* iw = reinterpret_cast<const unsigned*>(img);
      if (row0 < rstep) {
        for (int r = row0 + (p0 == 0 && row0 == 0 ? rstep : 0); r < rows; r += rstep) {
          const unsigned d = iw[r * wpr + col] ^ iw[(r - 1) * wpr + col];
          bt_in += __popc(d & in_mask);
          bt_wt += __popc(d & ~in_mask);
        }
      }
    } else {
      for (int b = threadIdx.x + (p0 == 0 ? lanes : 0); b < rows * lanes; b += THREADS) {
        const unsigned flips = __popc((unsigned)(img[b] ^ img[b - lanes]));
        if (b % lanes < il) bt_in += flips; else bt_wt += flips;
      }
    }
    uint8_t* dst = out + p0 * pkt_bytes;
    const int len = rows * lanes;
    for (int v = threadIdx.x; v < len / 16; v += THREADS)
      __stcs(reinterpret_cast<uint4*>(dst) + v, reinterpret_cast<const uint4*>(img)[v]);
    for (int b = len / 16 * 16 + threadIdx.x; b < len; b += THREADS) __stcs(dst + b, img[b]);
    // a next tile reuses the image, and its successor this tile's stage:
    // order the element path's shared writes before that bulk copy
    if (t + gridDim.x < pl.tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
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
    for (int k = 0; k < WARPS; ++k) {
      a += part[k][0];
      b += part[k][1];
    }
    if (a) atomicAdd(bt, a);
    if (b) atomicAdd(bt + 1, b);
  }
}

template <typename T>
auto stream_kernel(int bits) -> decltype(&psu_stream_kernel<T, 0>) {
  switch (bits) {
    case 0: return &psu_stream_kernel<T, 0>;
    case 1: return &psu_stream_kernel<T, 1>;
    case 2: return &psu_stream_kernel<T, 2>;
    case 3: return &psu_stream_kernel<T, 3>;
    case 4: return &psu_stream_kernel<T, 4>;
    default: return &psu_stream_kernel<T, 5>;
  }
}

template <typename T>
int launch_stream(const void* x, const void* w, long long P, int n, const KeySpec& s, int il,
                  int wl, int pack_row, void* order, void* rank, void* out, void* bt,
                  cudaStream_t st) {
  auto kern = stream_kernel<T>(s.bits);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const StreamPlan pl = stream_plan(P, n, sizeof(T), il, wl, WARPS, sms);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, pl.smem);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(pl.tiles < cap ? pl.tiles : cap);
  kern<<<blocks, THREADS, pl.smem, st>>>((const T*)x, (const T*)w, P, n, s, il, wl, pack_row,
                                         pl, (int*)order, (int*)rank, (uint8_t*)out,
                                         (unsigned*)bt);
  return (int)cudaGetLastError();
}

}  // namespace repro

// dtype: 0 = uint8, 1 = int32; k == 0 selects ACC; wl is 0 or il (w may be
// null when wl == 0).  `bt` is two zeroed int32 on the device.  P >= 1,
// 1 <= n <= 1,024.
extern "C" int repro_psu_stream(const void* x, const void* w, int dtype,
                                long long P, int n, int width, int k, int desc,
                                int il, int wl, int pack_row, void* order,
                                void* rank, void* out, void* bt, void* stream) {
  using namespace repro;
  cudaStream_t st = (cudaStream_t)stream;
  const KeySpec s = make_key_spec(width, k, desc);
  return dtype == 0 ? launch_stream<uint8_t>(x, w, P, n, s, il, wl, pack_row, order, rank, out,
                                             bt, st)
                    : launch_stream<int32_t>(x, w, P, n, s, il, wl, pack_row, order, rank, out,
                                             bt, st);
}
