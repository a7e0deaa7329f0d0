// psu_sort: the popcount-sorting unit (ACC-PSU / APP-PSU), order and rank.
//
// Replaces the TPU kernel repro/kernels/psu.py:psu_sort_pallas (body
// _psu_kernel with _popcount_bits / _rank_from_keys / _rank_block), which
// built (BP, N, K) one-hot and (BP, N, N) selection tensors in VMEM and
// wrote `order` by a one-hot compare + sum.
//
// Bound on this card: bytes.  Per element it reads the input once and
// writes 8 bytes of order + rank; the floor is P*N*(itemsize + 8) /
// 3.35 TB/s (5.08 ms for the 29.5 M x 64 egress call, 17.0 GB).  The design
// keeps every byte of device traffic to that and the instructions per
// element to a few:
//   * persistent blocks (as many as fit on the SMs) walk a grid-stride loop
//     over tiles of whole packets, each tile one contiguous span of x of at
//     most 16 KB, 16-byte aligned (its packet count is chosen so);
//   * the tile is read with 16-byte vector loads into registers one tile
//     ahead: the next tile's loads are in flight while this one is ranked;
//   * each element's key is computed once, into a shared-memory key tile;
//   * ranks come from the keys' bit-plane ballots (common.cuh), the key
//     width a template argument: for N <= 32 several packets share a warp,
//     each lane's rank being #smaller + #equal-below inside its packet's
//     lane segment, in one pass; up to N = 64 one warp per packet keeps
//     each 32-element chunk's keys and ballots in registers and ranks in
//     one pass; above, it counts buckets from the ballots, scans the
//     counts and ranks in a second pass from the kept ballots;
//   * `rank` is stored lane by lane (coalesced); `order[rank[i]] = i` lands
//     in the warp's segment for N <= 32 and otherwise in a per-warp shared
//     row that is written out with 16-byte stores.
// 64-bit element offsets throughout: the egress call writes 7.56 GB per
// output.
#include "common.cuh"

namespace repro {

constexpr int SORT_TILE_BYTES = 16384;
// three blocks per SM: the register budget (85 a thread) holds a tile's
// prefetched vectors and the ranking without spills, and measured faster
// on the H100 than four blocks at 64 registers with spills
constexpr int SORT_MIN_BLOCKS = 3;
constexpr int SORT_VECS = SORT_TILE_BYTES / (16 * THREADS);  // uint4 per thread per tile

// The keys of the (up to 16) elements packed in one 16-byte vector.
template <typename T>
__device__ __forceinline__ void vec_keys(const uint4& v, const KeySpec& s, unsigned char* dst);

template <>
__device__ __forceinline__ void vec_keys<uint8_t>(const uint4& v, const KeySpec& s,
                                                  unsigned char* dst) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned o = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) o |= psu_key((w[q] >> (8 * b)) & 0xFFu, s) << (8 * b);
    out[q] = o;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2], out[3]);
}

template <>
__device__ __forceinline__ void vec_keys<int32_t>(const uint4& v, const KeySpec& s,
                                                  unsigned char* dst) {
  *reinterpret_cast<unsigned*>(dst) = psu_key(v.x, s) | (psu_key(v.y, s) << 8) |
                                      (psu_key(v.z, s) << 16) | (psu_key(v.w, s) << 24);
}

// Tile t's vectors of this thread into registers: whole 16-byte vectors
// when x is aligned, element by element (zeros past the end) otherwise.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, long long total,
                                          long long tile_elems, long long t, bool aligned,
                                          uint4* regs) {
  constexpr int EPV = 16 / sizeof(T);
  const long long e0 = t * tile_elems;
  const long long left = total - e0;
  const long long ne = left < tile_elems ? left : tile_elems;
#pragma unroll
  for (int k = 0; k < SORT_VECS; ++k) {
    const long long first = (long long)(threadIdx.x + k * THREADS) * EPV;
    if (first >= ne) continue;
    if (aligned && first + EPV <= ne) {
      regs[k] = __ldcs(reinterpret_cast<const uint4*>(x + e0 + first));
    } else {
      union {
        T e[EPV];
        uint4 v;
      } u;
#pragma unroll
      for (int j = 0; j < EPV; ++j) u.e[j] = first + j < ne ? x[e0 + first + j] : T(0);
      regs[k] = u.v;
    }
  }
}

template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS, SORT_MIN_BLOCKS)
psu_sort_kernel(const T* __restrict__ x, long long P, int n, KeySpec s, int tp,
                long long tiles, int* __restrict__ order, int* __restrict__ rank) {
  extern __shared__ uint4 smem[];
  __shared__ unsigned bal[WARPS][BAL_WORDS];
  constexpr int EPV = 16 / sizeof(T);
  unsigned char* keys = reinterpret_cast<unsigned char*>(smem);
  const long long tile_elems = (long long)tp * n;
  int* obuf = reinterpret_cast<int*>(keys + ((tile_elems + 15) & ~15LL));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long total = P * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // short packets: ppw per warp pass, this lane's packet j and element i
  const int ppw = n <= 32 ? 32 / n : 1;
  const int j = lane / n;
  const int i = lane - j * n;
  const unsigned seg_bits = n >= 32 ? FULL : ((1u << n) - 1u) << (j * n);
  const bool row_vec = (n & 3) == 0;  // order rows start 16-byte aligned

  long long t = blockIdx.x;
  uint4 regs[SORT_VECS];
  load_tile(x, total, tile_elems, t, aligned, regs);
  for (; t < tiles; t += gridDim.x) {
    const long long e0 = t * tile_elems;
    const long long left = total - e0;
    const int ne = (int)(left < tile_elems ? left : tile_elems);
#pragma unroll
    for (int k = 0; k < SORT_VECS; ++k) {
      const int first = (threadIdx.x + k * THREADS) * EPV;
      if (first < ne) vec_keys<T>(regs[k], s, keys + first);
    }
    __syncthreads();
    if (t + gridDim.x < tiles) load_tile(x, total, tile_elems, t + gridDim.x, aligned, regs);
    const int tpk = ne / n;  // packets in this tile
    int* ob = order + e0;
    int* rb = rank + e0;
    if (n <= 32) {
      for (int grp = warp; grp * ppw < tpk; grp += WARPS) {
        const int pk = grp * ppw + j;
        const bool in = j < ppw && pk < tpk;
        const unsigned key = in ? keys[pk * n + i] : 0u;
        const int r = seg_rank<BITS>(key, in ? seg_bits : 0u);
        if (in) {
          rb[pk * n + i] = r;
          ob[pk * n + r] = i;
        }
      }
    } else {
      int* wbuf = obuf + warp * n;
      for (int pk = warp; pk < tpk; pk += WARPS) {
        const unsigned char* kr = keys + pk * n;
        int* rrow = rb + pk * n;
        auto key_of = [&](int e) { return (unsigned)kr[e]; };
        auto visit = [&](int e, int r) {
          rrow[e] = r;
          wbuf[r] = e;
        };
        if (n <= 32 * FEW_CHUNKS) {
          warp_rank_few<BITS>(n, key_of, visit);
          __syncwarp();
        } else {
          warp_rank_long<BITS>(n, s.nb, bal[warp], key_of, visit);
        }
        int* orow = ob + pk * n;
        if (row_vec) {
          for (int v = lane; v < n / 4; v += 32)
            reinterpret_cast<int4*>(orow)[v] = reinterpret_cast<const int4*>(wbuf)[v];
        } else {
          for (int v = lane; v < n; v += 32) orow[v] = wbuf[v];
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the next tile's keys overwrite this one's
  }
}

// Packets per tile: the largest count whose span fits SORT_TILE_BYTES and
// starts every tile 16-byte aligned (at least that alignment quantum).
inline int sort_tile_packets(int n, int itemsize) {
  const int row = n * itemsize;
  int g = 16;
  while (row % g) g >>= 1;
  const int q = 16 / g;
  const int tp = SORT_TILE_BYTES / row / q * q;
  return tp > q ? tp : q;
}

template <typename T>
auto sort_kernel(int bits) -> decltype(&psu_sort_kernel<T, 0>) {
  switch (bits) {
    case 0: return &psu_sort_kernel<T, 0>;
    case 1: return &psu_sort_kernel<T, 1>;
    case 2: return &psu_sort_kernel<T, 2>;
    case 3: return &psu_sort_kernel<T, 3>;
    case 4: return &psu_sort_kernel<T, 4>;
    default: return &psu_sort_kernel<T, 5>;
  }
}

template <typename T>
int launch_sort(const void* x, long long P, int n, const KeySpec& s, void* order, void* rank,
                cudaStream_t st) {
  const int tp = sort_tile_packets(n, sizeof(T));
  const long long tiles = (P + tp - 1) / tp;
  const size_t smem = (((size_t)tp * n + 15) & ~(size_t)15) +
                      (n > 32 ? (size_t)WARPS * n * sizeof(int) : 0);
  auto kern = sort_kernel<T>(s.bits);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(tiles < cap ? tiles : cap);
  kern<<<blocks, THREADS, smem, st>>>((const T*)x, P, n, s, tp, tiles, (int*)order,
                                      (int*)rank);
  return (int)cudaGetLastError();
}

}  // namespace repro

// dtype: 0 = uint8, 1 = int32; k == 0 selects ACC.  P >= 1, 1 <= n <= 1,024.
extern "C" int repro_psu_sort(const void* x, int dtype, long long P, int n,
                              int width, int k, int desc, void* order,
                              void* rank, void* stream) {
  using namespace repro;
  cudaStream_t st = (cudaStream_t)stream;
  const KeySpec s = make_key_spec(width, k, desc);
  return dtype == 0 ? launch_sort<uint8_t>(x, P, n, s, order, rank, st)
                    : launch_sort<int32_t>(x, P, n, s, order, rank, st);
}
