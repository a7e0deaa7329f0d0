// bt_count: total bit transitions of a (T, L) flit stream.
//
// Replaces the TPU kernel repro/kernels/btcount.py:bt_count_pallas (body
// _bt_kernel), which reduced per-block int32 partials over two shifted,
// padded copies of the stream.  Here the stream is read in place (no
// copies), the low `width` bits of each element's XOR with the element one
// row later are popcounted, and each block adds one partial with one
// atomicAdd.  Unsigned partials and atomics wrap modulo 2**32, as the
// reference's int32 sum does.
//
// Bound on this card: bytes.  Every input byte is read once from device
// memory for ~1 integer operation, so the floor is T*L*itemsize / 3.35
// TB/s.  A thread per row pair with a load per element is bound by load
// instructions instead (16 one-byte loads per row of the egress wire, every
// row loaded twice, each warp load touching 32 rows), so two kernels:
//   * bt_flat_kernel, for contiguous streams (row stride == lanes): the
//     stream is a flat array s and BT = sum popc((s[i] ^ s[i + L]) & m) over
//     i < (T - 1) * L, m the width mask of each element.  A persistent grid
//     (a few blocks per SM) walks 16-byte words with several loads in
//     flight a thread; the partner window 16 bytes at i + L is one aligned
//     word when L*itemsize is a multiple of 16, else two aligned words
//     funnel-shifted (the second word comes from L1: a neighbour lane read
//     it).  The bytes before the first aligned word (an unaligned base) and
//     the ragged tail are counted element by element in the same launch.
//   * bt_rows_kernel, for row-strided streams (column slices such as the
//     staged TX path's stream[:, :input_lanes]): a row is read as 16-, 8-
//     or 4-byte vectors when its address and the row stride allow, the rest
//     of the row element by element; a group of up to 256 threads (a power
//     of two) shares each row pair, so a short wide stream still spreads
//     over the card.
#include "common.cuh"
#include "plan.h"

namespace repro {

constexpr int BT_UNROLL = 4;         // 16-byte words in flight per thread
constexpr int BT_BLOCKS_PER_SM = 4;  // persistent blocks per SM

__device__ __forceinline__ void block_add(unsigned v, unsigned* out) {
  __shared__ unsigned part[WARPS];
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int i = 0; i < WARPS; ++i) total += part[i];
    atomicAdd(out, total);
  }
}

__device__ __forceinline__ unsigned popc_xor(const uint4& a, const uint4& b, unsigned m) {
  return __popc((a.x ^ b.x) & m) + __popc((a.y ^ b.y) & m) + __popc((a.z ^ b.z) & m) +
         __popc((a.w ^ b.w) & m);
}

// The 16 bytes at byte offset 4*Q + sh/8 of the 32-byte pair (lo, hi).
template <int Q>
__device__ __forceinline__ uint4 window(const uint4& lo, const uint4& hi, unsigned sh) {
  const unsigned v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(v[Q], v[Q + 1], sh), __funnelshift_r(v[Q + 1], v[Q + 2], sh),
                    __funnelshift_r(v[Q + 2], v[Q + 3], sh),
                    __funnelshift_r(v[Q + 3], v[Q + 4], sh));
}

// Contiguous stream of element type T.  body: the 16-byte aligned words
// [0, nw) of the compared bytes (each with its partner window Lb bytes on,
// Lb = L * sizeof(T)); pw: the aligned word holding that window's first
// byte, relative to body (HI: the window spills into the next word, by
// 4*Q + sh/8 bytes).  The elements [0, head) and [tail, ncmp) are counted
// one by one.  wmask: the width mask of every element of a 32-bit word;
// emask: of one element.
template <typename T, int Q, bool HI>
__global__ void __launch_bounds__(THREADS, BT_BLOCKS_PER_SM)
bt_flat_kernel(const T* __restrict__ s, long long L, long long ncmp, long long head,
               const uint4* __restrict__ body, long long nw, long long pw, unsigned sh,
               long long tail, unsigned wmask, unsigned emask, unsigned* out) {
  unsigned acc = 0;
  const long long nthreads = (long long)gridDim.x * THREADS;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long span = nthreads * BT_UNROLL;
  for (long long k0 = tid; k0 < nw; k0 += span) {
    uint4 a[BT_UNROLL], lo[BT_UNROLL], hi[BT_UNROLL];
#pragma unroll
    for (int u = 0; u < BT_UNROLL; ++u) {
      const long long k = k0 + u * nthreads;
      if (k < nw) {
        a[u] = __ldg(body + k);
        lo[u] = __ldg(body + k + pw);
        if (HI) hi[u] = __ldg(body + k + pw + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < BT_UNROLL; ++u) {
      if (k0 + u * nthreads < nw) {
        const uint4 b = HI ? window<Q>(lo[u], hi[u], sh) : lo[u];
        acc += popc_xor(a[u], b, wmask);
      }
    }
  }
  const long long rest = head + (ncmp - tail);
  for (long long i = tid; i < rest; i += nthreads) {
    const long long e = i < head ? i : tail + (i - head);
    acc += __popc(((unsigned)s[e] ^ (unsigned)s[e + L]) & emask);
  }
  block_add(acc, out);
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ unsigned count(const unsigned char* a, const unsigned char* b,
                                                    unsigned m) {
    return __popc((__ldg(reinterpret_cast<const unsigned*>(a)) ^
                   __ldg(reinterpret_cast<const unsigned*>(b))) & m);
  }
};
template <>
struct Vec<8> {
  static __device__ __forceinline__ unsigned count(const unsigned char* a, const unsigned char* b,
                                                    unsigned m) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(a));
    const uint2 y = __ldg(reinterpret_cast<const uint2*>(b));
    return __popc((x.x ^ y.x) & m) + __popc((x.y ^ y.y) & m);
  }
};
template <>
struct Vec<16> {
  static __device__ __forceinline__ unsigned count(const unsigned char* a, const unsigned char* b,
                                                    unsigned m) {
    return popc_xor(__ldg(reinterpret_cast<const uint4*>(a)),
                    __ldg(reinterpret_cast<const uint4*>(b)), m);
  }
};

// Row-strided stream: rows of L elements, `stride` elements apart; each row
// pair is shared by a group of 2**gl threads.  The first nv * V bytes of a
// row are read as V-byte vectors (V = 0: none), the rest element by element.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bt_rows_kernel(const T* __restrict__ s, long long rows, long long L, long long stride, int nv,
               int gl, unsigned wmask, unsigned emask, unsigned* out) {
  unsigned acc = 0;
  const int g = 1 << gl;
  const int sub = threadIdx.x & (g - 1);
  const long long step = ((long long)gridDim.x * THREADS) >> gl;
  const long long first = (V ? (long long)nv * V : 0) / (long long)sizeof(T);
  for (long long r = (((long long)blockIdx.x * THREADS) + threadIdx.x) >> gl; r < rows - 1;
       r += step) {
    const T* a = s + r * stride;
    const T* b = a + stride;
    if (V) {
      const unsigned char* ab = reinterpret_cast<const unsigned char*>(a);
      const unsigned char* bb = reinterpret_cast<const unsigned char*>(b);
      for (int v = sub; v < nv; v += g) acc += Vec<V ? V : 4>::count(ab + v * V, bb + v * V, wmask);
    }
    for (long long c = first + sub; c < L; c += g)
      acc += __popc(((unsigned)a[c] ^ (unsigned)b[c]) & emask);
  }
  block_add(acc, out);
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

inline int grid_for(long long items, long long per_block, int cap) {
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

template <typename T>
void launch_flat(const T* s, long long rows, long long L, unsigned wmask, unsigned emask,
                 unsigned* out, cudaStream_t st) {
  const FlatPlan p = flat_plan(reinterpret_cast<uintptr_t>(s), rows, L, sizeof(T));
  const uint4* body = reinterpret_cast<const uint4*>(s + p.head);
  const unsigned sh = 8u * (unsigned)(p.r & 3);
  const long long rest = p.head + p.ncmp - p.tail;
  const int grid = grid_for(p.nw > rest ? p.nw : rest, (long long)THREADS * BT_UNROLL,
                            sm_count() * BT_BLOCKS_PER_SM);
  auto go = [&](auto kern) {
    kern<<<grid, THREADS, 0, st>>>(s, L, p.ncmp, p.head, body, p.nw, p.pw, sh, p.tail, wmask,
                                   emask, out);
  };
  switch (p.r ? (p.r >> 2) + 1 : 0) {
    case 0: go(bt_flat_kernel<T, 0, false>); break;
    case 1: go(bt_flat_kernel<T, 0, true>); break;
    case 2: go(bt_flat_kernel<T, 1, true>); break;
    case 3: go(bt_flat_kernel<T, 2, true>); break;
    default: go(bt_flat_kernel<T, 3, true>); break;
  }
}

template <typename T>
void launch_rows(const T* s, long long rows, long long L, long long stride, unsigned wmask,
                 unsigned emask, unsigned* out, cudaStream_t st) {
  const RowsPlan p = rows_plan(reinterpret_cast<uintptr_t>(s), L, stride, sizeof(T), THREADS);
  const int grid = grid_for(((rows - 1) << p.gl), THREADS, sm_count() * 8);
  auto go = [&](auto kern) {
    kern<<<grid, THREADS, 0, st>>>(s, rows, L, stride, p.nv, p.gl, wmask, emask, out);
  };
  switch (p.v) {
    case 16: go(bt_rows_kernel<T, 16>); break;
    case 8: go(bt_rows_kernel<T, 8>); break;
    case 4: go(bt_rows_kernel<T, 4>); break;
    default: go(bt_rows_kernel<T, 0>); break;
  }
}

template <typename T>
void launch_bt(const void* s, long long rows, long long lanes, long long stride, int width,
               void* out, cudaStream_t st) {
  const unsigned emask = (1u << width) - 1u;  // width in [1, 16]
  // a uint8 element has 8 bits: its mask is the low min(width, 8) bits
  const unsigned wmask = sizeof(T) == 1 ? (emask & 0xFFu) * 0x01010101u : emask;
  if (stride == lanes)
    launch_flat((const T*)s, rows, lanes, wmask, emask, (unsigned*)out, st);
  else
    launch_rows((const T*)s, rows, lanes, stride, wmask, emask, (unsigned*)out, st);
}

}  // namespace repro

// dtype: 0 = uint8, 1 = int32.  `out` is one zeroed int32 on the device.
extern "C" int repro_bt_count(const void* s, int dtype, long long rows, long long lanes,
                              long long stride, int width, void* out, void* stream) {
  using namespace repro;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch_bt<uint8_t>(s, rows, lanes, stride, width, out, st);
  else
    launch_bt<int32_t>(s, rows, lanes, stride, width, out, st);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
