// bt_count: total bit transitions of a (T, L) flit stream.
//
// Replaces the TPU kernel repro/kernels/btcount.py:bt_count_pallas (body
// _bt_kernel), which reduced per-block int32 partials over two shifted,
// padded copies of the stream.  Here each thread XORs adjacent rows read
// straight from the stream (no copies), popcounts the low `width` bits,
// and each block adds one int32 partial with one atomicAdd.  Unsigned
// atomics wrap modulo 2**32, as the reference's int32 sum does.
//
// Bound on this card: bytes.  Every input byte is read once (its neighbour
// row's re-read hits L1/L2) for ~3 integer ops per byte, far under the
// ALUs' rate, so the floor is T*L*itemsize / 3.35 TB/s.  One thread
// walks one row pair at a time with the row stride as an argument, so
// contiguous streams, column slices (the staged TX path's
// stream[:, :input_lanes]) and int32 streams share one kernel.
#include "common.cuh"

namespace repro {

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
bt_rows_kernel(const T* __restrict__ s, long long rows, long long lanes,
               long long stride, unsigned mask, unsigned* out) {
  unsigned acc = 0;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows - 1; r += step) {
    const T* a = s + r * stride;
    const T* b = a + stride;
    for (long long c = 0; c < lanes; ++c) {
      acc += __popc(((unsigned)a[c] ^ (unsigned)b[c]) & mask);
    }
  }
  block_add(acc, out);
}

inline int grid_for(long long items) {
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  return (int)(blocks < 1 ? 1 : blocks);
}

}  // namespace repro

// dtype: 0 = uint8, 1 = int32.  `out` is one zeroed int32 on the device.
extern "C" int repro_bt_count(const void* s, int dtype, long long rows,
                              long long lanes, long long stride, int width,
                              void* out, void* stream) {
  using namespace repro;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* o = (unsigned*)out;
  const unsigned mask = (1u << width) - 1u;  // width in [1, 16]
  if (dtype == 0) {
    bt_rows_kernel<uint8_t><<<grid_for(rows - 1), THREADS, 0, st>>>(
        (const uint8_t*)s, rows, lanes, stride, mask, o);
  } else {
    bt_rows_kernel<int32_t><<<grid_for(rows - 1), THREADS, 0, st>>>(
        (const int32_t*)s, rows, lanes, stride, mask, o);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
