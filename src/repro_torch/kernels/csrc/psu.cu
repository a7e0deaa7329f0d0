// psu_sort: the popcount-sorting unit (ACC-PSU / APP-PSU), order and rank.
//
// Replaces the TPU kernel repro/kernels/psu.py:psu_sort_pallas (body
// _psu_kernel with _popcount_bits / _rank_from_keys / _rank_block), which
// built (BP, N, K) one-hot and (BP, N, N) selection tensors in VMEM and
// wrote `order` by a one-hot compare + sum.  On Hopper one warp sorts one
// packet row: __popc gives the key, a <= 17-bucket histogram in shared
// memory plus a warp scan gives the bucket starts, __match_any_sync gives
// each element's earlier-equal count, and `order[rank[i]] = i` is a plain
// integer scatter.  No padding: rows past P are masked by the grid.
//
// Bound on this card: bytes.  Per element it reads the input once (the
// second pass re-reads it from L1) and writes 8 bytes of order + rank; the
// work is a handful of integer ops, so the floor is
// P*N*(itemsize + 8) / 3.35 TB/s.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(THREADS)
psu_sort_kernel(const T* __restrict__ x, long long P, int n, KeySpec s,
                int* __restrict__ order, int* __restrict__ rank) {
  __shared__ int hist[WARPS][32];
  const int warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * WARPS + warp;
  if (p >= P) return;  // whole warp leaves together
  const T* row = x + p * n;
  int* orow = order + p * n;
  int* rrow = rank + p * n;
  warp_rank(row, n, s, hist[warp], [&](int i, int r) {
    rrow[i] = r;
    orow[r] = i;
  });
}

}  // namespace repro

// dtype: 0 = uint8, 1 = int32; k == 0 selects ACC.  P >= 1, 1 <= n.
extern "C" int repro_psu_sort(const void* x, int dtype, long long P, int n,
                              int width, int k, int desc, void* order,
                              void* rank, void* stream) {
  using namespace repro;
  cudaStream_t st = (cudaStream_t)stream;
  const KeySpec s = make_key_spec(width, k, desc);
  const long long blocks = (P + WARPS - 1) / WARPS;
  if (dtype == 0) {
    psu_sort_kernel<uint8_t><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const uint8_t*)x, P, n, s, (int*)order, (int*)rank);
  } else {
    psu_sort_kernel<int32_t><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const int32_t*)x, P, n, s, (int*)order, (int*)rank);
  }
  return (int)cudaGetLastError();
}
