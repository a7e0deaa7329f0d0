// psu_stream: the fused transmit path — sort, reorder, flit-pack and
// (input, weight) BT count of P paired packets in one launch.
//
// Replaces the TPU kernel repro/kernels/axes.py:bt_axes_pallas in its
// emit_stream mode (body _bt_axes_kernel -> _axes_block: one link, one
// uncoded 'acc'/'app' config), whose per-block BT partials and edge flits
// were folded across blocks by repro/kernels/ops.py:_fold_axes.  The TPU
// kernel reordered by a float32 permutation-matrix product; this kernel
// does no float arithmetic at all (a TF32 product would round payloads
// above 2**11).  One warp handles a run of PPW consecutive packets:
//   * it ranks each packet with the one-warp counting sort of common.cuh
//     (ballots of the keys' bit planes, the key width a template argument),
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
#include "common.cuh"

namespace repro {

constexpr int PPW = 8;  // consecutive packets per warp

template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
psu_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  long long P, int n, KeySpec s, int il, int wl, int pack_row,
                  int* __restrict__ order, int* __restrict__ rank,
                  uint8_t* __restrict__ out, unsigned* bt) {
  extern __shared__ unsigned char smem[];
  __shared__ unsigned bal[WARPS][BAL_WORDS];
  __shared__ unsigned part[WARPS][2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lanes = il + wl;
  const int flits = n / il;
  const int img_bytes = flits * lanes;
  unsigned char* img = smem + warp * ((img_bytes + lanes + 15) & ~15);
  unsigned char* last = img + img_bytes;  // previous packet's last flit
  const FastDiv div = make_fast_div(pack_row ? il : flits);

  // rank packet p and lay its bytes out as the (F, lanes) flit image
  auto place = [&](long long p, bool emit) {
    const T* xr = x + p * n;
    const T* wr = wl ? w + p * n : nullptr;
    int* orow = order + p * n;
    int* rrow = rank + p * n;
    warp_rank_row<BITS>(n, s.nb, bal[warp], [&](int i) { return psu_key((unsigned)xr[i], s); },
                        [&](int i, int r) {
      int f, l;
      if (pack_row) {
        f = (int)fast_div(r, div);
        l = r - f * il;
      } else {
        l = (int)fast_div(r, div);
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

}  // namespace repro

namespace {

template <typename T>
auto stream_kernel(int bits) -> decltype(&repro::psu_stream_kernel<T, 0>) {
  switch (bits) {
    case 0: return &repro::psu_stream_kernel<T, 0>;
    case 1: return &repro::psu_stream_kernel<T, 1>;
    case 2: return &repro::psu_stream_kernel<T, 2>;
    case 3: return &repro::psu_stream_kernel<T, 3>;
    case 4: return &repro::psu_stream_kernel<T, 4>;
    default: return &repro::psu_stream_kernel<T, 5>;
  }
}

}  // namespace

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
    stream_kernel<uint8_t>(s.bits)<<<blocks, THREADS, smem, st>>>(
        (const uint8_t*)x, (const uint8_t*)w, P, n, s, il, wl, pack_row,
        (int*)order, (int*)rank, (uint8_t*)out, (unsigned*)bt);
  } else {
    stream_kernel<int32_t>(s.bits)<<<blocks, THREADS, smem, st>>>(
        (const int32_t*)x, (const int32_t*)w, P, n, s, il, wl, pack_row,
        (int*)order, (int*)rank, (uint8_t*)out, (unsigned*)bt);
  }
  return (int)cudaGetLastError();
}
