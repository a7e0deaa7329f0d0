// quantize_egress: blockwise-symmetric int8 codes of a flat float32 vector.
//
// Replaces the TPU kernel repro/kernels/quantize.py:quantize_egress_pallas
// (body _quant_kernel), which took (256, block) tiles through VMEM and
// fused the per-block abs-max, the scale and the rounding in one pass.
// Here one warp quantizes one block of `block` floats:
//   1. the lanes stride over the block (float4 loads where the block is
//      whole and 16-byte aligned), each keeping a running max of |x|;
//   2. a __shfl_xor_sync max reduction gives the block's amax;
//   3. scale = amax * f32(1/127) -- the multiply XLA makes of the jitted
//      reference's `amax / 127.0`, which differs from IEEE division by one
//      ulp in some blocks -- and safe = scale > 0 ? scale : 1;
//   4. codes = clamp(rint(x / safe), -127, 127) with IEEE division
//      (__fdiv_rn) and round-half-to-even (rintf), stored as int8 (char4
//      where the block is whole), the block's second read hitting L1;
//   5. lane 0 writes the scale.
// The reference runs under XLA, which flushes subnormals (so does a TPU);
// this file is built without -ftz, so it flushes by hand: a subnormal |x|
// counts as 0 in the max and in the division, and a subnormal scale is 0.
// Elements at index >= m read as 0, which is the reference's zero padding
// of the last block without a padded copy of the input.  Offsets are
// 64-bit: a model's flat gradient passes 2**31 elements.
//
// Bound on this card: bytes.  Each element is read once as 4 bytes and
// written once as 1, plus 4 bytes of scale per block, for ~8 float ops per
// element, so the floor is (5 * Mp + 4 * Mp / block) / 3.35 TB/s.
#include "common.cuh"

#include <cfloat>

namespace repro {

constexpr float INV_127 = 0x1.020408p-7f;  // float32(1/127)

// |x| with a subnormal flushed to 0 (x finite)
__device__ __forceinline__ float flushed_abs(float x) {
  const float a = fabsf(x);
  return a < FLT_MIN ? 0.f : a;
}

__device__ __forceinline__ signed char code(float x, float safe) {
  const float xf = fabsf(x) < FLT_MIN ? 0.f : x;
  const float r = fminf(fmaxf(rintf(__fdiv_rn(xf, safe)), -127.f), 127.f);
  return (signed char)(int)r;
}

__global__ void __launch_bounds__(THREADS)
quantize_egress_kernel(const float* __restrict__ x, long long m, long long rows,
                       int block, int vec, signed char* __restrict__ q,
                       float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); r < rows;
       r += warps) {  // r is the same on every lane: the warp stays converged
    const long long lo = r * block;
    const bool v4 = vec && lo + block <= m;
    float amax = 0.f;
    if (v4) {
      const float4* x4 = reinterpret_cast<const float4*>(x + lo);
      for (int i = lane; i < block / 4; i += 32) {
        const float4 v = x4[i];
        amax = fmaxf(amax, fmaxf(fmaxf(flushed_abs(v.x), flushed_abs(v.y)),
                                 fmaxf(flushed_abs(v.z), flushed_abs(v.w))));
      }
    } else {
      for (int i = lane; i < block; i += 32) {
        if (lo + i < m) amax = fmaxf(amax, flushed_abs(x[lo + i]));
      }
    }
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
    float scale = __fmul_rn(amax, INV_127);
    if (scale < FLT_MIN) scale = 0.f;
    const float safe = scale > 0.f ? scale : 1.f;
    if (v4) {
      const float4* x4 = reinterpret_cast<const float4*>(x + lo);
      char4* q4 = reinterpret_cast<char4*>(q + lo);
      for (int i = lane; i < block / 4; i += 32) {
        const float4 v = x4[i];
        q4[i] = make_char4(code(v.x, safe), code(v.y, safe), code(v.z, safe),
                           code(v.w, safe));
      }
    } else {
      for (int i = lane; i < block; i += 32) {
        q[lo + i] = lo + i < m ? code(x[lo + i], safe) : (signed char)0;
      }
    }
    if (lane == 0) scales[r] = scale;
  }
}

}  // namespace repro

// x: m float32; q: rows * block int8; scales: rows float32, with
// rows = ceil(m / block) >= 1.  The float4 / char4 path needs block % 4 == 0
// and a 16-byte aligned x (q is a fresh allocation, so its rows are then
// 4-byte aligned).
extern "C" int repro_quantize_egress(const void* x, long long m, long long rows,
                                     int block, void* q, void* scales,
                                     void* stream) {
  using namespace repro;
  const int vec = block % 4 == 0 && ((uintptr_t)x & 15) == 0;
  long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the warps stride past this
  quantize_egress_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, m, rows, block, vec, (signed char*)q, (float*)scales);
  return (int)cudaGetLastError();
}
