// Blockwise-int8 delta codec: q8_encode and q8_decode.
//
// Replaces the Pallas TPU kernels src/repro/kernels/qdelta.py:
// _q8_encode_kernel (launched by q8_encode_pallas) and _q8_decode_kernel
// (launched by q8_decode_pallas), which hold an (N, BT) VMEM tile per grid
// step and reduce each 256-wide sub-block along the lanes.
//
//   encode: y = delta + ef; per 256-block scale = absmax * f32(1/127);
//           inv = scale > 0 ? 1/scale : 0;
//           codes = clamp(round_half_even(y * inv), -127, 127) as int8;
//           new_ef = y - codes * scale
//   decode: out = codes * scale
//
// Bound on the card: device memory. Encode reads delta and ef and writes
// codes, new_ef and one scale per 256 elements, 13.02 bytes per element for
// a handful of flops: at N = 5, P = 11,506,688 that is 748.8 MB, 0.224 ms at
// 3.35 TB/s. Decode moves 5.02 bytes per element: 288.6 MB, 0.086 ms.
//
// Design: every byte crosses device memory once, in wide accesses. One warp
// owns one 256-element block (P % 256 == 0, so a block never straddles two
// rows and the (N, P) matrix is N * P / 256 blocks in a row). Each lane owns
// 8 consecutive elements: two 16-byte loads of delta and two of ef (rows are
// 16-byte aligned), one 8-byte store of its codes, two 16-byte stores of its
// residuals; lane 0 writes the scale. The block's absmax is a
// __shfl_xor_sync max reduction, exact in any order. Nothing is reused, so
// loads and stores are streaming (__ldcs / __stcs). Decode mirrors it.
//
// Bitwise equal to the plain version (kernels/ref.py q8_encode_ref): the
// same single roundings in the same order. 1/scale is the IEEE division
// (__fdiv_rn; the build uses no fast-math flag); rintf rounds half to even
// and the clamp happens in float before the int8 cast; the residual rounds
// the product before the subtract (__fmul_rn, __fsub_rn), where nvcc would
// otherwise contract y - c * scale into one FMA. 1.0f / 127.0f is the same
// float as numpy's float32(1 / 127). Inputs are finite, as model deltas are:
// fmaxf drops a NaN that torch.amax keeps, and a block whose absmax lies in
// (0, 127 * 2^-128) has an infinite 1/scale; neither case is matched.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 256;              // elements sharing one scale
constexpr int kPerLane = kBQ / 32;    // 8 consecutive elements per lane
constexpr int kThreads = 256;         // 8 warps, so 8 blocks per CTA
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ uint32_t pack4(const int* c) {
  return (uint32_t)(c[0] & 0xff) | ((uint32_t)(c[1] & 0xff) << 8) |
         ((uint32_t)(c[2] & 0xff) << 16) | ((uint32_t)(c[3] & 0xff) << 24);
}

__device__ __forceinline__ float code_at(uint32_t word, int j) {
  return (float)(int8_t)((word >> (8 * j)) & 0xff);
}

__global__ void q8_encode_kernel(const float* __restrict__ x,
                                 const float* __restrict__ ef,
                                 int8_t* __restrict__ codes,
                                 float* __restrict__ scales,
                                 float* __restrict__ new_ef,
                                 long long nblocks) {
  const long long blk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (blk >= nblocks) return;   // whole warps leave together
  const long long off = blk * kBQ + lane * kPerLane;
  const float4* x4 = reinterpret_cast<const float4*>(x + off);
  const float4* e4 = reinterpret_cast<const float4*>(ef + off);
  const float4 a0 = __ldcs(x4), a1 = __ldcs(x4 + 1);
  const float4 b0 = __ldcs(e4), b1 = __ldcs(e4 + 1);
  const float y[kPerLane] = {
      __fadd_rn(a0.x, b0.x), __fadd_rn(a0.y, b0.y), __fadd_rn(a0.z, b0.z),
      __fadd_rn(a0.w, b0.w), __fadd_rn(a1.x, b1.x), __fadd_rn(a1.y, b1.y),
      __fadd_rn(a1.z, b1.z), __fadd_rn(a1.w, b1.w)};
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) amax = fmaxf(amax, fabsf(y[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = __fmul_rn(amax, kInv127);
  const float inv = scale > 0.f ? __fdiv_rn(1.0f, scale) : 0.f;
  int c[kPerLane];
  float r[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(y[j], inv)), -127.f), 127.f);
    c[j] = (int)q;
    r[j] = __fsub_rn(y[j], __fmul_rn((float)c[j], scale));
  }
  __stcs(reinterpret_cast<uint2*>(codes + off),
         make_uint2(pack4(c), pack4(c + 4)));
  float4* n4 = reinterpret_cast<float4*>(new_ef + off);
  __stcs(n4, make_float4(r[0], r[1], r[2], r[3]));
  __stcs(n4 + 1, make_float4(r[4], r[5], r[6], r[7]));
  if (lane == 0) scales[blk] = scale;
}

__global__ void q8_decode_kernel(const int8_t* __restrict__ codes,
                                 const float* __restrict__ scales,
                                 float* __restrict__ out, long long nblocks) {
  const long long blk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (blk >= nblocks) return;
  const long long off = blk * kBQ + lane * kPerLane;
  const uint2 w = __ldcs(reinterpret_cast<const uint2*>(codes + off));
  const float s = __ldg(scales + blk);
  float o[kPerLane];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[j] = __fmul_rn(code_at(w.x, j), s);
    o[j + 4] = __fmul_rn(code_at(w.y, j), s);
  }
  float4* o4 = reinterpret_cast<float4*>(out + off);
  __stcs(o4, make_float4(o[0], o[1], o[2], o[3]));
  __stcs(o4 + 1, make_float4(o[4], o[5], o[6], o[7]));
}

unsigned ctas_for(long long nblocks) {
  return (unsigned)((nblocks * 32 + kThreads - 1) / kThreads);
}

}  // namespace

// delta, ef, new_ef: (N, P) row-major f32; codes: (N, P) int8;
// scales: (N, P / 256) f32; n_elems = N * P with P % 256 == 0. delta, ef
// and new_ef 16-byte aligned, codes 8-byte aligned. Launched on `stream`.
extern "C" int q8_encode_launch(const void* delta, const void* ef,
                                void* codes, void* scales, void* new_ef,
                                long long n_elems, void* stream) {
  const long long nblocks = n_elems / kBQ;
  if (nblocks > 0) {
    q8_encode_kernel<<<ctas_for(nblocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(delta), static_cast<const float*>(ef),
        static_cast<int8_t*>(codes), static_cast<float*>(scales),
        static_cast<float*>(new_ef), nblocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// codes: (N, P) int8, 8-byte aligned; scales: (N, P / 256) f32;
// out: (N, P) f32, 16-byte aligned; n_elems = N * P with P % 256 == 0.
extern "C" int q8_decode_launch(const void* codes, const void* scales,
                                void* out, long long n_elems, void* stream) {
  const long long nblocks = n_elems / kBQ;
  if (nblocks > 0) {
    q8_decode_kernel<<<ctas_for(nblocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
        static_cast<float*>(out), nblocks);
  }
  return static_cast<int>(cudaGetLastError());
}
