// Eq.-11 weighted aggregation: out[p] = sum_n (w[n] * mask[n]) * x[n, p].
//
// Replaces the Pallas TPU kernels src/repro/kernels/wagg.py:_wagg_kernel
// and _wagg_masked_kernel (launched by wagg_pallas), which tile P into
// VMEM blocks and take an (1, N) x (N, block) dot per grid step.
//
// Bound on the card: device memory. Each x element is read once and used
// once (2 flops per 4 bytes), so at m = 5 and P = 11,506,624 the kernel
// moves about 230 MB in and 46 MB out: about 82 us at 3.35 TB/s.
//
// Design: a streaming reduction with no shared memory and no atomics,
// in one kernel. Each thread owns 4 contiguous columns [4i, 4i + 4). When
// x and out are 16-byte aligned and P % 4 == 0 (so every row starts
// aligned), a thread whose 4 columns all lie inside P reads them with one
// 16-byte load per row; otherwise (the last P % 4 columns, or unaligned
// input) it walks its columns one at a time and stops at P. Either way it
// walks the m rows in registers and writes its columns once. x is read
// with streaming loads (__ldcs) since nothing reuses it. Every column sums
// in ascending n from +0.0 with fmaf, on both branches, so a padding row
// with weight 0 adds fmaf(0, x, acc) == acc exactly: a masked call on a
// padded stack is bitwise equal to the unpadded call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float row_weight(const float* __restrict__ w,
                                            const float* __restrict__ mask,
                                            int n) {
  return mask != nullptr ? w[n] * mask[n] : w[n];
}

__global__ void wagg_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ mask,
                            float* __restrict__ out, int m, long long p,
                            bool aligned) {
  const long long c0 =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (c0 >= p) return;
  if (aligned && c0 + 4 <= p) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long p4 = p / 4, i = c0 / 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n = 0; n < m; ++n) {
      const float wn = row_weight(w, mask, n);
      const float4 v = __ldcs(x4 + (long long)n * p4 + i);
      acc.x = fmaf(wn, v.x, acc.x);
      acc.y = fmaf(wn, v.y, acc.y);
      acc.z = fmaf(wn, v.z, acc.z);
      acc.w = fmaf(wn, v.w, acc.w);
    }
    reinterpret_cast<float4*>(out)[i] = acc;
    return;
  }
  const int cols = (int)(p - c0 < 4 ? p - c0 : 4);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n = 0; n < m; ++n) {
    const float wn = row_weight(w, mask, n);
    const float* row = x + (long long)n * p + c0;
    for (int j = 0; j < cols; ++j) acc[j] = fmaf(wn, __ldcs(row + j), acc[j]);
  }
  for (int j = 0; j < cols; ++j) out[c0 + j] = acc[j];
}

}  // namespace

// x: (m, P) row-major f32; w, mask: (m,) f32 (mask may be null);
// out: (P,) f32. All on the current device; launched on `stream`.
extern "C" int wagg_launch(const void* x, const void* w, const void* mask,
                           void* out, int m, long long p, void* stream) {
  const int threads = 256;
  const bool aligned = (p % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long groups = (p + 3) / 4;
  const long long blocks = (groups + threads - 1) / threads;
  wagg_kernel<<<(unsigned)blocks, threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<float*>(out), m, p,
      aligned);
  return static_cast<int>(cudaGetLastError());
}
