// Dual-temperature (DT) loss forward over in-batch similarities,
// FLSimCo Eq. 6-8: per anchor row i of sim = q k^T,
//   lse_a = logsumexp_j(sim_ij / tau_a),  lse_b = logsumexp_j(sim_ij / tau_b),
//   pos   = sim_ii,
//   loss  = -(w_b / max(w_a, 1e-8)) * (pos / tau_a - lse_a),
//   w_a = 1 - exp(pos / tau_a - lse_a),  w_b = 1 - exp(pos / tau_b - lse_b).
// Columns j >= n_valid are masked out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dt_loss.py:_dt_fwd_kernel
// (launched by dt_loss_fwd_pallas), which walks (128, 128) tiles on the
// MXU with an online logsumexp at both temperatures and never writes the
// (M, M) matrix.
//
// Bound on the card: at the main path's M = 512, D = 128 the function
// needs 2*M*M*D = 67 MFLOP and reads 0.5 MB, so it is bound by
// operations (about 1 us at the 67 TFLOP/s float32 rate); at this size
// launch latency and the serial chain per row dominate in practice.
//
// Design (simple, CUDA cores): a block of kRows warps takes kRows anchor
// rows, one per warp, and streams the keys through shared memory in tiles
// of 32 (one key per lane). Each lane computes its key's whole dot product
// from shared memory (the anchor row is a broadcast read; key rows are
// padded by 16 bytes so the 16-byte loads of a warp hit distinct banks)
// and keeps its own running max and sum at both temperatures, with one
// exp per key and temperature. The 32 lane states of a row are merged by
// a butterfly shuffle at the end, and nothing but the four (M,) outputs
// is written. It divides by tau (not by a reciprocal multiply), as the
// reference does. No padding of M: the 128-row tiles were a TPU rule.
// Requires D % 4 == 0 and D <= 256 (the wrapper checks). Tensor cores and
// a tiled backward are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 4;    // anchor rows per block, one warp each
constexpr int kTile = 32;   // keys per shared-memory tile, one per lane

__device__ __forceinline__ void online_add(float s, float& m, float& l) {
  if (s > m) {
    l = l * expf(m - s) + 1.f;
    m = s;
  } else {
    l += expf(s - m);
  }
}

__device__ __forceinline__ void merge(float m2, float l2, float& m, float& l) {
  const float mm = fmaxf(m, m2);
  l = l * expf(m - mm) + l2 * expf(m2 - mm);
  m = mm;
}

__global__ void dt_fwd_kernel(const float4* __restrict__ q,
                              const float4* __restrict__ k,
                              float* __restrict__ loss,
                              float* __restrict__ lse_a_out,
                              float* __restrict__ lse_b_out,
                              float* __restrict__ pos_out, int m, int d4,
                              int n_valid, float tau_a, float tau_b) {
  extern __shared__ float4 smem[];
  const int stride = d4 + 1;                 // float4s per padded row
  float4* qs = smem;                         // kRows anchor rows
  float4* ks = smem + kRows * stride;        // kTile key rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + warp;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = threadIdx.x; i < kRows * d4; i += blockDim.x) {
    const int r = i / d4, c = i - r * d4;
    qs[r * stride + c] = (row0 + r < m) ? q[(long long)(row0 + r) * d4 + c]
                                        : zero;
  }

  float m_a = kNeg, l_a = 0.f, m_b = kNeg, l_b = 0.f, pos = 0.f;
  for (int j0 = 0; j0 < n_valid; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q rows are loaded
    for (int i = threadIdx.x; i < kTile * d4; i += blockDim.x) {
      const int r = i / d4, c = i - r * d4;
      ks[r * stride + c] = (j0 + r < n_valid)
                               ? k[(long long)(j0 + r) * d4 + c] : zero;
    }
    __syncthreads();
    const int j = j0 + lane;
    if (row < m && j < n_valid) {
      const float4* qr = qs + warp * stride;
      const float4* kr = ks + lane * stride;
      float s = 0.f;
      for (int c = 0; c < d4; ++c) {
        const float4 a = qr[c], b = kr[c];
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
      if (j == row) pos = s;
      online_add(s / tau_a, m_a, l_a);
      online_add(s / tau_b, m_b, l_b);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ma2 = __shfl_xor_sync(0xffffffffu, m_a, off);
    const float la2 = __shfl_xor_sync(0xffffffffu, l_a, off);
    const float mb2 = __shfl_xor_sync(0xffffffffu, m_b, off);
    const float lb2 = __shfl_xor_sync(0xffffffffu, l_b, off);
    merge(ma2, la2, m_a, l_a);
    merge(mb2, lb2, m_b, l_b);
    pos += __shfl_xor_sync(0xffffffffu, pos, off);  // one lane holds it
  }
  if (lane == 0 && row < m) {
    const float lse_a = m_a + logf(fmaxf(l_a, 1e-30f));
    const float lse_b = m_b + logf(fmaxf(l_b, 1e-30f));
    const float log_pa = pos / tau_a - lse_a;
    const float w_a = 1.f - expf(log_pa);
    const float w_b = 1.f - expf(pos / tau_b - lse_b);
    loss[row] = -(w_b / fmaxf(w_a, 1e-8f)) * log_pa;
    lse_a_out[row] = lse_a;
    lse_b_out[row] = lse_b;
    pos_out[row] = pos;
  }
}

}  // namespace

// q, k: (m, d) row-major f32, 16-byte aligned, d % 4 == 0, d <= 256;
// outputs: four (m,) f32. Launched on `stream`.
extern "C" int dt_loss_fwd_launch(const void* q, const void* k, void* loss,
                                  void* lse_a, void* lse_b, void* pos, int m,
                                  int d, int n_valid, float tau_a, float tau_b,
                                  void* stream) {
  const int d4 = d / 4;
  const int blocks = (m + kRows - 1) / kRows;
  const size_t smem = sizeof(float4) * (kRows + kTile) * (d4 + 1);
  dt_fwd_kernel<<<blocks, kRows * 32, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<float*>(loss), static_cast<float*>(lse_a),
      static_cast<float*>(lse_b), static_cast<float*>(pos), m, d4, n_valid,
      tau_a, tau_b);
  return static_cast<int>(cudaGetLastError());
}
