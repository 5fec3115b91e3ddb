// RWKV6 ("Finch") chunked recurrence, per (batch*head) row:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
// w_t = exp(logw_t), with the (D, D) float32 state carried across chunks of
// C = 16 steps.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py:_rwkv6_kernel
// (launched by rwkv6_pallas), whose grid is (BH, S / 16) with the chunk axis
// run in order and the state in a VMEM scratch buffer.
//
// Bound on the card: device memory. Each (batch*head) row reads r, k, v,
// logw once and writes o once (4 + 1 float32 streams of S x D) plus its
// state; the arithmetic is about 350 kFLOP per chunk of 16 x 64, about
// 17 FLOP per byte moved, just below the float32 ridge of 67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte. At B = 16, S = 2048, H = 32, D = 64 that is
// about 1.35 GB, 0.40 ms at 3.35 TB/s.
//
// Design (a simple one; tensor cores, TMA and several rows per block are
// later work). Blocks run in no order on Hopper, so the TPU's sequential
// grid axis becomes a loop inside the block: one block of 256 threads per
// (batch*head) row holds the state in shared memory and walks the chunks.
// Per chunk, with __syncthreads between the phases:
//   A. load the chunk's r, k, v, logw (C x D each) into shared memory;
//      rows past S load r = k = v = 0 and logw = 0 (no decay), so a ragged
//      last chunk leaves the state exactly that of S steps;
//   B. one thread per column d: cum = prefix sum of logw over the chunk in
//      ascending t, cum_prev = cum - logw, a = r * exp(cum_prev),
//      kdec = k * exp(cum_C - cum), exp(cum_C);
//   C. one thread per (i, j): scores_ij = sum_d r_id k_jd exp(cum_prev_id -
//      cum_jd) for j < i and the bonus sum_d r_id u_d k_id on the diagonal;
//   D. o_ie = sum_d a_id S_de + sum_{j<=i} scores_ij v_je, stored for t < S;
//   E. S_de = S_de exp(cum_C,d) + sum_j kdec_jd v_je.
// Every exponent is taken after the subtraction, so each factor used is
// <= 1, as the reference's layer does (models/layers.py rwkv_tmix_chunked).
// The tiles read across lanes along d (r, k, cum, cum_prev) are padded to
// D + 1 columns, so the 16 rows phase C reads at once fall in 16 banks.
//
// Layout: r, k, v, logw share one strided layout with unit stride along D:
// element (row, t, d) of row = b * H + h lies at b*sb + h*sh + t*st + d.
// So a (BH, S, D) tensor is H = 1, and the projections' (B, S, H, D) layout
// is read in place. o is written with its own strides (ob, oh, ot); u at
// b*ub + h*uh + d; state0 (may be null: zeros) and state_out are contiguous
// (BH, D, D).
#include <cuda_runtime.h>

namespace {

constexpr int C = 16;
constexpr int THREADS = C * C;   // phase C: one thread per (i, j)

template <int D>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ lw,
             const float* __restrict__ u, const float* __restrict__ state0,
             float* __restrict__ o, float* __restrict__ state_out, int h,
             int s, long long sb, long long sh, long long st, long long ob,
             long long oh, long long ot, long long ub, long long uh) {
  constexpr int DP = D + 1;
  __shared__ float sr[C][DP], sk[C][DP], scum[C][DP], scp[C][DP];
  __shared__ float sv[C][D], sa[C][D], skd[C][D];
  __shared__ float sS[D][D];
  __shared__ float ssc[C][C + 1];
  __shared__ float setot[D], su[D];

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const long long b = row / h, hh = row % h;
  const long long in0 = b * sb + hh * sh;
  const long long out0 = b * ob + hh * oh;

  for (int i = tid; i < D; i += THREADS) su[i] = u[b * ub + hh * uh + i];
  for (int i = tid; i < D * D; i += THREADS)
    sS[i / D][i % D] = state0 != nullptr ? state0[row * D * D + i] : 0.f;

  for (int t0 = 0; t0 < s; t0 += C) {
    __syncthreads();   // the previous chunk's phase E is done with sv, skd
    // A. load the chunk
    for (int i = tid; i < C * D; i += THREADS) {
      const int t = i / D, d = i % D;
      float rv = 0.f, kv = 0.f, vv = 0.f, lv = 0.f;
      if (t0 + t < s) {
        const long long off = in0 + (long long)(t0 + t) * st + d;
        rv = r[off];
        kv = k[off];
        vv = v[off];
        lv = lw[off];
      }
      sr[t][d] = rv;
      sk[t][d] = kv;
      sv[t][d] = vv;
      scum[t][d] = lv;   // logw, turned into cum in place by phase B
    }
    __syncthreads();
    // B. per-column prefix sums and the decayed r and k
    if (tid < D) {
      const int d = tid;
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float l = scum[t][d];
        acc += l;
        const float cp = acc - l;
        scum[t][d] = acc;
        scp[t][d] = cp;
        sa[t][d] = sr[t][d] * expf(cp);
      }
      for (int t = 0; t < C; ++t) skd[t][d] = sk[t][d] * expf(acc - scum[t][d]);
      setot[d] = expf(acc);
    }
    __syncthreads();
    // C. intra-chunk scores (j < i) and the bonus (j == i)
    {
      const int i = tid / C, j = tid % C;
      float acc = 0.f;
      if (j < i) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc = fmaf(sr[i][d] * sk[j][d], expf(scp[i][d] - scum[j][d]), acc);
      } else if (j == i) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(sr[i][d] * su[d], sk[i][d], acc);
      }
      ssc[i][j] = acc;
    }
    __syncthreads();
    // D. the chunk's outputs
    for (int idx = tid; idx < C * D; idx += THREADS) {
      const int i = idx / D, e = idx % D;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(sa[i][d], sS[d][e], acc);
      for (int j = 0; j <= i; ++j) acc = fmaf(ssc[i][j], sv[j][e], acc);
      if (t0 + i < s) o[out0 + (long long)(t0 + i) * ot + e] = acc;
    }
    __syncthreads();
    // E. carry the state to the end of the chunk
    for (int idx = tid; idx < D * D; idx += THREADS) {
      const int d = idx / D, e = idx % D;
      float acc = sS[d][e] * setot[d];
#pragma unroll
      for (int j = 0; j < C; ++j) acc = fmaf(skd[j][d], sv[j][e], acc);
      sS[d][e] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < D * D; i += THREADS)
    state_out[row * D * D + i] = sS[i / D][i % D];
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* state0, void* o,
                   void* state_out, int bh, int h, int s, long long sb,
                   long long sh, long long st, long long ob, long long oh,
                   long long ot, long long ub, long long uh,
                   cudaStream_t stream) {
  rwkv6_kernel<D><<<bh, THREADS, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(o), static_cast<float*>(state_out), h, s, sb, sh,
      st, ob, oh, ot, ub, uh);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, logw: float32 in the strided layout above; u: float32 (strides
// ub, uh); state0: (bh, d, d) float32 or null; o: float32 (strides ob, oh,
// ot); state_out: (bh, d, d) float32. bh blocks, one per row; d is 32 or 64.
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* lw, const void* u, const void* state0,
                            void* o, void* state_out, int bh, int h, int s,
                            int d, long long sb, long long sh, long long st,
                            long long ob, long long oh, long long ot,
                            long long ub, long long uh, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = launch<64>(r, k, v, lw, u, state0, o, state_out, bh, h, s, sb, sh,
                     st, ob, oh, ot, ub, uh, cs);
  else if (d == 32)
    err = launch<32>(r, k, v, lw, u, state0, o, state_out, bh, h, s, sb, sh,
                     st, ob, oh, ot, ub, uh, cs);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
