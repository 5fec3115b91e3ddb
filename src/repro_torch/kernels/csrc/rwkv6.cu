// RWKV6 ("Finch") recurrence, per (batch*head) row, step by step:
//   o_t,e = sum_d r_t,d S_de + beta_t v_t,e,  beta_t = sum_d r_t,d u_d k_t,d,
//   S_de <- S_de w_t,d + k_t,d v_t,e,         w_t,d = exp(logw_t,d) <= 1,
// with S the (D, D) float32 state before step t: the semantics of the
// sequential oracle ref.rwkv6_ref.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py:_rwkv6_kernel
// (launched by rwkv6_pallas), whose grid is (BH, S / 16) with the chunk axis
// run in order and the state in a VMEM scratch buffer.
//
// Bound on the card: device memory. Each (batch*head) row reads r, k, v,
// logw once and writes o once (4 + 1 float32 streams of S x D) plus its
// state. At B = 16, S = 2048, H = 32, D = 64 that is about 1.35 GB, 0.40 ms
// at 3.35 TB/s; the step form does 3 floating-point operations per (t, d, e)
// (two FMAs and a multiply), about 21 GFLOP there, 0.31 ms at 67 TFLOP/s.
//
// The first design (the TPU kernel's chunked form: one block of 256 threads
// per row, the state in shared memory, five phases a chunk of 16 steps)
// took 3.50 ms there on an H100 80GB HBM3 at 700 W. Shared memory bound it:
// its two big phases read both operands of every FMA from shared memory (a
// broadcast and a row of 32 floats, two wavefronts per warp FMA), about 11k
// wavefronts per block per chunk, 45k clocks per chunk step on an SM of four
// blocks, about 3.3 ms over 128 chunks.
//
// This design keeps the state in registers and steps the recurrence. One
// block of D threads per row (64 at D = 64, so 512 rows fit one wave at 4
// blocks an SM); the threads form groups of G = 4, and a group holds G
// state columns: thread `part` of the group holds rows d of all G columns
// for the float4 groups q * G + part of d (D / G x G = 64 floats, every
// index a compile-time constant, so nothing spills). The steps go in slabs
// of T = 8: the block stages a slab's r, k, v, w = exp(logw) (expf once per
// (t, d)) and the per-warp partial sums of beta into shared memory while the
// next slab's r, k, v, logw load into registers; one __syncthreads a slab,
// the slab buffers double. Per step a thread reads r, k, w as float4 groups
// (one broadcast LDS.128 each, shared by the G columns it updates) and does,
// per (d, column),
//   y += r_d s_d;  s_d = fmaf(s_d, w_d, k_d v_e);
// then a reduce-scatter across the group (G - 1 shuffles) leaves each thread
// the full sum of its own column tid, stored coalesced as o = y + beta v.
// The step loop is unrolled by 2. So per (t, d, e) the card issues 3
// floating-point instructions and 3/4G of a shared load; what bounds the
// kernel now is the issue rate of those FMAs (most read three distinct
// registers), not shared memory and not device memory. G = 4, T = 8 and an
// unroll of 2 timed fastest of the group sizes, slab lengths and unrolls
// tried on the card (PERF.md); 64 threads a row.
//
// Layout: r, k, v, logw share one strided layout with unit stride along D:
// element (row, t, d) of row = b * H + h lies at b*sb + h*sh + t*st + d.
// So a (BH, S, D) tensor is H = 1, and the projections' (B, S, H, D) layout
// is read in place. o is written with its own strides (ob, oh, ot); u at
// b*ub + h*uh + d; state0 (may be null: zeros) and state_out are contiguous
// (BH, D, D), element (row, d, e) at (row * D + d) * D + e. Steps at or past
// S are never run, so a ragged S needs no padding and the state returned is
// that of exactly S steps.
#include <cuda_runtime.h>

namespace {

constexpr int G = 4;        // threads of a group; it holds G columns
constexpr int T = 8;        // steps per slab
constexpr int UNROLL = 2;   // steps per turn of the step loop
// blocks an SM the compiler must leave room for: 512 rows over 132 SMs
// run in one wave only at 4 or more
constexpr int MIN_BLOCKS = 4;
static_assert(T % UNROLL == 0, "T must be a multiple of UNROLL");

template <int D>
struct __align__(16) Slab {
  float r[T][D], k[T][D], w[T][D], v[T][D];
  float beta[T][D / 32];   // beta_t, one partial sum per warp along d
};

__device__ __forceinline__ float at(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

template <int D>
__global__ void __launch_bounds__(D, MIN_BLOCKS)
rwkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ lw,
             const float* __restrict__ u, const float* __restrict__ state0,
             float* __restrict__ o, float* __restrict__ state_out, int h,
             int s, long long sb, long long sh, long long st, long long ob,
             long long oh, long long ot, long long ub, long long uh) {
  constexpr int DH = D / G;            // state rows a thread holds
  constexpr int Q = DH / 4;            // its float4 groups along d
  constexpr int NW = D / 32;           // warps across one slab row
  static_assert(Q >= 1, "D / G must be a multiple of 4");
  __shared__ Slab<D> slab[2];

  // Thread tid stages column d = tid of every slab row and, after the
  // reduce-scatter of y across its group, owns output column e = tid.
  const int tid = threadIdx.x;
  const int part = tid % G;            // this thread's share of d
  const int e0 = tid - part;           // the group's first column
  const long long row = blockIdx.x;
  const long long b = row / h, hh = row % h;
  const long long in0 = b * sb + hh * sh + tid;
  const long long out0 = b * ob + hh * oh + tid;
  const float ud = u[b * ub + hh * uh + tid];

  // sc[j][4q + i] = S[4 (q G + part) + i][e0 + j]
  float sc[G][DH];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * (q * G + part) + i;
        sc[j][4 * q + i] =
            state0 != nullptr ? state0[(row * D + d) * D + e0 + j] : 0.f;
      }

  // the next slab's inputs: rows t0 .. t0 + T - 1 of column tid
  float pr[T], pk[T], pv[T], pl[T];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      pr[j] = pk[j] = pv[j] = pl[j] = 0.f;
      if (t0 + j < s) {
        const long long off = in0 + (long long)(t0 + j) * st;
        pr[j] = r[off];
        pk[j] = k[off];
        pv[j] = v[off];
        pl[j] = lw[off];
      }
    }
  };
  auto stage = [&](Slab<D>& x) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      x.r[j][tid] = pr[j];
      x.k[j][tid] = pk[j];
      x.v[j][tid] = pv[j];
      x.w[j][tid] = expf(pl[j]);
      float bt = pr[j] * ud * pk[j];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) bt += __shfl_xor_sync(~0u, bt, m);
      if ((tid & 31) == 0) x.beta[j][tid / 32] = bt;
    }
  };
  // one step: o_t for column tid, the state's G columns carried to t + 1
  auto step = [&](const Slab<D>& x, int t, long long t_abs) {
    const float4* r4 = reinterpret_cast<const float4*>(x.r[t]) + part;
    const float4* k4 = reinterpret_cast<const float4*>(x.k[t]) + part;
    const float4* w4 = reinterpret_cast<const float4*>(x.w[t]) + part;
    float ve[G], yc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      ve[j] = x.v[t][e0 + j];
      yc[j] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 rr = r4[q * G], kk = k4[q * G], ww = w4[q * G];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& sv = sc[j][4 * q + i];
          yc[j] = fmaf(at(rr, i), sv, yc[j]);
          sv = fmaf(sv, at(ww, i), at(kk, i) * ve[j]);
        }
    }
    // reduce-scatter across the group: after the stage of offset m the
    // thread keeps the half of its 2m sums that its bit m selects, so
    // yc[0] ends as column e0 + part = tid summed over all of d
#pragma unroll
    for (int m = G / 2; m > 0; m >>= 1) {
      const bool upper = (part & m) != 0;
#pragma unroll
      for (int i = 0; i < m; ++i) {
        const float send = upper ? yc[i] : yc[i + m];
        const float keep = upper ? yc[i + m] : yc[i];
        yc[i] = keep + __shfl_xor_sync(~0u, send, m);
      }
    }
    float beta = x.beta[t][0];
#pragma unroll
    for (int w = 1; w < NW; ++w) beta += x.beta[t][w];
    o[out0 + t_abs * ot] = fmaf(beta, x.v[t][tid], yc[0]);
  };

  fetch(0);
  stage(slab[0]);
  if (T < s) fetch(T);
  __syncthreads();
  for (int t0 = 0, n = 0; t0 < s; t0 += T, ++n) {
    const Slab<D>& cur = slab[n & 1];
    if (t0 + T < s) {   // uniform across the block
      stage(slab[(n + 1) & 1]);
      if (t0 + 2 * T < s) fetch(t0 + 2 * T);
    }
    const int nt = min(T, s - t0);
    int t = 0;
    for (; t + UNROLL <= nt; t += UNROLL)
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) step(cur, t + i, t0 + t + i);
    for (; t < nt; ++t) step(cur, t, t0 + t);
    __syncthreads();   // cur is free for the slab after next
  }

#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * (q * G + part) + i;
        state_out[(row * D + d) * D + e0 + j] = sc[j][4 * q + i];
      }
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* state0, void* o,
                   void* state_out, int bh, int h, int s, long long sb,
                   long long sh, long long st, long long ob, long long oh,
                   long long ot, long long ub, long long uh,
                   cudaStream_t stream) {
  rwkv6_kernel<D><<<bh, D, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(state0),
      static_cast<float*>(o), static_cast<float*>(state_out), h, s, sb, sh,
      st, ob, oh, ot, ub, uh);
  return cudaGetLastError();
}

template <int D>
cudaError_t attributes(int* out) {
  const void* fn = reinterpret_cast<const void*>(&rwkv6_kernel<D>);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, D, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  out[4] = D;
  out[5] = T;
  return err;
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

// The instance for head size d (32 or 64) on the current device: out[0..5]
// = registers a thread, local (spill) bytes a thread, static shared bytes
// a block, blocks an SM can hold, threads a block (one row), steps a slab.
extern "C" int rwkv6_attributes(int d, int* out) {
  cudaError_t err;
  if (d == 64)
    err = attributes<64>(out);
  else if (d == 32)
    err = attributes<32>(out);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
