// Dual-temperature (DT) loss forward over in-batch similarities,
// FLSimCo Eq. 6-8: per anchor row i of sim = q k^T,
//   lse_a = logsumexp_j(sim_ij / tau_a),  lse_b = logsumexp_j(sim_ij / tau_b),
//   pos   = sim_ii,
//   loss  = -(w_b / max(w_a, 1e-8)) * (pos / tau_a - lse_a),
//   w_a = 1 - exp(pos / tau_a - lse_a),  w_b = 1 - exp(pos / tau_b - lse_b).
// Columns j >= n_valid are masked out. A launch takes a cohort of C such
// problems, (C, M, D) q and k, one per client, and writes four (C, M)
// outputs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dt_loss.py:_dt_fwd_kernel
// (launched by dt_loss_fwd_pallas), which walks (128, 128) tiles on the
// MXU with an online logsumexp at both temperatures and never writes the
// (M, M) matrix.
//
// Bound on the card: at the main path's M = 512, D = 128 the function
// needs 2*M*M*D = 67 MFLOP and reads 0.5 MB, so it is bound by
// operations: about 1 us at the 67 TFLOP/s float32 rate. At that size the
// time goes to a serial chain of latencies (launch, the first TMA copy,
// the products, the merges across the cluster), not to bandwidth. A
// chunk of C clients needs C times the work; its clients run side by side
// on the SMs, so the chain of latencies is paid about once a launch.
//
// Design (Hopper):
// * The cohort. Client z is grid row blockIdx.y; its q and k are the z-th
//   (M, D) slices of 3-D tensor maps (D, M, C) whose boxes are one client
//   deep, so a tile never reads the next client's rows: the hardware
//   fills rows past M with zeros, as it does at the ragged edge of one
//   matrix. The clients of a chunk share one launch (core/clients.py).
// * Parallelism. A thread-block cluster of kCluster = 8 CTAs takes 32
//   anchor rows (two m16 tiles of mma.m16n8k8) and splits the keys: CTA
//   rank r walks the 64-key tiles r, r + 8, r + 16, ... At M = 512 that
//   is ceil(M/32) * 8 = 128 CTAs, about one per SM, each with one key
//   tile. Each of 4 warps owns 16 keys of the tile (two n8 fragments) and
//   computes its 32 x 16 block of sim, so a key fragment feeds both row
//   tiles and each byte of K read from L2 serves 32 rows.
// * Tensor cores in 3xTF32: every float32 operand x is split into
//   hi = rna_tf32(x) and lo = rna_tf32(x - hi), and hi*hi, hi*lo and lo*hi
//   are accumulated in float32 in three accumulators. One TF32 product
//   keeps about 11 bits, which moves sim / tau_a by 1e-3; the three keep
//   about 22, within the float32 tolerance. The rounding is done with
//   integer ops, in place of the slower cvt.rna.tf32 instruction. mma.sync
//   and not wgmma: 512 rows give 8 tiles of 64 rows, far too few to feed
//   wgmma on 132 SMs, and the cluster split needs small row tiles.
// * Staging by TMA. Q (32 x D) and each warp's 16 keys come by tensor
//   copies (cp.async.bulk.tensor) in boxes of 32 columns with the 128-byte
//   swizzle, each warp's on its own mbarrier, issued as the kernel starts.
//   The hardware fills rows past M and columns past D with zeros, which
//   pads D to the mma's k8 and the ragged row and key edges. The swizzle
//   permutes the 16-byte units of a row by row % 8, so the fragment loads
//   of a warp hit 32 distinct banks. Q is split into its hi and lo parts
//   once, in shared memory. A warp reloads its slice only for a next key
//   tile (M > 512), after its reads; one buffer, since on the main path
//   every CTA has exactly one tile.
// * Epilogue. After a key tile each thread multiplies its 16 values of
//   sim by 1/tau (1/tau computed once in float32, as PyTorch's own
//   sim / tau does on the card for a scalar tau) and folds them into a
//   running max and sum at both temperatures for its four rows. The
//   states are merged across the lanes of a quad by shuffles, across the
//   warps through shared memory (a quad of threads a row), and across the
//   cluster in rank 0's shared memory: each CTA writes its state there
//   through distributed shared memory and arrives on rank 0's mbarrier,
//   and rank 0 merges the 8 states in a fixed order and writes the four
//   (M,) outputs. Each merge takes one max and rescales once. pos is taken
//   where the key equals the row and summed with the zeros of every other
//   state. No atomics: two calls are bitwise equal. No CTA reads another's
//   shared memory, and rank 0 waits for every CTA's arrival, so no CTA
//   exits while its shared memory is still in use; a split cluster barrier
//   (arrive at the start, wait before the writes) makes sure rank 0's
//   barrier is set up.
// Requires D % 4 == 0 and D <= 256 (the wrapper checks).
//
// The wide form, dt_fwd_wide_kernel, takes the zoo's features (the final
// hidden state of a token model, D = d_model: 2048 for rwkv6-1.6b and
// tinyllama-1.1b, 896 for qwen2-0.5b, 4608 for gemma2-27b, 8192 for
// deepseek-67b) with M = a micro-batch's rows (8 on the training path):
// 256 < D <= 8192,
// D % 4 == 0, the same four outputs, the same cohort layout. At
// (8, 2048) it needs 0.26 MFLOP and 0.13 MB, a few microseconds of
// latency whatever the design; at (512, 2048), 1.07 GFLOP, bound by
// operations (16 us at 67 TFLOP/s). A simple design: a CTA takes
// kWideRows anchor rows of one client and holds them in shared memory;
// each of its 8 warps walks the keys j = warp, warp + 8, ..., its lanes
// reading k_j in float4 units (coalesced) and taking the kWideRows dot
// products in float32 FMAs, summed across the warp by shuffles; every
// lane then folds sim / tau into the running (max, sum) at both
// temperatures, and the warps' states are merged in shared memory in a
// fixed order (no atomics: two calls are bitwise equal). Each CTA reads
// all M keys from L2, so at M = 512 the reads, not the FMAs, set its
// time. The anchor rows live in dynamic shared memory sized to D
// (kWideRows * D floats, 128 KB at kWideMaxD = 8192, the widest d_model
// of the zoo: deepseek-67b), above the default 48 KB only after the
// opt-in, made once a device at the first launch; at D = 8192 one CTA
// fills an SM's shared memory, at D = 2048 (32 KB) several do.
#include <cooperative_groups.h>
#include <cuda.h>   // CUtensorMap and its encoder's types (no libcuda link)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr int kCluster = 8;     // CTAs a cluster, splitting the keys
constexpr int kMTiles = 2;      // m16 tiles of anchor rows a cluster
constexpr int kRows = 16 * kMTiles;
constexpr int kWarps = 4;       // warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kWarpKeys = 16;   // keys a warp: two n8 fragments
constexpr int kFrags = kWarpKeys / 8;
constexpr int kKeys = kWarps * kWarpKeys;  // keys a CTA tile
constexpr int kMaxD = 256;
constexpr int kState = 5;       // m_a, l_a, m_b, l_b, pos
constexpr int kBox = 32;        // floats of D a TMA box: 128 bytes, swizzled

// Shared memory, in 128-byte rows of kBox floats, one region per 32-column
// chunk of D: Q, Q's lo part, then each warp's slice of keys; plus the
// slack that aligns the base to the 1024 bytes the swizzle needs.
constexpr size_t smem_bytes(int chunks) {
  return 4 * size_t(kBox) * (2 * kRows + kKeys) * chunks + 1024;
}

// Float offset of (row r, column c) in a region of 32-column chunks of
// `rows` rows, as the TMA's 128-byte swizzle lays it out: the 16-byte
// units of a row are permuted by r % 8.
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c >> 5) * rows * kBox + r * kBox +
         ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// The bits of cvt.rna.tf32.f32 for finite x, with integer ops: half a TF32
// ULP added to the magnitude, the 13 low bits cut.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a * b on the tensor cores, a 16x8 (row), b 8x8 (col), TF32 in,
// float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies the box of `map` at (column c0, row r0) of client z into shared
// memory with the TMA engine (rows and columns past the client's matrix
// come as zeros); the transfer completes its bytes on barrier `bar`.
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int c0, int r0, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// One arrival on `bar` that also expects `bytes` of transactions.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void init_barrier(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

// Waits for phase `phase` of `bar` and acquires what the cluster's
// arrivals released.
__device__ __forceinline__ void wait_phase_cluster(uint64_t* bar,
                                                   unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta"
        ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// Merges N partial states (m_a, l_a, m_b, l_b, pos), value v of the i-th
// at load(i, v), in order: one max, then independent exps (a chain of
// pairwise merges would serialise them).
template <int N, typename Load>
__device__ __forceinline__ void merge_states(Load load, float (&out)[kState]) {
  float st[N][kState];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int v = 0; v < kState; ++v) st[i][v] = load(i, v);
  float ma = kNeg, mb = kNeg, la = 0.f, lb = 0.f, p = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ma = fmaxf(ma, st[i][0]);
    mb = fmaxf(mb, st[i][2]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    la += st[i][1] * expf(st[i][0] - ma);
    lb += st[i][3] * expf(st[i][2] - mb);
    p += st[i][4];
  }
  out[0] = ma;
  out[1] = la;
  out[2] = mb;
  out[3] = lb;
  out[4] = p;
}

// Merges the states of the four lanes of each lane quad (lanes that
// differ in their two low bits): one max, one rescale, then sums; every
// lane of the quad ends with the same state.
__device__ __forceinline__ void quad_merge(float& m_a, float& l_a, float& m_b,
                                           float& l_b, float& pos) {
  float ma = m_a, mb = m_b;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  }
  float la = l_a * expf(m_a - ma), lb = l_b * expf(m_b - mb);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
    pos += __shfl_xor_sync(0xffffffffu, pos, off);
  }
  m_a = ma;
  l_a = la;
  m_b = mb;
  l_b = lb;
}

// Folds the values v[i] into the running (m, l); a masked value is kNeg
// and adds nothing. Branch-free: every exp is taken and the masked ones
// are selected away, so the exps of a thread overlap.
__device__ __forceinline__ void fold(const float (&v)[2 * kFrags], float& m,
                                     float& l) {
  float mt = v[0];
#pragma unroll
  for (int i = 1; i < 2 * kFrags; ++i) mt = fmaxf(mt, v[i]);
  const float mm = fmaxf(m, mt);
  float lt = l * expf(m - mm);
#pragma unroll
  for (int i = 0; i < 2 * kFrags; ++i) {
    const float e = expf(v[i] - mm);
    lt += v[i] > kNeg ? e : 0.f;
  }
  m = mm;
  l = lt;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    dt_fwd_mma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      float* __restrict__ loss, float* __restrict__ lse_a_out,
                      float* __restrict__ lse_b_out,
                      float* __restrict__ pos_out, int m, int d, int n_valid,
                      float inv_a, float inv_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float part[kWarps][kState][kRows];       // each warp's states
  __shared__ float gather[kCluster][kState][kRows];   // rank 0: every CTA's
  // a barrier for each warp's slice, one for Q, one (rank 0's) for gather
  __shared__ __align__(8) uint64_t bars[kWarps + 2];
  uint64_t* q_bar = &bars[kWarps];
  uint64_t* gather_bar = &bars[kWarps + 1];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kCluster) * kRows;
  const int z = blockIdx.y;                // the client
  loss += size_t(z) * m;
  lse_a_out += size_t(z) * m;
  lse_b_out += size_t(z) * m;
  pos_out += size_t(z) * m;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group and thread in group

  const int dp = (d + 7) & ~7;             // D padded to the mma's k8
  const int chunks = (d + kBox - 1) / kBox;
  float* qs = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* qlo = qs + chunks * kRows * kBox;        // Q's TF32 hi, then lo
  float* slice =
      qlo + chunks * kRows * kBox + warp * chunks * kWarpKeys * kBox;
  const int n_tiles = (n_valid + kKeys - 1) / kKeys;

  // this warp's kWarpKeys keys of key tile rank + kCluster * i, one box a
  // chunk; returns the keys that exist (0: nothing issued)
  auto load_slice = [&](int i) {
    const int key0 = (rank + kCluster * i) * kKeys + warp * kWarpKeys;
    const int rows = min(kWarpKeys, n_valid - key0);
    if (rows > 0 && lane == 0) {
      expect_bytes(&bars[warp], 4u * kBox * kWarpKeys * chunks);
      for (int c = 0; c < chunks; ++c)
        tma_box(slice + c * kWarpKeys * kBox, &k_map, c * kBox, key0, z,
                &bars[warp]);
    }
    return rows;
  };

  // each warp sets up its own barrier and starts its copies at once
  if (lane == 0) {
    init_barrier(&bars[warp], 1);
    if (warp == 0) {
      init_barrier(q_bar, 1);
      init_barrier(gather_bar, kCluster * kRows);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  int rows = rank < n_tiles ? load_slice(0) : 0;
  if (warp == 0 && lane == 0 && rank < n_tiles) {   // Q rows row0 ..
    expect_bytes(q_bar, 4u * kBox * kRows * chunks);
    for (int c = 0; c < chunks; ++c)
      tma_box(qs + c * kRows * kBox, &q_map, c * kBox, row0, z, q_bar);
  }
  // arrive now, wait before touching rank 0's shared memory at the end
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  __syncthreads();   // the Q barrier is set up for every warp

  if (rank < n_tiles) {   // split Q once into its TF32 hi and lo parts
    wait_phase(q_bar, 0);
    for (int i = 4 * tid; i < chunks * kRows * kBox; i += 4 * kThreads) {
      float4* x = reinterpret_cast<float4*>(qs + i);
      const float4 v = *x;
      uint32_t h[4], l[4];
      split(v.x, h[0], l[0]);
      split(v.y, h[1], l[1]);
      split(v.z, h[2], l[2]);
      split(v.w, h[3], l[3]);
      *x = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                       __uint_as_float(h[2]), __uint_as_float(h[3]));
      *reinterpret_cast<float4*>(qlo + i) =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                      __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
  }
  __syncthreads();

  // running states of this thread's rows mt * 16 + g + 8 h, as [2 mt + h]
  constexpr int kMine = 2 * kMTiles;
  float m_a[kMine], l_a[kMine], m_b[kMine], l_b[kMine], pos[kMine];
#pragma unroll
  for (int r = 0; r < kMine; ++r) {
    m_a[r] = m_b[r] = kNeg;
    l_a[r] = l_b[r] = pos[r] = 0.f;
  }
  unsigned phase = 0;
  for (int i = 0; rows > 0; ++i) {
    wait_phase(&bars[warp], phase);
    phase ^= 1;
    // the big products and the two small ones, in separate accumulators
    float big[kMTiles][kFrags][4] = {}, lohi[kMTiles][kFrags][4] = {},
          hilo[kMTiles][kFrags][4] = {};
#pragma unroll 1
    for (int c = 0; c < dp; c += 8) {
      // columns c + t and c + 4 + t of rows r with r % 8 == g
      const int u0 = swz(kWarpKeys, g, c + t);
      const int u1 = swz(kWarpKeys, g, c + 4 + t);
      uint32_t bhi[kFrags][2], blo[kFrags][2];
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
        split(slice[u0 + 8 * f * kBox], bhi[f][0], blo[f][0]);
        split(slice[u1 + 8 * f * kBox], bhi[f][1], blo[f][1]);
      }
      const int v0 = swz(kRows, g, c + t), v1 = swz(kRows, g, c + 4 + t);
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const int a0 = v0 + 16 * mt * kBox, a1 = a0 + 8 * kBox;
        const int a2 = v1 + 16 * mt * kBox, a3 = a2 + 8 * kBox;
        const uint32_t ahi[4] = {
            __float_as_uint(qs[a0]), __float_as_uint(qs[a1]),
            __float_as_uint(qs[a2]), __float_as_uint(qs[a3])};
        const uint32_t alo[4] = {
            __float_as_uint(qlo[a0]), __float_as_uint(qlo[a1]),
            __float_as_uint(qlo[a2]), __float_as_uint(qlo[a3])};
#pragma unroll
        for (int f = 0; f < kFrags; ++f) {
          mma(lohi[mt][f], alo, bhi[f][0], bhi[f][1]);
          mma(hilo[mt][f], ahi, blo[f][0], blo[f][1]);
          mma(big[mt][f], ahi, bhi[f][0], bhi[f][1]);
        }
      }
    }
    // fold the tile: keys key0 + 8 f + e of this thread's rows
    const int key0 = (rank + kCluster * i) * kKeys + warp * kWarpKeys + 2 * t;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * mt + h, row = row0 + 16 * mt + g + 8 * h;
        float va[2 * kFrags], vb[2 * kFrags];
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 2 * f + e, key = key0 + 8 * f + e, c = 2 * h + e;
            const float sim =
                big[mt][f][c] + (lohi[mt][f][c] + hilo[mt][f][c]);
            const bool ok = key < n_valid;
            pos[r] = key == row ? sim : pos[r];
            va[j] = ok ? sim * inv_a : kNeg;
            vb[j] = ok ? sim * inv_b : kNeg;
          }
        fold(va, m_a[r], l_a[r]);
        fold(vb, m_b[r], l_b[r]);
      }
    if (rank + kCluster * (i + 1) >= n_tiles) break;
    // the slice is read: order those reads before the next copy into it
    __syncwarp();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    rows = load_slice(i + 1);
  }

  // this CTA's state of each row: the quad's four lanes, then the warps
#pragma unroll
  for (int r = 0; r < kMine; ++r) {
    quad_merge(m_a[r], l_a[r], m_b[r], l_b[r], pos[r]);
    if (t == 0) {
      const int row = 16 * (r / 2) + g + 8 * (r % 2);
      part[warp][0][row] = m_a[r];
      part[warp][1][row] = l_a[r];
      part[warp][2][row] = m_b[r];
      part[warp][3][row] = l_b[r];
      part[warp][4][row] = pos[r];
    }
  }
  __syncthreads();
  // a quad of threads a row: thread 4 row + w reads warp w's state
  static_assert(kThreads == 4 * kRows && kWarps == 4 && kCluster % 4 == 0,
                "a quad of threads merges a row");
  const int row = tid >> 2, w = tid & 3;
  float st[kState];
#pragma unroll
  for (int v = 0; v < kState; ++v) st[v] = part[w][v][row];
  quad_merge(st[0], st[1], st[2], st[3], st[4]);
  // every CTA has started, so rank 0's gather barrier is set up
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (w == 0) {   // into rank 0's gather, released to its barrier
    float* dst = cluster.map_shared_rank(&gather[rank][0][row], 0);
#pragma unroll
    for (int v = 0; v < kState; ++v) dst[v * kRows] = st[v];
    unsigned bar;
    asm("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(bar)
        : "r"(smem_addr(gather_bar)));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
                 ::"r"(bar) : "memory");
  }
  if (rank != 0) return;   // nothing reads another CTA's shared memory
  wait_phase_cluster(gather_bar, 0);
  // thread 4 row + w merges CTAs w, w + 4, ... of the row, then the quad
  merge_states<kCluster / 4>(
      [&](int c, int v) { return gather[w + 4 * c][v][row]; }, st);
  quad_merge(st[0], st[1], st[2], st[3], st[4]);
  const float ma = st[0], la = st[1], mb = st[2], lb = st[3], p = st[4];
  if (w == 0 && row0 + row < m) {
    const float lse_a = ma + logf(fmaxf(la, 1e-30f));
    const float lse_b = mb + logf(fmaxf(lb, 1e-30f));
    const float log_pa = p * inv_a - lse_a;
    const float w_a = 1.f - expf(log_pa);
    const float w_b = 1.f - expf(p * inv_b - lse_b);
    loss[row0 + row] = -__fdiv_rn(w_b, fmaxf(w_a, 1e-8f)) * log_pa;
    lse_a_out[row0 + row] = lse_a;
    lse_b_out[row0 + row] = lse_b;
    pos_out[row0 + row] = p;
  }
}

constexpr int kWideMaxD = 8192;
constexpr int kWideRows = 4;       // anchor rows a CTA, in shared memory
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;

__global__ void __launch_bounds__(kWideThreads)
    dt_fwd_wide_kernel(const float* __restrict__ q,
                       const float* __restrict__ k, float* __restrict__ loss,
                       float* __restrict__ lse_a_out,
                       float* __restrict__ lse_b_out,
                       float* __restrict__ pos_out, int m, int d, int n_valid,
                       float inv_a, float inv_b) {
  extern __shared__ __align__(16) float qs[];   // kWideRows rows of d
  __shared__ float part[kWideWarps][kState][kWideRows];
  const int z = blockIdx.y;                // the client
  const int row0 = blockIdx.x * kWideRows;
  const size_t mat = size_t(z) * m * d;
  q += mat;
  k += mat;
  const int d4 = d / 4;
  for (int i = threadIdx.x; i < kWideRows * d4; i += kWideThreads) {
    const int r = i / d4, c = i - r * d4;
    reinterpret_cast<float4*>(qs + r * d)[c] =
        row0 + r < m
            ? reinterpret_cast<const float4*>(q + size_t(row0 + r) * d)[c]
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m_a[kWideRows], l_a[kWideRows], m_b[kWideRows], l_b[kWideRows],
      pos[kWideRows];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    m_a[r] = m_b[r] = kNeg;
    l_a[r] = l_b[r] = pos[r] = 0.f;
  }
  for (int j = warp; j < n_valid; j += kWideWarps) {
    const float4* kj = reinterpret_cast<const float4*>(k + size_t(j) * d);
    float acc[kWideRows] = {};
    for (int c = lane; c < d4; c += 32) {
      const float4 kv = kj[c];
#pragma unroll
      for (int r = 0; r < kWideRows; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(qs + r * d)[c];
        acc[r] = fmaf(qv.x, kv.x, acc[r]);
        acc[r] = fmaf(qv.y, kv.y, acc[r]);
        acc[r] = fmaf(qv.z, kv.z, acc[r]);
        acc[r] = fmaf(qv.w, kv.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      const float sim = acc[r];            // the same in every lane
      pos[r] = j == row0 + r ? sim : pos[r];
      const float va = sim * inv_a, vb = sim * inv_b;
      const float ma = fmaxf(m_a[r], va), mb = fmaxf(m_b[r], vb);
      l_a[r] = l_a[r] * expf(m_a[r] - ma) + expf(va - ma);
      l_b[r] = l_b[r] * expf(m_b[r] - mb) + expf(vb - mb);
      m_a[r] = ma;
      m_b[r] = mb;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      part[warp][0][r] = m_a[r];
      part[warp][1][r] = l_a[r];
      part[warp][2][r] = m_b[r];
      part[warp][3][r] = l_b[r];
      part[warp][4][r] = pos[r];
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= kWideRows || row0 + r >= m) return;
  float st[kState];
  merge_states<kWideWarps>([&](int w, int v) { return part[w][v][r]; }, st);
  const float lse_a = st[0] + logf(fmaxf(st[1], 1e-30f));
  const float lse_b = st[2] + logf(fmaxf(st[3], 1e-30f));
  const float p = st[4];
  const float log_pa = p * inv_a - lse_a;
  const float w_a = 1.f - expf(log_pa);
  const float w_b = 1.f - expf(p * inv_b - lse_b);
  const size_t out = size_t(z) * m + row0 + r;
  loss[out] = -__fdiv_rn(w_b, fmaxf(w_a, 1e-8f)) * log_pa;
  lse_a_out[out] = lse_a;
  lse_b_out[out] = lse_b;
  pos_out[out] = p;
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(dt_fwd_mma_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes(kMaxD / kBox)));
}

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime's
// entry-point query, so this library needs no link against libcuda.
using EncodeFn = decltype(&cuTensorMapEncodeTiled);

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// The (c, m, d) row-major float32 tensor at `ptr` in boxes of kBox
// columns by `rows` rows of one of the c matrices, 128-byte swizzled,
// zeros past each matrix's edges.
bool encode(CUtensorMap* map, const void* ptr, int c, int m, int d,
            int rows) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(m), cuuint64_t(c)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 4, cuuint64_t(m) * d * 4};
  const cuuint32_t box[3] = {cuuint32_t(kBox), cuuint32_t(rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k: (c, m, d) row-major f32, 16-byte aligned, d % 4 == 0, d <= 256;
// outputs: four (c, m) f32. One launch for the c clients, on `stream`.
extern "C" int dt_loss_fwd_launch(const void* q, const void* k, void* loss,
                                  void* lse_a, void* lse_b, void* pos, int c,
                                  int m, int d, int n_valid, float tau_a,
                                  float tau_b, void* stream) {
  if (c < 1 || c > 65535 || m < 1 || d < 4 || d > kMaxD || d % 4 ||
      n_valid < 1 || n_valid > m)
    return static_cast<int>(cudaErrorInvalidValue);
  // the tiles pass 48 KB: raise the kernel's limit once per device
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !ready[dev])) {
    err = allow_smem();
    if (err == cudaSuccess && dev < 64) ready[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_map, k_map;
  if (!encode(&q_map, q, c, m, d, kRows) ||
      !encode(&k_map, k, c, m, d, kWarpKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kCluster * ((m + kRows - 1) / kRows), c);
  dt_fwd_mma_kernel<<<grid, kThreads, smem_bytes((d + kBox - 1) / kBox),
                      static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, static_cast<float*>(loss), static_cast<float*>(lse_a),
      static_cast<float*>(lse_b), static_cast<float*>(pos), m, d, n_valid,
      1.f / tau_a, 1.f / tau_b);
  return static_cast<int>(cudaGetLastError());
}

// On the current device: out[0..5] = registers a thread, local (spill)
// bytes a thread, shared bytes a CTA at d (dynamic + static), CTAs an SM
// can hold at d, threads a CTA, CTAs a cluster.
extern "C" int dt_loss_attributes(int d, int* out) {
  if (d < 4 || d > kMaxD || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, dt_fwd_mma_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes((d + kBox - 1) / kBox);
  int blocks = 0;   // 0 where the occupancy calculator declines
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dt_fwd_mma_kernel, kThreads, smem) != cudaSuccess) {
    blocks = 0;
    cudaGetLastError();     // do not leave the error for the next launch
  }
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem + a.sharedSizeBytes);
  out[3] = blocks;
  out[4] = kThreads;
  out[5] = kCluster;
  return 0;
}

// The wide form: q, k (c, m, d) row-major f32, 16-byte aligned,
// d % 4 == 0, 256 < d <= 8192; the same four (c, m) outputs, on `stream`.
extern "C" int dt_loss_fwd_wide_launch(const void* q, const void* k,
                                       void* loss, void* lse_a, void* lse_b,
                                       void* pos, int c, int m, int d,
                                       int n_valid, float tau_a, float tau_b,
                                       void* stream) {
  if (c < 1 || c > 65535 || m < 1 || d <= kMaxD || d > kWideMaxD || d % 4 ||
      n_valid < 1 || n_valid > m)
    return static_cast<int>(cudaErrorInvalidValue);
  // the rows pass 48 KB above d = 3072: raise the limit once per device
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !ready[dev])) {
    err = cudaFuncSetAttribute(
        dt_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kWideRows * kWideMaxD * sizeof(float)));
    if (err == cudaSuccess && dev < 64) ready[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kWideRows - 1) / kWideRows, c);
  dt_fwd_wide_kernel<<<grid, kWideThreads, kWideRows * d * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(loss), static_cast<float*>(lse_a),
      static_cast<float*>(lse_b), static_cast<float*>(pos), m, d, n_valid,
      1.f / tau_a, 1.f / tau_b);
  return static_cast<int>(cudaGetLastError());
}
