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
// hidden state of a token model, D = d_model: 896 for qwen2-0.5b, 1024
// for seamless-m4t-large-v2, 1600 for hymba-1.5b, 2048 for rwkv6-1.6b,
// tinyllama-1.1b and olmoe-1b-7b, 4608 for gemma2-27b, 7168 for
// kimi-k2-1t-a32b, 8192 for deepseek-67b and llama-3.2-vision-90b):
// 256 < D <= 8192, D % 4 == 0, the same four outputs, the same cohort
// layout. M is a DT micro-batch's rows: 1 to 16 on the zoo's `dt` step.
//
// Bound on the card. At M <= 16 the work is tiny ((8, 8192): 3 x 1.07
// MFLOP of TF32 products, 0.52 MB read): the time is a chain of latencies
// (launch, the first TMA copies, a CTA's share of the products, the
// gather and sum in rank 0), so the design spreads the D
// columns over the 8 CTAs of a cluster and moves few, large boxes. At M =
// 512 it is bound by operations ((512, 8192): 3 x 2 M^2 D = 12.9 GFLOP of
// TF32 products, 26 us at 495 TFLOP/s) once L2 traffic is cut: a simple
// design that re-reads every key for each 4 rows moves 2.1 GB of L2 at
// (512, 8192).
//
// Design (Hopper), one kernel, two ways of splitting a cluster's work:
// * A thread-block cluster of kWideCluster = 8 CTAs owns kWideRows = 32
//   anchor rows of one client (two m16 tiles of mma.m16n8k8). A CTA tile
//   is those rows against kWideKeys = 64 keys in 4 key blocks of 16 (two
//   n8 fragments); each key block has nph of the kWideWarps = 8 consumer
//   warps ("phases"), which take every nph-th k8 step of a stage, and one
//   producer warp feeds them. Two consumer warps a scheduler: a warp's k8
//   step is a chain (fragment load -> TF32 split -> mma) that one warp a
//   scheduler cannot hide.
// * The split rule (dt_loss_fwd_wide_launch). Where the keys fit one key
//   tile (n_valid <= 64: every published micro-batch), the cluster's ranks
//   split D: rank r takes the r-th run of ceil(stages / 8) stages, and nph
//   = 8 / (key blocks with keys) (8 at M <= 16). Each warp's partial tile
//   goes to its CTA's shared memory; the CTA sums its phases in order for
//   every (row, key) that exists and stores the sums in rank 0's gather
//   region (past its ring) through distributed shared memory, arriving on
//   rank 0's mbarrier; rank 0 sums the ranks in order and runs the
//   epilogue. At (8, 8192) each CTA reads 64 KB in 3 stages and rank 0
//   receives 8 x 64 sums. Where there are more keys, the ranks split the
//   key tiles as the narrow kernel does (rank r walks tiles r, r + 8, ...),
//   each over all of D with nph = 2: at a tile's end phase 1 hands its
//   partials to phase 0 through shared memory, which folds them into
//   logsumexp states; after a cluster barrier the ranks' states go to rank
//   0's ring and are merged there. At M = 512 that is 16 clusters x 8
//   CTAs, one key tile each; the registers are held to two CTAs an SM,
//   since at one not all 16 clusters of 8 fit the GPCs at once and the
//   last ran as a second wave. A CTA reads its 32 rows and 64 keys over
//   all of D, so the L2 traffic is 128 x (32 + 64) x D x 4 bytes: 403 MB
//   at D = 8192 (K read by 16 clusters, Q by the 8 CTAs of its cluster; a
//   TMA multicast of Q would cut it to 285 MB and is not done).
// * Columns of D staged by TMA. A ring of kWideStages = 4 slots of 24 KB in
//   dynamic shared memory (97 KB at every D: D sets the number of stages,
//   not a CTA's footprint; 65 KB more for rank 0's gather in split D), on
//   a full and an empty mbarrier a slot. A stage holds kWideStageCols = 64
//   columns of the 32 rows and 64 keys; smaller tiles (M < 32: boxes of M
//   rows padded to 8) take as many 64-column runs as fit the slot (384
//   columns at M <= 8) but no more than give every rank a stage. Where D %
//   32 == 0 (every d_model of the zoo) the tensor maps are 4-D (32
//   columns, rows, 32-column blocks, clients), so one copy brings a
//   stage's q rows and one its keys, laid out block after block with the
//   128-byte swizzle; else one copy a 32-column block. A copy costs its
//   issuing thread about the same whatever its size, so few large copies
//   is what keeps M <= 16 fast; the producer sets up the barriers
//   and issues the first stages before the CTA's first barrier. The
//   hardware fills rows past M and columns past D with zeros.
// * Tensor cores in 3xTF32, as the narrow kernel: hi = rna_tf32(x), lo =
//   rna_tf32(x - hi), split after the fragment loads (ldmatrix: four 8 x 4
//   blocks of 32-bit words in one instruction, conflict-free under the
//   swizzle); hi*hi in one accumulator, lo*hi and hi*lo in a second, a
//   partial being big + small (three accumulators cost the registers of
//   the second CTA an SM). mma.sync and not wgmma: wgmma takes 64-row
//   tiles, which only M >= 64 fills (the published micro-batches are 1 to
//   16 rows), and both splits want many small CTAs. A warp skips its
//   second m16 tile and second n8 fragment where they hold no row or key.
// * Epilogue, as the narrow kernel: 1/tau computed once in float32; keys
//   at or past n_valid masked; pos where the key equals the row; online
//   logsumexp at both temperatures; merges in a fixed order. No atomics:
//   two calls are bitwise equal. One pass, one launch.
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
constexpr int kWideCluster = 8;     // CTAs a cluster
constexpr int kWideRows = 32;       // anchor rows a cluster: two m16 tiles
constexpr int kWideKeys = 64;       // keys a CTA tile
constexpr int kWideWarps = 8;       // consumer warps a CTA
constexpr int kWideBlocks = 4;      // key blocks of 16 a CTA tile
constexpr int kWideStages = 4;      // stages of the ring
constexpr int kWideStageCols = 64;  // columns of D a stage at M >= 32
constexpr int kWideThreads = 32 * (kWideWarps + 1);   // + the producer
// a ring slot: kWideStageCols columns of the 32 rows and 64 keys (24 KB);
// a smaller tile (M < 32) takes a multiple of those columns into it
constexpr int kWideSlot = kWideStageCols * (kWideRows + kWideKeys);
constexpr size_t kWideSmem = 4 * size_t(kWideSlot) * kWideStages + 1024;
// After the loop a CTA's ring takes its warps' partial tiles [warp][row]
// [key] (split D) or, in rank 0, every rank's states [rank][key block]
// [state][row] (split keys). In split D, rank 0 gathers every rank's
// summed tile [rank][row][key] past its ring (rows padded), which the
// ranks fill while it may still be computing.
constexpr int kWidePitch = kWarpKeys + 1;
constexpr int kWidePart = kWideWarps * kWideRows * kWidePitch;
constexpr int kWideSumPitch = kWideKeys + 1;
constexpr size_t kWideGather =
    4 * size_t(kWideCluster) * kWideRows * kWideSumPitch;
static_assert(kWideRows == 16 * kMTiles &&
                  kWideKeys == kWideBlocks * kWarpKeys &&
                  kWideWarps == 2 * kWideBlocks,
              "a warp tile is two m16 tiles by two n8 fragments, two warps "
              "(phases) a key block");
static_assert(kWideStageCols % kBox == 0 && kWideSlot % 256 == 0,
              "stages of whole boxes, 1024-byte aligned");
static_assert(kWidePart <= kWideSlot * kWideStages &&
                  kWideCluster * kWideBlocks * kState * kWideRows <=
                      kWideSlot * kWideStages,
              "a CTA's ring holds its partial tiles, rank 0's the states");

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Four (two) 8 x 4 blocks of 32-bit words of shared memory, row
// addresses from lanes 0-31 (0-15): lane 4 g + t gets word t of row g of
// each block, an m16n8k8 TF32 fragment's layout.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// The box of the 4-D `map` ((C, D / 32, M, 32) seen as 32 columns, rows,
// blocks of 32 columns, clients) at row r0 and column block b0 of client z:
// every 32-column block of a stage in one copy.
__device__ __forceinline__ void tma_box4(float* dst, const CUtensorMap* map,
                                         int r0, int b0, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(r0), "r"(b0), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// q_map and k_map: (C, M, D) in boxes of qr (kr) rows, 4-D (one copy of
// every block of a stage) where D % 32 == 0, else 3-D (one copy a block).
// A stage is stage_cols columns. rank_chunks > 0: the ranks split D, rank
// r taking stages [r * rank_chunks, (r + 1) * rank_chunks); 0: they split
// the key tiles.
__global__ void __cluster_dims__(kWideCluster, 1, 1)
    __launch_bounds__(kWideThreads, 2)
        dt_fwd_wide_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           float* __restrict__ loss,
                           float* __restrict__ lse_a_out,
                           float* __restrict__ lse_b_out,
                           float* __restrict__ pos_out, int m, int d,
                           int n_valid, int rank_chunks, int stage_cols,
                           int qr, int kr, float inv_a, float inv_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWideStages], empty[kWideStages];
  __shared__ __align__(8) uint64_t gather_bar;   // split D: rank 0's sums
  // split-keys: a key tile's phase-1 partials, handed to phase 0
  __shared__ float xchg[kWideBlocks][kWideRows][kWidePitch];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kWideCluster) * kWideRows;
  const int z = blockIdx.y;                // the client
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma group and thread in group
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const bool split_d = rank_chunks > 0;
  const bool whole = d % kBox == 0;        // 4-D maps
  const int blocks = stage_cols / kBox;    // 32-column blocks a stage
  const int chunks = (d + stage_cols - 1) / stage_cols;
  const int n_tiles = (n_valid + kWideKeys - 1) / kWideKeys;
  const int n_steps =
      split_d ? max(0, min(rank_chunks, chunks - rank * rank_chunks))
              : (rank < n_tiles
                     ? (n_tiles - rank + kWideCluster - 1) / kWideCluster *
                           chunks
                     : 0);
  // step i: the key tile at key0 over the stage of columns at col0
  auto step_at = [&](int i, int& key0, int& col0) {
    if (split_d) {
      key0 = 0;
      col0 = (rank * rank_chunks + i) * stage_cols;
    } else {
      key0 = (rank + kWideCluster * (i / chunks)) * kWideKeys;
      col0 = (i % chunks) * stage_cols;
    }
  };

  // stage i of the ring into slot i % kWideStages (the producer's lane 0)
  auto issue = [&](int i) {
    const int s = i % kWideStages;
    int key0, col0;
    step_at(i, key0, col0);
    float* qdst = ring + s * kWideSlot;
    float* kdst = qdst + blocks * qr * kBox;
    if (whole) {   // blocks past D come as zeros
      expect_bytes(&full[s], 4u * kBox * blocks * (qr + kr));
      tma_box4(qdst, &q_map, row0, col0 / kBox, z, &full[s]);
      tma_box4(kdst, &k_map, key0, col0 / kBox, z, &full[s]);
    } else {       // the blocks that start before D
      const int nb = min(blocks, (d - col0 + kBox - 1) / kBox);
      expect_bytes(&full[s], 4u * kBox * nb * (qr + kr));
      for (int b = 0; b < nb; ++b) {
        tma_box(qdst + b * qr * kBox, &q_map, col0 + b * kBox, row0, z,
                &full[s]);
        tma_box(kdst + b * kr * kBox, &k_map, col0 + b * kBox, key0, z,
                &full[s]);
      }
    }
  };
  // the producer's lane 0 sets up the barriers and fills the ring before
  // the CTA's first barrier, so the first copies are in flight early
  if (warp == kWideWarps && lane == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      init_barrier(&full[s], 1);
      init_barrier(&empty[s], kWideWarps);
    }
    init_barrier(&gather_bar, kWideCluster * 32 * kWideWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(n_steps, kWideStages); ++i) issue(i);
  }
  __syncthreads();
  // split D: arrive now (the barriers' set-up is already fenced), wait
  // before the first store into rank 0
  if (split_d)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // key blocks of 16 that hold keys, and the nph warps that share each,
  // each taking every nph-th k8 step of a stage
  const int nkb =
      split_d ? (n_valid <= kWarpKeys ? 1 : n_valid <= 2 * kWarpKeys ? 2 : 4)
              : kWideBlocks;
  const int kb = warp % nkb, ph = warp / nkb, nph = kWideWarps / nkb;
  const int mts = row0 + 16 < m ? kMTiles : 1;   // m16 tiles with rows
  // the big products, and the two small ones in a second accumulator
  float big[kMTiles][kFrags][4] = {}, small[kMTiles][kFrags][4] = {};
  constexpr int kMine = 2 * kMTiles;   // rows mt * 16 + g + 8 h, [2 mt + h]
  float m_a[kMine], l_a[kMine], m_b[kMine], l_b[kMine], pos[kMine];
#pragma unroll
  for (int r = 0; r < kMine; ++r) {
    m_a[r] = m_b[r] = kNeg;
    l_a[r] = l_b[r] = pos[r] = 0.f;
  }

  if (warp == kWideWarps) {   // the producer: lane 0 keeps the ring full
    if (lane == 0)
      for (int i = kWideStages; i < n_steps; ++i) {
        wait_phase(&empty[i % kWideStages], (i / kWideStages - 1) & 1);
        issue(i);
      }
  } else {
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kWideStages;
      int key0, col0;
      step_at(i, key0, col0);
      const int kkey = key0 + kb * kWarpKeys;   // this warp's first key
      wait_phase(&full[s], (i / kWideStages) & 1);
      if (kkey < n_valid) {
        const float* qs = ring + s * kWideSlot;
        const float* ks = qs + blocks * qr * kBox + kb * kWarpKeys * kBox;
        const int fs = kkey + 8 < n_valid ? kFrags : 1;   // n8 with keys
        const int steps = (min(stage_cols, d - col0) + 7) / 8;
#pragma unroll 1
        for (int kk = ph; kk < steps; kk += nph) {
          const int c = 8 * kk;
          // lane 8 i + r gives row r of block i: blocks (keys 0-7, c),
          // (keys 0-7, c + 4), (keys 8-15, c), (keys 8-15, c + 4)
          const int i8 = lane >> 3, r8 = lane & 7;
          uint32_t bw[4], bhi[kFrags][2], blo[kFrags][2];
          const float* kp = ks + swz(kr, r8 + 8 * (i8 >> 1), c + 4 * (i8 & 1));
          if (fs == kFrags) ldsm4(bw, kp); else ldsm2(bw, kp);
#pragma unroll
          for (int f = 0; f < kFrags; ++f)
            if (f < fs) {
              split(__uint_as_float(bw[2 * f]), bhi[f][0], blo[f][0]);
              split(__uint_as_float(bw[2 * f + 1]), bhi[f][1], blo[f][1]);
            }
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt)
            if (mt < mts) {
              // blocks (rows 0-7, c), (8-15, c), (0-7, c + 4), (8-15, c + 4)
              uint32_t aw[4], ahi[4], alo[4];
              ldsm4(aw, qs + swz(qr, 16 * mt + r8 + 8 * (i8 & 1),
                                 c + 4 * (i8 >> 1)));
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split(__uint_as_float(aw[e]), ahi[e], alo[e]);
#pragma unroll
              for (int f = 0; f < kFrags; ++f)
                if (f < fs) mma(small[mt][f], alo, bhi[f][0], bhi[f][1]);
#pragma unroll
              for (int f = 0; f < kFrags; ++f)
                if (f < fs) mma(big[mt][f], ahi, bhi[f][0], bhi[f][1]);
#pragma unroll
              for (int f = 0; f < kFrags; ++f)
                if (f < fs) mma(small[mt][f], ahi, blo[f][0], blo[f][1]);
            }
        }
      }
      __syncwarp();
      if (lane == 0) arrive(&empty[s]);   // this warp has read the stage
      if (split_d || (i + 1) % chunks) continue;
      // the key tile is done: phase 1 hands its partials to phase 0,
      // which folds keys kkey + 8 f + 2 t + e of this thread's rows
      // (sim = phase 0's + phase 1's); both restart their sums from zero
      float* x = &xchg[kb][0][0];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& v = x[(16 * mt + g + 8 * (c >> 1)) * kWidePitch + 8 * f +
                         2 * t + (c & 1)];
            const float own = big[mt][f][c] + small[mt][f][c];
            if (ph == 1) v = own;
            big[mt][f][c] = own;   // phase 0 adds phase 1's after the barrier
            small[mt][f][c] = 0.f;
          }
      asm volatile("bar.sync %0, 64;" ::"r"(2 + kb) : "memory");
      if (ph == 0) {
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
                const int j = 2 * f + e, key = kkey + 8 * f + 2 * t + e;
                const int c = 2 * h + e;
                const float sim =
                    big[mt][f][c] +
                    x[(16 * mt + g + 8 * h) * kWidePitch + 8 * f + 2 * t + e];
                const bool ok = key < n_valid;
                pos[r] = key == row ? sim : pos[r];
                va[j] = ok ? sim * inv_a : kNeg;
                vb[j] = ok ? sim * inv_b : kNeg;
              }
            fold(va, m_a[r], l_a[r]);
            fold(vb, m_b[r], l_b[r]);
          }
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
#pragma unroll
          for (int c = 0; c < 4; ++c) big[mt][f][c] = 0.f;
      // phase 0 has read the exchange before phase 1 writes the next tile's
      asm volatile("bar.sync %0, 64;" ::"r"(2 + kb) : "memory");
    }
  }

  if (split_d) {
    // this warp's partial tile into this CTA's ring, [warp][row][key];
    // then the consumer threads sum the phases of each (row, key) that
    // exists, in order, into rank 0's gather [rank][row][key], and arrive
    // on rank 0's barrier
    if (warp < kWideWarps) {
      // every consumer warp is done reading the ring
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kWideWarps) : "memory");
      float* part = ring + warp * kWideRows * kWidePitch;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int f = 0; f < kFrags; ++f)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[(16 * mt + g + 8 * (c >> 1)) * kWidePitch + 8 * f + 2 * t +
                 (c & 1)] = big[mt][f][c] + small[mt][f][c];
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kWideWarps) : "memory");
    }
    __syncwarp();
    // every CTA has started, so rank 0's gather barrier is set up
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (warp == kWideWarps) return;
    float* sums = cluster.map_shared_rank(ring + kWideSlot * kWideStages, 0) +
                  rank * kWideRows * kWideSumPitch;
    const int rows = min(kWideRows, m - row0);
    for (int e = tid; e < rows * n_valid; e += 32 * kWideWarps) {
      const int row = e / n_valid, j = e % n_valid;
      const float* p = ring + (j / kWarpKeys) * kWideRows * kWidePitch +
                       row * kWidePitch + j % kWarpKeys;
      float sum = p[0];
      for (int q = 1; q < nph; ++q) sum += p[q * nkb * kWideRows * kWidePitch];
      sums[row * kWideSumPitch + j] = sum;
    }
    unsigned bar;
    asm("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(bar)
        : "r"(smem_addr(&gather_bar)));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
                 ::"r"(bar) : "memory");
    if (rank != 0) return;   // nothing reads another CTA's shared memory
    wait_phase_cluster(&gather_bar, 0);
    if (warp >= 4) return;
  } else {
    // every CTA is done with its ring: rank 0's now takes the states,
    // [rank][key block][state][row], from the phase-0 warps
    __syncwarp();
    cluster.sync();
    if (warp < kWideBlocks) {
      float* dst = cluster.map_shared_rank(ring, 0) +
                   (rank * kWideBlocks + warp) * kState * kWideRows;
#pragma unroll
      for (int r = 0; r < kMine; ++r) {
        quad_merge(m_a[r], l_a[r], m_b[r], l_b[r], pos[r]);
        if (t == 0) {
          const int row = 16 * (r / 2) + g + 8 * (r % 2);
          dst[0 * kWideRows + row] = m_a[r];
          dst[1 * kWideRows + row] = l_a[r];
          dst[2 * kWideRows + row] = m_b[r];
          dst[3 * kWideRows + row] = l_b[r];
          dst[4 * kWideRows + row] = pos[r];
        }
      }
    }
    __syncwarp();
    cluster.sync();   // the writes are visible to rank 0
    if (rank != 0 || warp >= 4) return;
  }

  // a quad of threads a row: thread 4 row + w
  static_assert(4 * 32 == 4 * kWideRows, "a quad of threads a row");
  const int row = tid >> 2, w = tid & 3;
  float st[kState];
  if (split_d) {
    // keys w, w + 4, ...: each similarity summed over the ranks in order,
    // then folded one at a time
    st[0] = st[2] = kNeg;
    st[1] = st[3] = st[4] = 0.f;
    const float* sums = ring + kWideSlot * kWideStages + row * kWideSumPitch;
    for (int j = w; j < n_valid; j += 4) {
      float sim = 0.f;
#pragma unroll
      for (int r = 0; r < kWideCluster; ++r)
        sim += sums[r * kWideRows * kWideSumPitch + j];
      st[4] = j == row0 + row ? sim : st[4];
      const float va = sim * inv_a, vb = sim * inv_b;
      const float ma = fmaxf(st[0], va), mb = fmaxf(st[2], vb);
      st[1] = st[1] * expf(st[0] - ma) + expf(va - ma);
      st[3] = st[3] * expf(st[2] - mb) + expf(vb - mb);
      st[0] = ma;
      st[2] = mb;
    }
  } else {
    // key block w's states of the row across the ranks, in rank order
    merge_states<kWideCluster>(
        [&](int r, int v) {
          return ring[((r * kWideBlocks + w) * kState + v) * kWideRows + row];
        },
        st);
  }
  quad_merge(st[0], st[1], st[2], st[3], st[4]);
  if (w != 0 || row0 + row >= m) return;
  const float lse_a = st[0] + logf(fmaxf(st[1], 1e-30f));
  const float lse_b = st[2] + logf(fmaxf(st[3], 1e-30f));
  const float p = st[4];
  const float log_pa = p * inv_a - lse_a;
  const float w_a = 1.f - expf(log_pa);
  const float w_b = 1.f - expf(p * inv_b - lse_b);
  const size_t out = size_t(z) * m + row0 + row;
  loss[out] = -__fdiv_rn(w_b, fmaxf(w_a, 1e-8f)) * log_pa;
  lse_a_out[out] = lse_a;
  lse_b_out[out] = lse_b;
  pos_out[out] = p;
}

cudaError_t allow_wide_smem() {
  return cudaFuncSetAttribute(dt_fwd_wide_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kWideSmem + kWideGather));
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

// The same tensor as 4-D (C, D / 32, M, 32), d % 32 == 0: boxes of 32
// columns by `rows` rows by `blocks` blocks of 32 columns, laid out in
// shared memory block after block as `encode`'s boxes, one copy a stage.
bool encode4(CUtensorMap* map, const void* ptr, int c, int m, int d,
             int rows, int blocks) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(kBox), cuuint64_t(m),
                              cuuint64_t(d / kBox), cuuint64_t(c)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 4, cuuint64_t(kBox) * 4,
                                 cuuint64_t(m) * d * 4};
  const cuuint32_t box[4] = {cuuint32_t(kBox), cuuint32_t(rows),
                             cuuint32_t(blocks), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
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
  // the ring passes 48 KB: raise the kernel's limit once per device
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !ready[dev])) {
    err = allow_wide_smem();
    if (err == cudaSuccess && dev < 64) ready[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // The tiles: q boxes of min(M, 32) rows and key boxes of min(M, 64),
  // each padded to the swizzle's 8; a stage takes as many kWideStageCols
  // columns as fit a ring slot (64 at M >= 32, 384 at M <= 8).
  const int qr = ((m < kWideRows ? m : kWideRows) + 7) & ~7;
  const int kr = ((m < kWideKeys ? m : kWideKeys) + 7) & ~7;
  // (no more than gives each of the cluster's ranks a stage)
  const int fit = kWideSlot / (kWideStageCols * (qr + kr));
  const int spread = (d + kWideCluster * kWideStageCols - 1) /
                     (kWideCluster * kWideStageCols);
  const int stage_cols =
      kWideStageCols * (fit < spread ? (fit > 1 ? fit : 1) : spread);
  // The split rule: keys that fit one key tile -> the ranks split D, in
  // runs of whole stages; more keys -> the ranks split the key tiles.
  const int chunks = (d + stage_cols - 1) / stage_cols;
  const int rank_chunks =
      n_valid <= kWideKeys ? (chunks + kWideCluster - 1) / kWideCluster : 0;
  CUtensorMap q_map, k_map;
  const bool ok =
      d % kBox == 0
          ? encode4(&q_map, q, c, m, d, qr, stage_cols / kBox) &&
                encode4(&k_map, k, c, m, d, kr, stage_cols / kBox)
          : encode(&q_map, q, c, m, d, qr) && encode(&k_map, k, c, m, d, kr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kWideCluster * ((m + kWideRows - 1) / kWideRows), c);
  const size_t smem = kWideSmem + (rank_chunks > 0 ? kWideGather : 0);
  dt_fwd_wide_kernel<<<grid, kWideThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, static_cast<float*>(loss), static_cast<float*>(lse_a),
      static_cast<float*>(lse_b), static_cast<float*>(pos), m, d, n_valid,
      rank_chunks, stage_cols, qr, kr, 1.f / tau_a, 1.f / tau_b);
  return static_cast<int>(cudaGetLastError());
}

// The wide form's attributes on the current device, as dt_loss_attributes,
// for a launch whose ranks split D (every published micro-batch; its
// shared memory does not depend on d): registers and local (spill) bytes a
// thread, shared bytes a CTA, CTAs an SM, threads a CTA, CTAs a cluster.
extern "C" int dt_loss_wide_attributes(int d, int* out) {
  if (d <= kMaxD || d > kWideMaxD || d % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_wide_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, dt_fwd_wide_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = kWideSmem + kWideGather;
  int blocks = 0;   // 0 where the occupancy calculator declines
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, dt_fwd_wide_kernel, kWideThreads, smem) != cudaSuccess) {
    blocks = 0;
    cudaGetLastError();     // do not leave the error for the next launch
  }
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem + a.sharedSizeBytes);
  out[3] = blocks;
  out[4] = kWideThreads;
  out[5] = kWideCluster;
  return 0;
}
