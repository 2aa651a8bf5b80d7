// The reward-estimator head shared by estimator_mlp.cu and score_pipeline.cu:
//
//     out[r] = sigmoid(sum_h gelu_tanh(x[r] . W1[:, h] + b1[h]) * w2[h] + b2)
//
// as thread block clusters of cs CTAs (the plan, cs among them, comes from
// the wrapper's mlp_plan, kernels/estimator_mlp/ops.py, which mirrors
// mlp_layout and mlp_ksplit here):
//
//   1. F is split over the cluster's ranks at multiples of 4 rows
//      (mlp_slice_start), so every rank's rows of W1 (F, H row-major) are one
//      contiguous, 16-byte aligned range.  Thread 0 stages it in shared memory
//      with bulk async copies (cp.async.bulk, no tensor map), before any other
//      read, in ksplit chunks on one mbarrier each; bytes past the last
//      multiple of 16 (H odd) come by plain loads, and the slice is
//      zero-padded to a multiple of 4 rows.  It stays resident while the CTA
//      walks its tiles of TB rows.  A slice too large for shared memory
//      streams through a ring of 2 stages of stage_rows rows instead; a
//      one-CTA head of at most MLP_SMALL_BYTES takes its W1 by cp.async.
//   2. Partial pre-activations from shared memory only: warp w takes F-chunk
//      w % ksplit (and starts as soon as that chunk has landed) of a block of
//      8 rows x 128 hidden units; a lane owns 4 hidden units of each row, 32
//      independent float32 FMA chains, x read as broadcast float4s and W1 as
//      float4s (H a multiple of 4).  The chunks' partials are summed in chunk
//      order.
//   3. The TB x H partials meet over distributed shared memory: rank r sums
//      its share of the H columns over all ranks (in rank order), applies b1,
//      gelu and w2 and sums its columns per row; rank 0 adds the cs row sums,
//      b2 and the sigmoid and writes out.  Two cluster barriers a tile.  A
//      cluster of one CTA whose warps hold whole rows (the LM's small head)
//      finishes each row in registers instead, with no barrier.
//
// Every launch is a programmatic dependent of the kernel before it: its CTAs
// are placed, and their mbarriers set up, while that kernel finishes; every
// read of device memory (weights too) waits for it to complete.
// Float32 on the CUDA cores throughout (no TF32): a head is ~6 MFLOP at a
// request, far below the tensor cores' line, and the checks allow no TF32
// rounding.  Any F, H >= 1.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

constexpr int MLP_THREADS = 256;
constexpr int MLP_WARPS = MLP_THREADS / 32;
constexpr int MLP_CT = 4;                   // hidden units a lane owns
constexpr int MLP_WARP_COLS = 32 * MLP_CT;  // hidden units a warp's tile spans
constexpr int MLP_MAX_CLUSTER = 8;
constexpr uint32_t MLP_BULK_CHUNK = 32768;  // bytes one bulk copy moves at most
// a one-CTA head whose W1 is at most this many bytes (the LM's, 3 KB) takes
// it by cp.async with its other inputs: no mbarrier round trip
constexpr size_t MLP_SMALL_BYTES = 32768;

__host__ __device__ inline int mlp_min(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int mlp_pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline size_t mlp_pad16(size_t n) { return (n + 15) & ~size_t(15); }

// first row of F that rank r of cs owns: the ceil(F / 4) groups of 4 rows
// split evenly over the ranks
__host__ __device__ inline int mlp_slice_start(int F, int cs, int r) {
  const int quads = (F + 3) / 4;
  return mlp_min(F, 4 * (r * quads / cs));  // r <= 8: no overflow below F = 2^28
}

// rows of a warp's register tile: all TB rows up to 8
__host__ __device__ inline int mlp_tile_rows(int tb) { return tb < 8 ? tb : 8; }

// rows of each of the ksplit F-chunks of a slab of `rows` rows
__host__ __device__ inline int mlp_chunk_rows(int rows, int ksplit) {
  return mlp_pad4((rows + ksplit - 1) / ksplit);
}

__host__ __device__ inline int mlp_floor_pow2(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// F-chunks a slab is cut into, one per warp group, so that the 8 warps all
// work when the tile has fewer than 8 (rows x 128 hidden units) blocks, but
// no chunk is shorter than 16 rows of the widest slice: a power of 2
__host__ __device__ inline int mlp_ksplit(int tb, int H, int slice4) {
  const int blocks = (tb / mlp_tile_rows(tb)) * ((H + MLP_WARP_COLS - 1) / MLP_WARP_COLS);
  const int by_warps = blocks >= MLP_WARPS ? 1 : mlp_floor_pow2(MLP_WARPS / blocks);
  const int by_rows = mlp_floor_pow2(slice4 / 16 > 1 ? slice4 / 16 : 1);
  return by_warps < by_rows ? by_warps : by_rows;
}

constexpr int MLP_BARS = 8;  // a resident slice's F-chunks (ksplit <= 8), or a ring's 2 stages

// Dynamic shared memory of one CTA, as byte offsets: MLP_BARS mbarriers, the
// W1 ring (stages x stage_rows x H), the x tile (TB x x_cols), the partials
// (ksplit x TB x H; chunk 0 ends up with their sum), b1, w2, b2, the row
// sums each rank stores in rank 0 (8 x TB), then `extra` bytes for the
// caller.  x_cols = 0 means the widest slice rounded up to 4.
struct MlpLayout {
  int slice4, stage_rows, stages, x_cols, ksplit;
  size_t ring, xs, part, b1, w2, b2, rowslot, extra, total;
};

__host__ __device__ inline MlpLayout mlp_layout(int F, int H, int cs, int tb, int slab_rows,
                                                int x_cols, size_t extra) {
  MlpLayout L;
  int widest = 0;
  for (int r = 0; r < cs; ++r) {
    const int rows = mlp_slice_start(F, cs, r + 1) - mlp_slice_start(F, cs, r);
    widest = rows > widest ? rows : widest;
  }
  L.slice4 = mlp_pad4(widest);
  L.stage_rows = mlp_min(slab_rows, L.slice4);
  L.stages = slab_rows >= L.slice4 ? 1 : 2;
  L.x_cols = x_cols > 0 ? x_cols : L.slice4;
  L.ksplit = mlp_ksplit(tb, H, L.slice4);
  L.ring = 8 * MLP_BARS;
  L.xs = L.ring + sizeof(float) * static_cast<size_t>(L.stages) * L.stage_rows * H;
  L.part = L.xs + sizeof(float) * static_cast<size_t>(tb) * L.x_cols;
  L.b1 = mlp_pad16(L.part + sizeof(float) * static_cast<size_t>(L.ksplit) * tb * H);
  L.w2 = mlp_pad16(L.b1 + sizeof(float) * H);
  L.b2 = mlp_pad16(L.w2 + sizeof(float) * H);
  L.rowslot = L.b2 + 16;
  L.extra = mlp_pad16(L.rowslot + sizeof(float) * MLP_MAX_CLUSTER * tb);
  L.total = L.extra + extra;
  return L;
}

// one CTA's share of the head
struct MlpCta {
  int f0, rows;     // its slice of F
  int stage_rows;   // rows a ring stage holds
  int nslabs;       // stages the slice takes (1: resident)
  int stages;       // 1 when resident, else 2
  int n_total;      // slabs it stages over all its tiles
  int ksplit;       // F-chunks of a slab
  bool small;       // a one-CTA head's whole W1, staged by cp.async
  uint64_t* bars;   // resident: one mbarrier an F-chunk; a ring: one a stage
  float* ring;
  float* part;      // [ksplit][TB][H]
  float* b1;        // [H]
  float* w2;        // [H]
  float* b2;        // [1]
  float* rowslot;   // [cs][TB]: rank q's row sums, stored in rank 0
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a barrier over the cluster (a CTA barrier when the cluster is one CTA)
__device__ __forceinline__ void mlp_sync(cg::cluster_group& cluster, int cs) {
  if (cs == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// Slab n of this CTA's sequence (slab n % nslabs of the slice) into stage
// n % stages: thread 0 issues the bulk copies, every thread the tail past
// the last multiple of 16 bytes and zero rows up to a multiple of 4.  A
// resident slice lands as its ksplit F-chunks, each on its own mbarrier, so
// that a warp starts on its chunk as soon as that has landed (mlp_fma); a
// ring stage lands on one.
__device__ void mlp_stage(const MlpCta& c, const float* w1, int H, int n) {
  const int r0 = (n % c.nslabs) * c.stage_rows;
  const int rows = mlp_min(c.stage_rows, c.rows - r0);
  const int st = n % c.stages;
  float* dst = c.ring + static_cast<size_t>(st) * c.stage_rows * H;
  const float* src = w1 + static_cast<size_t>(c.f0 + r0) * H;
  const uint32_t bulk = (static_cast<uint32_t>(rows) * H * 4) & ~15u;
  if (c.small) {  // with the caller's first cp.async group
    for (uint32_t off = 16 * threadIdx.x; off < bulk; off += 16 * blockDim.x)
      cp_async16(smem_u32(dst) + off, reinterpret_cast<const char*>(src) + off);
  } else if (threadIdx.x == 0) {
    fence_proxy_async();
    const int chunks = c.stages == 1 ? c.ksplit : 1;
    const uint32_t step = static_cast<uint32_t>(mlp_chunk_rows(rows, chunks)) * H * 4;
    for (int k = 0; k < chunks; ++k) {
      const uint32_t lo = k * step < bulk ? k * step : bulk;
      const uint32_t hi = bulk - lo < step ? bulk : lo + step;
      const uint32_t bar = smem_u32(c.bars + st * chunks + k);
      mbar_expect_tx(bar, hi - lo);
      for (uint32_t off = lo; off < hi; off += MLP_BULK_CHUNK)
        bulk_load(smem_u32(dst) + off, reinterpret_cast<const char*>(src) + off,
                  hi - off < MLP_BULK_CHUNK ? hi - off : MLP_BULK_CHUNK, bar);
    }
  }
  const int real = rows * H;
  for (int i = bulk / 4 + threadIdx.x; i < mlp_pad4(rows) * H; i += blockDim.x)
    dst[i] = i < real ? src[i] : 0.0f;
}

// Sets up the CTA's share, issues its first W1 stages, then b1, w2 and b2 by
// cp.async (uncommitted: the caller commits them with its own first loads and
// waits once); call before any other work, from every thread of the CTA.
__device__ MlpCta mlp_begin(unsigned char* smem, const MlpLayout& L, int F, int H, int cs,
                            int rank, int my_tiles, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ w2,
                            const float* __restrict__ b2) {
  MlpCta c;
  c.f0 = mlp_slice_start(F, cs, rank);
  c.rows = mlp_slice_start(F, cs, rank + 1) - c.f0;
  c.stage_rows = L.stage_rows;
  c.nslabs = (c.rows + L.stage_rows - 1) / L.stage_rows;
  c.stages = c.nslabs > 1 ? 2 : 1;
  c.n_total = c.stages == 1 ? 1 : my_tiles * c.nslabs;
  c.ksplit = L.ksplit;
  c.small = cs == 1 && c.stages == 1 && static_cast<size_t>(c.rows) * H * 4 <= MLP_SMALL_BYTES;
  c.bars = reinterpret_cast<uint64_t*>(smem);
  c.ring = reinterpret_cast<float*>(smem + L.ring);
  c.part = reinterpret_cast<float*>(smem + L.part);
  c.b1 = reinterpret_cast<float*>(smem + L.b1);
  c.w2 = reinterpret_cast<float*>(smem + L.w2);
  c.b2 = reinterpret_cast<float*>(smem + L.b2);
  c.rowslot = reinterpret_cast<float*>(smem + L.rowslot);
  if (threadIdx.x == 0 && !c.small) {
    for (int b = 0; b < MLP_BARS; ++b) mbar_init(smem_u32(c.bars + b), 1);
    fence_mbar_init();
  }
  // A programmatic dependent launch (launch_pdl) may start while the kernel
  // before it still runs: nothing is read from device memory before it has
  // completed and its writes are visible (the weights may be its output), and
  // the kernel after this one may start only then.  Both return at once in a
  // plain launch.
  pdl_wait();
  pdl_launch_dependents();
  if (my_tiles > 0) {
    mlp_stage(c, w1, H, 0);
    if (c.n_total > 1) mlp_stage(c, w1, H, 1);
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    cp_async4(smem_u32(c.b1 + h), b1 + h);
    cp_async4(smem_u32(c.w2 + h), w2 + h);
  }
  if (threadIdx.x == 0) cp_async4(smem_u32(c.b2), b2);
  if (!c.small) __syncthreads();  // the barriers are initialised before anyone waits on them
  return c;
}

// part[k][r][h] (+)= x[r][fa:fb] . w[fa:fb, h] (or, given `out`, when the
// warp's block holds whole rows of the whole slice: out[r] for r < out_rows,
// the head finished in registers), where warp w takes F-chunk
// k = w % ksplit of the slab (after waiting on chunk_bars[k], if given;
// chunks of a multiple of 4 rows; x and w are
// zero past the slab's rows up to a multiple of 4) and (rows x 128 hidden
// units) blocks w / ksplit, w / ksplit + 8 / ksplit, ...  A lane owns
// MLP_CT hidden units of RT rows, RT x MLP_CT independent FMA chains, each
// summed in F order.  With VEC (H a multiple of 4) its units are 4
// consecutive ones and every load is 16 bytes: 4 rows of W1 and RT float4s
// of x (broadcasts) for 16 RT FMAs; otherwise they are 32 apart and loaded
// one float at a time.
template <int TB, bool VEC>
__device__ void mlp_fma(const float* xs, int ldx, const float* w, int H, int rows, float* part,
                        int ksplit, bool first, const uint64_t* chunk_bars, const MlpCta& c,
                        float* __restrict__ out, int out_rows) {
  constexpr int RT = TB < 8 ? TB : 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col_blocks = (H + MLP_WARP_COLS - 1) / MLP_WARP_COLS;
  const int blocks = (TB / RT) * col_blocks;
  const int k = warp % ksplit;
  const int chunk = mlp_chunk_rows(rows, ksplit);
  const int rows4 = mlp_pad4(rows);
  const int fa = mlp_min(rows4, k * chunk), fb = mlp_min(rows4, fa + chunk);
  float* kp = part + static_cast<size_t>(k) * TB * H;
  if (chunk_bars != nullptr) mbar_wait(smem_u32(chunk_bars + k), 0);  // this chunk has landed
  for (int t = warp / ksplit; t < blocks; t += MLP_WARPS / ksplit) {
    const int rb = (t / col_blocks) * RT;
    const int cb = (t % col_blocks) * MLP_WARP_COLS;
    int hc[MLP_CT];  // past H: the last units, computed and never stored
#pragma unroll
    for (int j = 0; j < MLP_CT; ++j)
      hc[j] = VEC ? mlp_min(cb + MLP_CT * lane, H - MLP_CT) + j
                  : mlp_min(cb + lane + 32 * j, H - 1);
    float acc[RT][MLP_CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < MLP_CT; ++j) acc[i][j] = first ? 0.0f : kp[(rb + i) * H + hc[j]];
    }
    const float* xr = xs + static_cast<size_t>(rb) * ldx;
#pragma unroll 2
    for (int f = fa; f < fb; f += 4) {
      float4 xv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) xv[i] = *reinterpret_cast<const float4*>(xr + i * ldx + f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float wv[MLP_CT];
        if constexpr (VEC) {
          const float4 w4 = *reinterpret_cast<const float4*>(w + (f + q) * H + hc[0]);
          wv[0] = w4.x;
          wv[1] = w4.y;
          wv[2] = w4.z;
          wv[3] = w4.w;
        } else {
#pragma unroll
          for (int j = 0; j < MLP_CT; ++j) wv[j] = w[(f + q) * H + hc[j]];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float xq = q == 0 ? xv[i].x : q == 1 ? xv[i].y : q == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int j = 0; j < MLP_CT; ++j) acc[i][j] = fmaf(xq, wv[j], acc[i][j]);
        }
      }
    }
    const bool owner = VEC ? cb + MLP_CT * lane < H : true;  // a lane clamped back stores nothing
    if (out != nullptr) {  // the warp holds whole rows: finish them here
      // every GELU of the lane unconditionally (units past H are the clamped
      // ones, dropped after), so that their tanh chains run side by side
      bool ok[MLP_CT];
      float bias[MLP_CT], head[MLP_CT];
#pragma unroll
      for (int j = 0; j < MLP_CT; ++j) {
        ok[j] = owner && (VEC ? cb + MLP_CT * lane + j : cb + lane + 32 * j) < H;
        bias[j] = c.b1[hc[j]];
        head[j] = c.w2[hc[j]];
      }
      float v[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float g[MLP_CT];
#pragma unroll
        for (int j = 0; j < MLP_CT; ++j) g[j] = gelu_tanh(acc[i][j] + bias[j]) * head[j];
        v[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < MLP_CT; ++j) v[i] += ok[j] ? g[j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) v[i] = warp_sum(v[i]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (lane == 0 && rb + i < out_rows) out[rb + i] = sigmoid(v[i] + c.b2[0]);
      continue;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < MLP_CT; ++j) {
        const int h = VEC ? cb + MLP_CT * lane + j : cb + lane + 32 * j;
        if (owner && h < H) kp[(rb + i) * H + h] = acc[i][j];
      }
    }
  }
}

// The partial pre-activations of tile `it` (this CTA's it-th) over its slice,
// summed over the F-chunks into part[0]: waits for each slab of W1, and in a
// ring refills the stage just used.  xs points at the tile's first slice
// column.
// Whether a warp's (rows x 128 hidden units) block holds whole rows of the
// whole head (one CTA a cluster, one F-chunk, H <= 128, W1 resident): then
// mlp_partials finishes the rows in registers and no reduction follows.
__device__ __forceinline__ bool mlp_direct(const MlpCta& c, int cs, int H) {
  return cs == 1 && c.ksplit == 1 && H <= MLP_WARP_COLS && c.nslabs == 1;
}

template <int TB, bool VEC>
__device__ void mlp_partials(const MlpCta& c, const float* xs, int ldx, const float* w1, int H,
                             int it, float* __restrict__ out = nullptr, int out_rows = 0) {
  for (int k = 0; k < c.nslabs; ++k) {
    const int n = it * c.nslabs + k;
    const int st = n % c.stages;
    if (c.stages == 2) mbar_wait(smem_u32(c.bars + st), (n / c.stages) & 1);
    __syncthreads();  // the x tile and the plain-loaded tail are in place
    const int r0 = k * c.stage_rows;
    // a resident slice: each warp waits for its own F-chunk, on the first tile
    mlp_fma<TB, VEC>(xs + r0, ldx, c.ring + static_cast<size_t>(st) * c.stage_rows * H, H,
                     mlp_min(c.stage_rows, c.rows - r0), c.part, c.ksplit, k == 0,
                     c.stages == 1 && it == 0 && !c.small ? c.bars : nullptr, c, out, out_rows);
    if (c.stages == 2) {
      __syncthreads();  // every thread is done with the stage
      if (n + 2 < c.n_total) mlp_stage(c, w1, H, n + 2);
    }
  }
  if (out != nullptr) {
    __syncthreads();  // every warp is done with the x tile before the next one lands
    return;
  }
  if (c.ksplit > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < TB * H; i += blockDim.x) {
      float s = c.part[i];
      for (int k = 1; k < c.ksplit; ++k) s += c.part[static_cast<size_t>(k) * TB * H + i];
      c.part[i] = s;
    }
  }
}

// The cluster's partials -> out[0:rows], over distributed shared memory: rank
// r sums its share [r H / cs, (r + 1) H / cs) of the hidden units over the
// ranks (in rank order), applies b1, gelu and w2 and sums them per row, a
// row over a group of G lanes (G the share rounded up to a power of 2, at
// most 32); it stores the sums in rank 0's row slots, and rank 0 adds the
// ranks' sums (in rank order) and b2 and applies the sigmoid.  Two cluster
// barriers: after the second, no rank touches another's shared memory, so a
// rank may leave or start its next tile (whose partials it writes only into
// its own memory, and whose row sums it stores only after the next tile's
// first barrier, which rank 0 reaches once it has read these).
template <int TB>
__device__ void mlp_reduce(cg::cluster_group& cluster, const MlpCta& c, int rows, int H,
                           float* __restrict__ out) {
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  mlp_sync(cluster, cs);  // every rank's partials are written
  const int h0 = rank * H / cs, h1 = (rank + 1) * H / cs;
  int G = 1;  // lanes a row: the share rounded up to a power of 2, at most 32
  while (G < h1 - h0 && G < 32) G *= 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / G;
  float* slots = cluster.map_shared_rank(c.rowslot, 0) + rank * TB;
  for (int r0 = warp * per_warp; r0 < TB; r0 += MLP_WARPS * per_warp) {
    const int r = r0 + lane / G;
    float v = 0.0f;
    if (r < TB) {
      for (int h = h0 + lane % G; h < h1; h += G) {
        float a = 0.0f;
        for (int q = 0; q < cs; ++q) a += cluster.map_shared_rank(c.part, q)[r * H + h];
        v += gelu_tanh(a + c.b1[h]) * c.w2[h];
      }
    }
    for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane % G == 0 && r < TB) slots[r] = v;
  }
  mlp_sync(cluster, cs);  // every rank's row sums are in rank 0
  if (rank == 0) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < cs; ++q) s += c.rowslot[q * TB + r];
      out[r] = sigmoid(s + c.b2[0]);
    }
  }
}

// How many clusters of `cs` CTAs of `kernel` with `smem` bytes of dynamic
// shared memory the device can hold at once (0 on error): clusters are placed
// within a GPC, so this is less than SMs / cs.
template <typename... Params>
inline int mlp_max_clusters(void (*kernel)(Params...), int cs, size_t smem) {
  if (raise_smem_limit(reinterpret_cast<const void*>(kernel), smem) != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * 64);
  cfg.blockDim = dim3(MLP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return 0;
  return n;
}

// The plan's launch shape is the layout's: returns cudaErrorInvalidValue when
// it is not (a wrapper out of step with this file).
inline bool mlp_plan_ok(const MlpLayout& L, int cs, int tb, int grid, size_t smem) {
  return cs >= 1 && cs <= MLP_MAX_CLUSTER && grid >= cs && grid % cs == 0 && smem >= L.total &&
         smem <= 232448 &&
         (tb == 2 || tb == 4 || tb == 8 || tb == 16 || tb == 32 || tb == 64);
}
