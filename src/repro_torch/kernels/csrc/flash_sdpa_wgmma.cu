// Flash attention forward for bfloat16 on Hopper's tensor cores: the
// "wgmma" route of flash_sdpa (prefill, S > H / KH query rows a KV head).
//
// Replaces the Pallas kernel repro/kernels/flash_sdpa/kernel.py:24
// (_flash_kernel; wrapper flash_sdpa_pallas at :65, pallas_call at :83) for
// bfloat16 inputs with D in {64, 80, 128}.  Same function as flash_sdpa.cu:
// out[b, s, h] = softmax_j(q[b, s, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
// over the keys j that position q_offset + s may see (causal: j <= q_offset + s;
// window > 0: j > q_offset + s - window); a row that sees no key gives 0.
//
// Bound on the H100 at qwen2-7b's prefill (B = 8, S = T = 512, 28 query heads
// over 4 KV heads, D = 128): the causal products are 4 D B H S (S + 1) / 2 =
// 15.1 GFLOP, 15.2 us at 989 TFLOP/s bf16; q, k, v and out are 67 MB, 20.0 us
// at 3.35 TB/s, so bytes bound it (0.0200 ms).  The first version
// (flash_sdpa.cu, float32 products on the CUDA cores, now the float32 route)
// took 1.566 ms and its tile-load revision 0.901 ms (NVIDIA H100 80GB HBM3,
// 700 W) -- 45x the bound.
// What this design does about the bound:
// - both products run on the tensor cores: S = Q K^T is wgmma m64n128k16
//   with Q and K read from shared memory through 128-byte-swizzled
//   descriptors, float32 accumulators; P is rounded to bf16 in registers and
//   is the register A operand of the P V wgmma (m64n64k16 per 64 output
//   columns) against V read MN-major (transposed) from shared memory;
// - K and V tiles of 128 keys arrive by TMA into a ring of 2 stages, each
//   guarded by a "full" mbarrier (TMA bytes) and an "empty" one (the 256
//   consumer threads), so the next tile's copy overlaps this tile's products;
//   one producer warpgroup only issues those copies (setmaxnreg: 24 registers
//   for it, 240 for the two consumer warpgroups);
// - the tensor maps span the model's (B, T, KH, D) layout with its real
//   strides: GQA is read in place (KV head h / G), with no repeat, transpose
//   or padding; rows past S and keys past the causal limit arrive as zeros
//   and are masked in the kernel; an item's key range stops at its last row's
//   causal limit and starts at its first row's window limit;
// - a work item is 128 query rows of one (batch, head) -- two consumer
//   warpgroups of 64 rows, each row's running max, denominator and output in
//   registers (float32) -- and the CTAs are persistent: one an SM walks the
//   items (896 at qwen2-7b) round robin, the causal items with the most keys
//   first, and Q has a ring of 2 tiles too, so the producer loads the next
//   item's Q and first K/V tiles while this item's last tiles and epilogue
//   run (a grid of one CTA an item, without that overlap, was slower at the
//   prefill shape).
// - D = 80 (zamba2-2.7b's heads) runs in the D = 128 layout: the tensor
//   maps' inner dimension is 80, so TMA fills columns 80-127 of each tile's
//   second 64-column panel with zeros (no bytes read for them); Q K^T takes
//   the 5 k16 steps that cover the 80 columns, P V computes 128 output
//   columns of which the epilogue stores 80 (1.6x the P V work, in the
//   product that is not the bound; a narrower last panel is later work).
// ptxas (sm_90a): 168 registers a thread at launch (384 threads, 1 CTA an
// SM), re-split by setmaxnreg to 240 for each consumer and 24 for the
// producer; no spills; 197,696 bytes of dynamic shared memory at D = 128
// (and D = 80), 99,392 at D = 64.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int WG_BM = 128;  // query rows a CTA (2 consumer warpgroups x 64)
constexpr int WG_BN = 128;  // keys a K/V tile
constexpr int WG_STAGES = 2;    // K/V ring
constexpr int WG_Q_STAGES = 2;  // Q ring: the next item's Q loads during this one
constexpr int WG_THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int WG_CONSUMERS = 256;  // arrivals that free a stage
constexpr float NEG_INF = -INFINITY;

// The stored width of a head of D columns: whole 64-column panels.
__host__ __device__ constexpr int padded(int D) { return (D + 63) / 64 * 64; }

// Shared memory: Q, then K and V stages.  Each operand is stored as DP / 64
// panels of (rows x 64) bf16 -- 128-byte rows in TMA's 128-byte swizzle --
// so a panel is what one TMA box of 64 columns writes and what a wgmma
// descriptor with 1024-byte 8-row groups reads.  DP is the padded width.
template <int DP>
struct Layout {
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_PANEL = WG_BM * 128;  // bytes of one Q panel
  static constexpr int KV_PANEL = WG_BN * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;    // one Q tile
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or V tile
  static constexpr int K_OFF = WG_Q_STAGES * Q_BYTES;
  static constexpr int V_OFF = K_OFF + WG_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + WG_STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * 2 * (WG_Q_STAGES + WG_STAGES);
  static constexpr int SMEM = BYTES + 1024;  // room to align the base to 1024
};

// Work item `item` (heaviest causal row blocks first): its batch, head and
// row block, and the K/V tiles [n_first, n_first + n_tiles) its rows may see.
struct Item {
  int b, h, m0, n_first, n_tiles;
  __device__ __forceinline__ Item(int item, int B, int S, int T, int H, int causal, int window,
                                  int q_offset) {
    const int n_m = (S + WG_BM - 1) / WG_BM;
    const int rest = item % (H * B);
    h = rest % H;
    b = rest / H;
    m0 = (n_m - 1 - item / (H * B)) * WG_BM;
    const int last = min(S, m0 + WG_BM) - 1;
    const int kend = causal ? min(T, q_offset + last + 1) : T;
    const int kbeg = window > 0 ? max(0, q_offset + m0 - window + 1) : 0;
    n_first = kbeg / WG_BN;
    n_tiles = kend > kbeg ? (kend + WG_BN - 1) / WG_BN - n_first : 0;
  }
};

__device__ __forceinline__ bool visible(int key, int qpos, int T, int causal, int window) {
  return key < T && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// A persistent CTA: gridDim.x CTAs (one an SM) walk the n_items = ceil(S /
// 128) H B work items round robin, heaviest first.  D is the head's real
// width (the row stride of out), DP = padded(D) the width computed.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_sdpa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ out, int B, int S, int T, int H, int KH,
                        int causal, int window, int q_offset, float scale_log2, int n_items) {
  constexpr int DP = padded(D);
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::K_OFF, sv = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto q_full = [&](int s) { return bars + 8u * s; };
  auto q_empty = [&](int s) { return bars + 8u * (WG_Q_STAGES + s); };
  auto kv_full = [&](int s) { return bars + 8u * (2 * WG_Q_STAGES + s); };
  auto kv_empty = [&](int s) { return bars + 8u * (2 * WG_Q_STAGES + WG_STAGES + s); };
  const int G = H / KH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_Q_STAGES; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), WG_CONSUMERS);
    }
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), WG_CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA copy, running ahead of the
    // consumers by up to 2 Q tiles and 2 K/V tiles, across items
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      int kv = 0;  // K/V tiles issued so far
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const Item w(item, B, S, T, H, causal, window, q_offset);
        const int qs = it % WG_Q_STAGES;
        mbar_wait(q_empty(qs), ((it / WG_Q_STAGES) & 1) ^ 1);
        mbar_expect_tx(q_full(qs), L::Q_BYTES);
        for (int c = 0; c < L::PANELS; ++c)
          tma_load_4d(sq + qs * L::Q_BYTES + c * L::Q_PANEL, &tm_q, q_full(qs), c * 64, w.h, w.m0, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++kv) {
          const int s = kv % WG_STAGES;
          mbar_wait(kv_empty(s), ((kv / WG_STAGES) & 1) ^ 1);
          mbar_expect_tx(kv_full(s), 2 * L::KV_BYTES);
          const int t0 = (w.n_first + i) * WG_BN;
          for (int c = 0; c < L::PANELS; ++c) {
            tma_load_4d(sk + s * L::KV_BYTES + c * L::KV_PANEL, &tm_k, kv_full(s), c * 64, w.h / G, t0, w.b);
            tma_load_4d(sv + s * L::KV_BYTES + c * L::KV_PANEL, &tm_v, kv_full(s), c * 64, w.h / G, t0, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns an item's query rows m0 + 64 wg .. + 63
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    int kv = 0;  // K/V tiles consumed so far
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const Item w(item, B, S, T, H, causal, window, q_offset);
      const int wrow = w.m0 + wg * 64;        // the warpgroup's first row
      const int row0 = wrow + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const int qpos[2] = {q_offset + row0, q_offset + row0 + 8};

      // accumulator layout (wgmma m64nN): element 4 j + e of a thread is row
      // row0 + 8 (e >> 1), column 8 j + 2 t4 + (e & 1)
      float o[DP / 2];
      float sc[WG_BN / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) sc[i] = 0.0f;
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.0f, 0.0f};

      const int qs = it % WG_Q_STAGES;
      const uint32_t sq_wg = sq + qs * L::Q_BYTES + wg * 64 * 128;
      mbar_wait(q_full(qs), (it / WG_Q_STAGES) & 1);

      for (int i = 0; i < w.n_tiles; ++i, ++kv) {
        const int s = kv % WG_STAGES;
        mbar_wait(kv_full(s), (kv / WG_STAGES) & 1);
        const uint32_t kt = sk + s * L::KV_BYTES, vt = sv + s * L::KV_BYTES;

        // S = Q K^T: D / 16 steps of k16 (the zero-filled columns past D are
        // skipped); a step inside a 64-column panel moves the descriptor's
        // start by 32 bytes (the swizzle is applied by address), the next
        // panel starts a new region
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t qa = sq_wg + (ks / 4) * L::Q_PANEL + (ks % 4) * 32;
          const uint32_t ka = kt + (ks / 4) * L::KV_PANEL + (ks % 4) * 32;
          wgmma_ss_n128(sc, desc_sw128(qa), desc_sw128(ka), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (i == w.n_tiles - 1) mbar_arrive(q_empty(qs));  // Q is no longer read

        // mask, then the online softmax in float32 (log2 domain)
        const int t0 = (w.n_first + i) * WG_BN;
        const bool need_mask = t0 + WG_BN > T || (causal && t0 + WG_BN - 1 > q_offset + wrow) ||
                               (window > 0 && t0 <= q_offset + wrow + 63 - window);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < WG_BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + 8 * j + 2 * t4 + (e & 1);
            float x = sc[4 * j + e] * scale_log2;
            if (need_mask && !visible(key, qpos[e >> 1], T, causal, window)) x = NEG_INF;
            sc[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        float m_safe[2], alpha[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          m_safe[r] = m_new == NEG_INF ? 0.0f : m_new;
          alpha[r] = m_run[r] == NEG_INF ? 0.0f : exp2f(m_run[r] - m_safe[r]);
          m_run[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < WG_BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(sc[4 * j + e] - m_safe[e >> 1]);  // masked: exp2(-inf) = 0
            sc[4 * j + e] = p;
            lsum[e >> 1] += p;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + lsum[r];
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[4 * j + 0] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        // P in bf16 as wgmma's A fragment: the accumulator of keys 16 kk ..
        // 16 kk + 15 is already laid out as the A operand of one k16 step
        uint32_t pa[WG_BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < WG_BN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }

        // O += P V: V (keys x D) is MN-major for this product; each 64-column
        // panel is one m64n64k16 per 16 keys (2048 bytes of the panel)
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BN / 16; ++kk) {
#pragma unroll
          for (int c = 0; c < L::PANELS; ++c)
            wgmma_rs_n64(o + 32 * c, pa[kk], desc_sw128(vt + c * L::KV_PANEL + kk * 2048));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(kv_empty(s));
      }
      if (w.n_tiles == 0) mbar_arrive(q_empty(qs));

      // the row's denominator is spread over the 4 threads of its quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        l_run[r] = 1.0f / fmaxf(l_run[r], 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= S) continue;
        __nv_bfloat16* dst = out + ((static_cast<long long>(w.b) * S + row) * H + w.h) * D;
#pragma unroll
        for (int c = 0; c < L::PANELS; ++c) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (64 * c + 8 * j >= D) break;  // the padded columns are not stored
            const float* acc = o + 32 * c + 4 * j + 2 * r;
            *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * j + 2 * t4) =
                pack_bf16(acc[0] * l_run[r], acc[1] * l_run[r]);
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (batch, rows, heads, D) bf16 tensor whose row
// stride is that of `rows_alloc` rows; boxes of (64 columns, 1 head,
// box_rows rows, 1 batch), 128-byte swizzled; rows at or past `rows`, and
// columns at or past D (the second box of D = 80), read as zeros.  Strides
// of D * 2 and heads * D * 2 bytes: multiples of 16, as TMA needs, for D a
// multiple of 8.
bool make_map(CUtensorMap* map, const void* ptr, int D, int heads, int rows, int rows_alloc,
              int batch, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row, row * rows_alloc};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T, int H,
           int KH, int causal, int window, int q_offset, cudaStream_t stream) {
  using L = Layout<padded(D)>;
  // keys past the last query's causal limit are never visible: the map ends there
  const int t_vis = causal ? std::max(1, std::min(T, q_offset + S)) : T;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, H, S, S, B, WG_BM) || !make_map(&tk, k, D, KH, t_vis, T, B, WG_BN) ||
      !make_map(&tv, v, D, KH, t_vis, T, B, WG_BN))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_sdpa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_items = (S + WG_BM - 1) / WG_BM * H * B;
  const dim3 grid(std::min(n_items, std::max(sms, 1)));
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_sdpa_wgmma_kernel<D><<<grid, WG_THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), B, S, T, H, KH, causal, window, q_offset,
      scale_log2, n_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out (B, S, H, D); k, v (B, T, KH, D): contiguous bfloat16 on the current
// device, 16-byte aligned; H % KH == 0, D in {64, 80, 128}, every size >= 1,
// window >= 0, q_offset >= 0.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for another D or when a tensor map cannot be made).
REPRO_EXPORT int flash_sdpa_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int T, int H, int KH, int D, int causal, int window,
                                  int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, out, B, S, T, H, KH, causal, window, q_offset, st);
    case 80: return launch<80>(q, k, v, out, B, S, T, H, KH, causal, window, q_offset, st);
    case 128: return launch<128>(q, k, v, out, B, S, T, H, KH, causal, window, q_offset, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
