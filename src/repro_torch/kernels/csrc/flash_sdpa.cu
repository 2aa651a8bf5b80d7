// Flash (online-softmax) scaled dot-product attention with causal,
// sliding-window and query-offset masking, GQA read in place.
//
// Replaces the Pallas kernel repro/kernels/flash_sdpa/kernel.py:24
// (_flash_kernel; wrapper flash_sdpa_pallas at :65, pallas_call at :83).
//
// out[b, s, h] = softmax_j(q[b, s, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
// over the keys j that query position q_offset + s may see (j <= q_offset + s
// when causal, j > q_offset + s - window when window > 0); a row that sees no
// key gives 0.  Inputs float32 or bfloat16, all arithmetic float32, output in
// the input type.
//
// Bound on the H100: at the prefill shape of qwen2-7b (B = 8, S = T = 512,
// 28 query heads over 4 KV heads, D = 128) a layer's attention is 4 B H D
// S (S + 1) / 2 ~ 15 GFLOP against ~60 MB of q, k, v and out, so the work is
// bound by operations (15 us at the bf16 tensor-core rate); a decode step
// (S = 1, T = C) reads the whole cache for 2 flops a byte and is bound by
// bytes.  This first version is simple and right rather than fast: it does
// its products on the CUDA cores in float32 (no wgmma, no TMA), so it cannot
// reach the tensor-core bound.  What the design does about the bound it has:
// - the (S, T) logits never reach device memory: each block keeps its query
//   rows' running max, running denominator and accumulator (the flash
//   recurrence, all float32) in registers while K/V tiles stream through
//   shared memory;
// - a block's key range stops at its last row's causal limit and starts at
//   its first row's window limit, so masked tiles are never loaded;
// - GQA reads KV head h / (H / K) straight from the (B, T, K, D) layout: no
//   repeated K/V, no (B H, S, D) copies and no padding of S or T to tile
//   multiples (the TPU wrapper's repeat/pad, ops.py:35-43); ragged edges are
//   masked in the kernel.
//
// Layout: one block of FA_WARPS warps per (tile of FA_WARPS * FA_ROWS query
// rows, query head, batch).  A warp owns FA_ROWS query rows.  Every thread
// helps load each K/V tile, with 16-byte loads issued FA_UNROLL at a time
// before any is stored, so that a decode step's block (one valid row) still
// has 128 threads' loads in flight; a warp whose rows all lie past S skips
// the arithmetic.  For Q.K^T each lane takes one key of the 32-key tile and
// walks D with float4 reads (K rows padded by 4 floats so the lanes hit
// distinct banks); the tile's row max and sum are warp shuffles; for P.V
// each lane owns D / 32 output columns and takes each key's probability by
// shuffle.  At D = 80 (zamba2-2.7b's heads, float32) a lane owns
// ceil(D / 32) = 3 columns, the last lanes fewer (lanes 27-31 none): the
// columns past D are guarded, never read or written.
#include "common.cuh"
#include "dtype.cuh"

constexpr int FA_ROWS = 4;    // query rows per warp
constexpr int FA_TK = 32;     // keys per tile, one per lane
constexpr int FA_WARPS = 4;   // 16 query rows per block
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_UNROLL = 4;  // 16-byte K and V loads in flight per thread
constexpr unsigned FULL_MASK = 0xffffffffu;

// 16 bytes of T widened to float32: 4 floats or 8 bfloat16s.
template <typename T>
struct Pack16;
template <>
struct Pack16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void store(const uint4& raw, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
  }
};
template <>
struct Pack16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void store(const uint4& raw, float* dst) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_sdpa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                  int H, int KH, int causal, int window, int q_offset,
                  float scale) {
  constexpr int DPL = (D + 31) / 32;  // output columns per lane (the last lanes' guarded)
  constexpr int KPAD = D + 4;  // padded K row: conflict-free float4 reads
  constexpr int TQ = FA_WARPS * FA_ROWS;
  constexpr int VEC = Pack16<T>::N;          // elements per 16-byte load
  constexpr int NV = FA_TK * D / VEC;        // 16-byte loads per tile and tensor
  __shared__ __align__(16) float Qs[TQ][D];
  __shared__ __align__(16) float Ks[FA_TK][KPAD];
  __shared__ __align__(16) float Vs[FA_TK][D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TQ;
  const int r0 = warp * FA_ROWS;
  const bool active = q0 + r0 < S;  // this warp owns at least one query row

  for (int i = threadIdx.x; i < TQ * D; i += FA_THREADS) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r][d] = s < S ? load_f(q + (((long long)b * S + s) * H + h) * D + d) : 0.0f;
  }

  // the keys any row of this block may see
  const int last = min(S, q0 + TQ) - 1;
  const int kend = causal ? min(Tk, q_offset + last + 1) : Tk;
  const int kbeg = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][DPL];
#pragma unroll
  for (int i = 0; i < FA_ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.0f;
  }

  const long long kv_base = (long long)b * Tk * KH + kvh;  // row (b, 0, kvh)
  for (int t0 = (kbeg / FA_TK) * FA_TK; t0 < kend; t0 += FA_TK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int base = 0; base < NV; base += FA_UNROLL * FA_THREADS) {
      uint4 kr[FA_UNROLL], vr[FA_UNROLL];
#pragma unroll
      for (int u = 0; u < FA_UNROLL; ++u) {
        const int i = base + u * FA_THREADS + threadIdx.x;
        const int key = t0 + i / (D / VEC);
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < NV && key < kend) {
          const long long off = (kv_base + (long long)key * KH) * D + (i % (D / VEC)) * VEC;
          kr[u] = *reinterpret_cast<const uint4*>(k + off);
          vr[u] = *reinterpret_cast<const uint4*>(v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < FA_UNROLL; ++u) {
        const int i = base + u * FA_THREADS + threadIdx.x;
        if (i < NV) {
          const int j = i / (D / VEC), c = (i % (D / VEC)) * VEC;
          Pack16<T>::store(kr[u], &Ks[j][c]);
          Pack16<T>::store(vr[u], &Vs[j][c]);
        }
      }
    }
    __syncthreads();
    if (!active) continue;  // no row of this warp: it only helped load

    // scores of this lane's key against the warp's rows
    float sc[FA_ROWS];
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i) sc[i] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&Ks[lane][d]);
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(&Qs[r0 + i][d]);
        sc[i] = fmaf(qq.x, kk.x, sc[i]);
        sc[i] = fmaf(qq.y, kk.y, sc[i]);
        sc[i] = fmaf(qq.z, kk.z, sc[i]);
        sc[i] = fmaf(qq.w, kk.w, sc[i]);
      }
    }

    // online softmax update, row by row (every lane holds each row's m, l)
    const int key = t0 + lane;
    float p[FA_ROWS];
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i) {
      const int s = q0 + r0 + i;
      const int qpos = q_offset + s;
      const bool ok = s < S && key >= kbeg && key < kend &&
                      (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
      const float x = ok ? sc[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      p[i] = ok ? expf(x - m_safe) : 0.0f;
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - m_safe);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
    }

    // acc += P . V over the tile's keys
#pragma unroll 4
    for (int jj = 0; jj < FA_TK; ++jj) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vv[j] = lane * DPL + j < D ? Vs[jj][lane * DPL + j] : 0.0f;
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i) {
        const float pj = __shfl_sync(FULL_MASK, p[i], jj);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(pj, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < FA_ROWS; ++i) {
    const int s = q0 + r0 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * S + s) * H + h) * D + lane * DPL;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (lane * DPL + j < D) o[j] = store_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
static void launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int Tk, int H, int KH, int causal, int window, int q_offset,
                   cudaStream_t stream) {
  constexpr int tq = FA_WARPS * FA_ROWS;
  const dim3 grid((S + tq - 1) / tq, H, B);
  flash_sdpa_kernel<T, D><<<grid, FA_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tk, H, KH, causal, window, q_offset,
      1.0f / sqrtf(static_cast<float>(D)));
}

template <typename T>
static int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                      int B, int S, int Tk, int H, int KH, int causal, int window,
                      int q_offset, cudaStream_t stream) {
  switch (D) {
    case 32: launch<T, 32>(q, k, v, out, B, S, Tk, H, KH, causal, window, q_offset, stream); break;
    case 64: launch<T, 64>(q, k, v, out, B, S, Tk, H, KH, causal, window, q_offset, stream); break;
    case 80: launch<T, 80>(q, k, v, out, B, S, Tk, H, KH, causal, window, q_offset, stream); break;
    case 128: launch<T, 128>(q, k, v, out, B, S, Tk, H, KH, causal, window, q_offset, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, out (B, S, H, D); k, v (B, T, KH, D): contiguous, on the current device,
// float32 (bf16 = 0) or bfloat16 (bf16 = 1), k and v 16-byte aligned.
// H % KH == 0, D in {32, 64, 80, 128}, every size >= 1, window >= 0,
// q_offset >= 0.  Returns cudaGetLastError() (cudaErrorInvalidValue for
// another D).
REPRO_EXPORT int flash_sdpa(const void* q, const void* k, const void* v, void* out,
                            int bf16, int B, int S, int T, int H, int KH, int D,
                            int causal, int window, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, S, T, H, KH, causal, window,
                                          q_offset, st)
              : dispatch_d<float>(D, q, k, v, out, B, S, T, H, KH, causal, window, q_offset,
                                  st);
}
