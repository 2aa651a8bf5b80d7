// RWKV6 WKV recurrence with data-dependent decay, for every (batch, head):
//
//   out_t = r_t . (S + u * k_t v_t^T)        (a V-vector)
//   S     = diag(w_t) S + k_t v_t^T          (S is K x V, float32)
//
// returning every out_t and the final state.
//
// Replaces the Pallas kernel repro/kernels/wkv6/kernel.py:22 (_wkv_kernel;
// wrapper wkv6_pallas at :41, pallas_call at :52).
//
// Bound on the H100: the function needs 5 K V + 3 K + 2 V float32 operations
// a step (r.S is one multiply-add per state element and the update w S + k v
// three more; the bonus term r.(u k) v is O(K + V)), on (3 K + V) inputs and
// V outputs.  At rwkv6-1.6b's prefill shape (B = 8, T = 512, 32 heads, K = V
// = 64) that is ~2.7 GFLOP against ~126 MB: 0.0407 ms at the float32
// CUDA-core rate (67 TFLOP/s), 0.0376 ms at 3.35 TB/s, so operations bound
// it.  A decode step (T = 1) reads and writes the 8.4 MB state: bytes.
// What really limits it is that time is a chain: step t needs step t - 1's
// state.  The first version kept the chain on chip with one thread a
// state column -- 256 blocks of 64 threads, 2 warps a block and ~4 an SM,
// each thread walking all K rows in one 64-long dependent multiply-add chain
// a step -- and took 0.519 ms (NVIDIA H100 80GB HBM3, 700 W), 12.8x the
// bound.  A first cut of this redesign gave each column 4 lanes of 16 rows
// (256 threads a block) and gained little: every thread read 3 x 16
// broadcast floats of r, k, w a step from shared memory (12 float4 loads,
// each 4 quarter-warp wavefronts, two of them conflicting), so shared memory
// bounded it.  This design:
// - keeps the state on chip: one block a (batch, head) for the whole
//   sequence, the K x V state in registers, the time loop inside the block;
// - gives each thread an 8-row x 4-column block of the state: a column's K
//   rows are spread over K / 8 lanes of one warp (8 at K = 64), whose partial
//   sums of r.S meet by __shfl_xor_sync, and each r, k, w value a thread
//   reads from shared memory serves 4 columns; the rows are interleaved in
//   shared memory (wkv_pos) so a quarter-warp's float4 reads are 128
//   contiguous bytes.  At rwkv6-1.6b a block has 128 threads;
// - computes out_t = sum_i r_i S_i + v sum_i r_i u_i k_i, so the bonus term
//   costs O(K) a thread and step, not O(K V);
// - stages r, k, w and v of WKV_CHUNK steps with cp.async into one of two
//   raw buffers while the previous chunk runs, widens them to float32 once a
//   chunk into shared memory (u lives in registers); a chunk's outputs are
//   staged in shared memory and written out row by row, coalesced;
// - reads u as (H, K) with no per-(batch, head) copy, and r/k/v in bfloat16
//   or float32 and w in float32 or bfloat16, as the layer makes them.
// ptxas (sm_90a): 100-104 registers, no spills; 81,920 bytes of dynamic
// shared memory at K = V = 64 with r/k/v bf16 and w float32.
#include "common.cuh"
#include "dtype.cuh"
#include "hopper.cuh"

constexpr int WKV_CHUNK = 32;  // steps staged at once
constexpr int WKV_MAX_V = 128;
constexpr int WKV_ROWS = 8;   // state rows a thread owns
constexpr int WKV_COLS = 4;   // state columns a thread owns
constexpr int WKV_MAX_THREADS = WKV_MAX_V / WKV_COLS * 8;  // K = 64 (8 row groups), V = 128
constexpr unsigned FULL_MASK = 0xffffffffu;

__host__ __device__ __forceinline__ int up16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

// Byte offsets of the dynamic shared memory: two raw stages (r, k, w, v of a
// chunk in their own types), then the chunk widened to float32 (v and the
// outputs with rows of V rounded up to 4 columns), then the chunk's outputs.
struct WkvSmem {
  int r, k, w, v, stage, fr, fk, fw, fv, fo, bytes;
  __host__ __device__ WkvSmem(int K, int V, int sx, int sw) {
    r = 0;
    k = r + up16(WKV_CHUNK * K * sx);
    w = k + up16(WKV_CHUNK * K * sx);
    v = w + up16(WKV_CHUNK * K * sw);
    stage = v + up16(WKV_CHUNK * V * sx);
    fr = 2 * stage;
    fk = fr + WKV_CHUNK * K * 4;
    fw = fk + WKV_CHUNK * K * 4;
    fv = fw + WKV_CHUNK * K * 4;
    fo = fv + WKV_CHUNK * up4(V) * 4;
    bytes = fo + WKV_CHUNK * up4(V) * 4;
  }
};

// Where row i of a step sits in the widened r, k and w rows: the thread of
// row group g = i / 8 reads its rows 8 g .. 8 g + 3 as the float4 at 4 g and
// 8 g + 4 .. 8 g + 7 as the float4 at K / 2 + 4 g, so the 8 row groups of a
// quarter-warp read 128 contiguous bytes (no bank conflict)
__device__ __forceinline__ int wkv_pos(int i, int K) {
  return ((i & 7) >> 2) * (K / 2) + (i >> 3) * 4 + (i & 3);
}

// A thread's WKV_COLS = 4 consecutive columns, moved as one float4
// (shared or device memory, 16-byte aligned)
struct Cols {
  float x[WKV_COLS];
  __device__ __forceinline__ void load(const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
static_assert(WKV_COLS == 4, "Cols moves a float4");

// 16 bytes of T widened to float32
template <typename T>
struct Widen16;
template <>
struct Widen16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void run(const uint8_t* src, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
  }
};
template <>
struct Widen16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void run(const uint8_t* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x, dst[2 * i + 1] = f.y;
    }
  }
};

// Rows t0 .. t0 + n - 1 of one (b, h) of a (B, T, H, C) tensor: `src` points
// at row t0, rows `stride` elements apart.  stage_rows copies them packed
// (n x C) into shared memory by 16-byte cp.async (async tensors only);
// widen_rows writes them as float32 -- r, k, w (`perm`) at wkv_pos in rows
// of C = K, v in rows of `pitch` -- from that copy, or straight from device
// memory for a tensor that is not 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_rows(uint32_t dst, const T* src, long long stride, int n,
                                           int C, int tid, int nthreads) {
  constexpr int N = 16 / sizeof(T);
  const int per_row = C / N;
  for (int i = tid; i < n * per_row; i += nthreads) {
    const int tt = i / per_row, c = i % per_row;
    cp_async16(dst + i * 16, src + tt * stride + c * N);
  }
}

template <typename T, bool perm>
__device__ __forceinline__ void widen_rows(float* dst, const uint8_t* raw, const T* src,
                                           long long stride, int n, int C, int pitch, bool async,
                                           int tid, int nthreads) {
  if (async) {
    constexpr int N = Widen16<T>::N;  // a multiple of 4 columns, starting at one
    for (int i = tid; i < n * C / N; i += nthreads) {
      float x[N];
      Widen16<T>::run(raw + i * 16, x);
      const int tt = i * N / C, c = i * N % C;
#pragma unroll
      for (int q = 0; q < N; q += 4)
        *reinterpret_cast<float4*>(dst + tt * pitch + (perm ? wkv_pos(c + q, C) : c + q)) =
            make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
    }
  } else {
    for (int i = tid; i < n * C; i += nthreads) {
      const int tt = i / C, c = i % C;
      dst[tt * pitch + (perm ? wkv_pos(c, C) : c)] = load_f(src + tt * stride + c);
    }
  }
}

// async_mask bit 0..3: r, k, w, v may be copied by cp.async (16-byte aligned,
// rows a multiple of 16 bytes); bit 4: s0 and sT move as column vectors.  Thread (column group cg, row group g) owns
// state rows 8 g .. 8 g + 7 and columns 4 cg .. 4 cg + 3; the K / 8 row
// groups of a column group are consecutive lanes of one warp.
template <typename TX, typename TW, int K>
__global__ void __launch_bounds__(WKV_MAX_THREADS)
wkv6_kernel(const TX* __restrict__ r, const TX* __restrict__ k, const TX* __restrict__ v,
            const TW* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ sT, int T, int H, int V,
            int async_mask) {
  constexpr int LANES = K / WKV_ROWS;
  extern __shared__ __align__(16) uint8_t smem[];
  const WkvSmem lay(K, V, sizeof(TX), sizeof(TW));
  float* rs = reinterpret_cast<float*>(smem + lay.fr);
  float* ks = reinterpret_cast<float*>(smem + lay.fk);
  float* ws = reinterpret_cast<float*>(smem + lay.fw);
  float* vs = reinterpret_cast<float*>(smem + lay.fv);
  float* os = reinterpret_cast<float*>(smem + lay.fo);
  const bool ar = async_mask & 1, ak = async_mask & 2, aw = async_mask & 4, av = async_mask & 8;
  const int Vp = up4(V);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid % LANES, c0 = tid / LANES * WKV_COLS;
  const bool owner = c0 < V;  // threads past V (rounding to whole warps) only help
  const int cv = owner ? c0 : 0;  // the columns this thread reads

  // the state's rows are V floats: whole column groups move as vectors
  const bool vec_state = async_mask & 16;
  auto srow = [&](int j) { return (static_cast<long long>(bh) * K + WKV_ROWS * g + j) * V + c0; };
  float st[WKV_ROWS][WKV_COLS], uu[WKV_ROWS];
#pragma unroll
  for (int j = 0; j < WKV_ROWS; ++j) {
    uu[j] = u[h * K + WKV_ROWS * g + j];
    Cols x;
    if (owner && vec_state) {
      x.load(s0 + srow(j));
    } else {
#pragma unroll
      for (int c = 0; c < WKV_COLS; ++c) x.x[c] = owner && c0 + c < V ? s0[srow(j) + c] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < WKV_COLS; ++c) st[j][c] = x.x[c];
  }
  for (int i = tid; i < WKV_CHUNK * Vp; i += nthreads) vs[i] = 0.0f;  // pad columns stay 0

  const long long xs = static_cast<long long>(H) * K, vstride = static_cast<long long>(H) * V;
  auto row_k = [&](int t) { return (static_cast<long long>(b) * T + t) * xs + h * K; };
  auto row_v = [&](int t) { return (static_cast<long long>(b) * T + t) * vstride + h * V; };
  auto stage = [&](int t0, int buf) {
    const int n = min(WKV_CHUNK, T - t0);
    const uint32_t base = smem_u32(smem) + buf * lay.stage;
    if (ar) stage_rows(base + lay.r, r + row_k(t0), xs, n, K, tid, nthreads);
    if (ak) stage_rows(base + lay.k, k + row_k(t0), xs, n, K, tid, nthreads);
    if (aw) stage_rows(base + lay.w, w + row_k(t0), xs, n, K, tid, nthreads);
    if (av) stage_rows(base + lay.v, v + row_v(t0), vstride, n, V, tid, nthreads);
    cp_async_commit();
  };

  stage(0, 0);
  for (int t0 = 0, buf = 0; t0 < T; t0 += WKV_CHUNK, buf ^= 1) {
    const int n = min(WKV_CHUNK, T - t0);
    if (t0 + WKV_CHUNK < T) {
      stage(t0 + WKV_CHUNK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk has landed; the previous chunk is written out
    const uint8_t* raw = smem + buf * lay.stage;
    widen_rows<TX, true>(rs, raw + lay.r, r + row_k(t0), xs, n, K, K, ar, tid, nthreads);
    widen_rows<TX, true>(ks, raw + lay.k, k + row_k(t0), xs, n, K, K, ak, tid, nthreads);
    widen_rows<TW, true>(ws, raw + lay.w, w + row_k(t0), xs, n, K, K, aw, tid, nthreads);
    widen_rows<TX, false>(vs, raw + lay.v, v + row_v(t0), vstride, n, V, Vp, av, tid, nthreads);
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float4* r4 = reinterpret_cast<const float4*>(rs + tt * K);
      const float4* k4 = reinterpret_cast<const float4*>(ks + tt * K);
      const float4* w4 = reinterpret_cast<const float4*>(ws + tt * K);
      const float4 ra = r4[g], rb = r4[K / 8 + g], ka = k4[g], kb = k4[K / 8 + g];
      const float4 wa = w4[g], wb = w4[K / 8 + g];
      Cols vv;
      vv.load(vs + tt * Vp + cv);
      const float rr[WKV_ROWS] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
      const float kk[WKV_ROWS] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float ww[WKV_ROWS] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      // out_c = sum_i r_i S_ic + v_c sum_i r_i u_i k_i over this thread's
      // rows, then over the column's row groups; S = w S + k v after
      float ruk0 = 0.0f, ruk1 = 0.0f;
#pragma unroll
      for (int j = 0; j < WKV_ROWS; j += 2) {
        ruk0 = fmaf(rr[j], uu[j] * kk[j], ruk0);
        ruk1 = fmaf(rr[j + 1], uu[j + 1] * kk[j + 1], ruk1);
      }
      Cols o;
#pragma unroll
      for (int c = 0; c < WKV_COLS; ++c) o.x[c] = vv.x[c] * (ruk0 + ruk1);
#pragma unroll
      for (int j = 0; j < WKV_ROWS; ++j) {
#pragma unroll
        for (int c = 0; c < WKV_COLS; ++c) {
          o.x[c] = fmaf(rr[j], st[j][c], o.x[c]);
          st[j][c] = fmaf(ww[j], st[j][c], kk[j] * vv.x[c]);
        }
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
#pragma unroll
        for (int c = 0; c < WKV_COLS; ++c) o.x[c] += __shfl_xor_sync(FULL_MASK, o.x[c], off);
      }
      if (owner && g == 0) o.store(os + tt * Vp + c0);
    }
    __syncthreads();
    for (int i = tid; i < n * V; i += nthreads) out[row_v(t0 + i / V) + i % V] = os[(i / V) * Vp + i % V];
  }
  if (owner) {
#pragma unroll
    for (int j = 0; j < WKV_ROWS; ++j) {
      Cols x;
#pragma unroll
      for (int c = 0; c < WKV_COLS; ++c) x.x[c] = st[j][c];
      if (vec_state) {
        x.store(sT + srow(j));
      } else {
#pragma unroll
        for (int c = 0; c < WKV_COLS; ++c)
          if (c0 + c < V) sT[srow(j) + c] = x.x[c];
      }
    }
  }
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TW, int K>
static int launch_k(const void* r, const void* k, const void* v, const void* w, const float* u,
                    const float* s0, float* out, float* sT, int B, int T, int H, int V,
                    cudaStream_t stream) {
  const int smem = WkvSmem(K, V, sizeof(TX), sizeof(TW)).bytes;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<TX, TW, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  // r, k, w rows are K elements (>= 16 bytes, a multiple of 16); v rows V;
  // bit 4: the state's rows take whole vectors of WKV_COLS floats
  const int async_mask = (aligned16(r) ? 1 : 0) | (aligned16(k) ? 2 : 0) |
                         (aligned16(w) ? 4 : 0) |
                         (aligned16(v) && (V * sizeof(TX)) % 16 == 0 ? 8 : 0) |
                         (aligned16(s0) && aligned16(sT) && V % WKV_COLS == 0 ? 16 : 0);
  const int threads = ((V + WKV_COLS - 1) / WKV_COLS * (K / WKV_ROWS) + 31) / 32 * 32;
  wkv6_kernel<TX, TW, K><<<B * H, threads, smem, stream>>>(
      static_cast<const TX*>(r), static_cast<const TX*>(k), static_cast<const TX*>(v),
      static_cast<const TW*>(w), u, s0, out, sT, T, H, V, async_mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
static int dispatch_k(int K, const void* r, const void* k, const void* v, const void* w,
                      const float* u, const float* s0, float* out, float* sT, int B,
                      int T, int H, int V, cudaStream_t stream) {
  switch (K) {
    case 8: return launch_k<TX, TW, 8>(r, k, v, w, u, s0, out, sT, B, T, H, V, stream);
    case 16: return launch_k<TX, TW, 16>(r, k, v, w, u, s0, out, sT, B, T, H, V, stream);
    case 32: return launch_k<TX, TW, 32>(r, k, v, w, u, s0, out, sT, B, T, H, V, stream);
    case 64: return launch_k<TX, TW, 64>(r, k, v, w, u, s0, out, sT, B, T, H, V, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r, k, w (B, T, H, K); v, out (B, T, H, V); u (H, K); s0, sT (B, H, K, V):
// contiguous, on the current device.  r/k/v float32 (x_bf16 = 0) or bfloat16
// (x_bf16 = 1), w float32 or bfloat16 (w_bf16), u, s0, out, sT float32.
// K in {8, 16, 32, 64}, 1 <= V <= 128, B, T, H >= 1.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for another K or V).
REPRO_EXPORT int wkv6(const void* r, const void* k, const void* v, const void* w,
                      const float* u, const float* s0, float* out, float* sT,
                      int x_bf16, int w_bf16, int B, int T, int H, int K, int V,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V < 1 || V > WKV_MAX_V) return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return dispatch_k<bf16, bf16>(K, r, k, v, w, u, s0, out, sT, B, T, H, V, st);
  if (x_bf16)
    return dispatch_k<bf16, float>(K, r, k, v, w, u, s0, out, sT, B, T, H, V, st);
  if (w_bf16)
    return dispatch_k<float, bf16>(K, r, k, v, w, u, s0, out, sT, B, T, H, V, st);
  return dispatch_k<float, float>(K, r, k, v, w, u, s0, out, sT, B, T, H, V, st);
}
