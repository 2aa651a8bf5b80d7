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
// V outputs.  At rwkv6-1.6b's prefill shape (B = 8, T = 512, 32 heads) that
// is ~2.7 GFLOP against ~126 MB, which the float32 CUDA-core rate and the
// memory rate bound about equally (~0.04 ms each).  What really limits it is
// that time is a chain: step t needs step t - 1's state.  The
// design keeps that chain on chip:
// - one block per (batch, head); each of its V threads owns one column of
//   the K x V state in registers for the whole sequence, so the state never
//   touches device memory between steps (the TPU kernel's sequential grid
//   axis becomes the loop over T inside the block);
// - r, k, w and v of WKV_CHUNK steps are staged in shared memory at once
//   (one coalesced load per chunk, then WKV_CHUNK steps with no global load
//   on the chain), and every thread reads the step's r/k/w by broadcast;
// - u stays (H, K): no per-(batch, head) broadcast copy (the TPU wrapper's
//   (B H, K, 1) u, ops.py:29); r/k/v may stay bfloat16 and w float32 as the
//   model makes them, converted to float32 on load.
#include "common.cuh"
#include "dtype.cuh"

constexpr int WKV_CHUNK = 32;  // steps staged in shared memory at once
constexpr int WKV_MAX_V = 128;

template <typename TX, typename TW, int K>
__global__ void __launch_bounds__(WKV_MAX_V)
wkv6_kernel(const TX* __restrict__ r, const TX* __restrict__ k,
            const TX* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ sT, int T, int H, int V) {
  __shared__ float rs[WKV_CHUNK][K], ks[WKV_CHUNK][K], ws[WKV_CHUNK][K];
  __shared__ float vs[WKV_CHUNK][WKV_MAX_V];
  __shared__ float us[K];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int col = threadIdx.x;  // this thread's state column, 0 <= col < V

  float st[K];
#pragma unroll
  for (int i = 0; i < K; ++i) st[i] = s0[((long long)bh * K + i) * V + col];
  for (int i = col; i < K; i += V) us[i] = u[h * K + i];

  for (int t0 = 0; t0 < T; t0 += WKV_CHUNK) {
    const int n = min(WKV_CHUNK, T - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = col; i < n * K; i += V) {
      const int tt = i / K, c = i % K;
      const long long off = (((long long)b * T + t0 + tt) * H + h) * K + c;
      rs[tt][c] = load_f(r + off);
      ks[tt][c] = load_f(k + off);
      ws[tt][c] = load_f(w + off);
    }
    for (int tt = 0; tt < n; ++tt)
      vs[tt][col] = load_f(v + (((long long)b * T + t0 + tt) * H + h) * V + col);
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vt = vs[tt][col];
      float o = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = ks[tt][i] * vt;
        o += rs[tt][i] * (st[i] + us[i] * kv);
        st[i] = ws[tt][i] * st[i] + kv;
      }
      out[(((long long)b * T + t0 + tt) * H + h) * V + col] = o;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) sT[((long long)bh * K + i) * V + col] = st[i];
}

template <typename TX, typename TW>
static int dispatch_k(int K, const void* r, const void* k, const void* v, const void* w,
                      const float* u, const float* s0, float* out, float* sT, int B,
                      int T, int H, int V, cudaStream_t stream) {
#define WKV_LAUNCH(KK)                                                              \
  wkv6_kernel<TX, TW, KK><<<B * H, V, 0, stream>>>(                                 \
      static_cast<const TX*>(r), static_cast<const TX*>(k), static_cast<const TX*>(v), \
      static_cast<const TW*>(w), u, s0, out, sT, T, H, V)
  switch (K) {
    case 8: WKV_LAUNCH(8); break;
    case 16: WKV_LAUNCH(16); break;
    case 32: WKV_LAUNCH(32); break;
    case 64: WKV_LAUNCH(64); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV_LAUNCH
  return static_cast<int>(cudaGetLastError());
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
