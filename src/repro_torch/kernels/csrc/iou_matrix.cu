// Per-image pairwise IoU: out[b, k, m] = iou(a[b, k], g[b, m]).
//
// Replaces the Pallas kernels repro/kernels/iou_matrix/kernel.py:46
// (_iou_batch_kernel, wrapper iou_matrix_batch_pallas at :64, pallas_call at
// :77) and kernel.py:27 (_iou_kernel, wrapper iou_matrix_pallas at :90,
// pallas_call at :100).  The single-matrix form is the B = 1 launch of the
// same kernel.
//
// Bound on the H100: ~15 flops per output against 4 bytes written per output
// and 16 bytes read per box, so it is bound by bytes (and, at serve shapes of
// B = 512, K = 64, M = 8, by its launch: 1 MB of output is ~0.3 us at
// 3.35 TB/s).  One thread per output; neighbouring threads write neighbouring
// outputs, and the box reads are served by L1/L2 since each box is read M or
// K times.  The TPU kernel's transposed (4, N) lane layout and zero-box padding
// to tile multiples are not carried over.
//
// Arithmetic is float32 for float32 and bfloat16 inputs (stored in the input
// type), with the _rn intrinsics so that nvcc does not contract into FMAs: the
// result is the same rounding, op for op, as the plain PyTorch version.
#include "common.cuh"
#include "dtype.cuh"

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

constexpr int IOU_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(IOU_THREADS)
iou_batch_kernel(const T* __restrict__ a, const T* __restrict__ g,
                 T* __restrict__ out, int B, int K, int M) {
  const long long total = (long long)B * K * M;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(idx % M);
    const long long bk = idx / M;  // b * K + k
    const long long b = bk / K;
    const T* pa = a + bk * 4;
    const T* pg = g + (b * M + m) * 4;
    const float ax1 = load_f(pa), ay1 = load_f(pa + 1), ax2 = load_f(pa + 2), ay2 = load_f(pa + 3);
    const float gx1 = load_f(pg), gy1 = load_f(pg + 1), gx2 = load_f(pg + 2), gy2 = load_f(pg + 3);
    const float iw = fmaxf(__fsub_rn(fminf(ax2, gx2), fmaxf(ax1, gx1)), 0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(ay2, gy2), fmaxf(ay1, gy1)), 0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(
        __fadd_rn(box_area(ax1, ay1, ax2, ay2), box_area(gx1, gy1, gx2, gy2)), inter);
    const float v = uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
    out[idx] = store_f<T>(v);
  }
}

template <typename T>
static int launch(const void* a, const void* g, void* out, int B, int K, int M,
                  void* stream) {
  const long long total = (long long)B * K * M;
  long long blocks = (total + IOU_THREADS - 1) / IOU_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride past this
  iou_batch_kernel<T><<<(unsigned)blocks, IOU_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), static_cast<T*>(out), B, K, M);
  return static_cast<int>(cudaGetLastError());
}

// a (B, K, 4), g (B, M, 4), out (B, K, M): contiguous, on the current device,
// all float32 (_f32) or all bfloat16 (_bf16).  B, K, M >= 1.
REPRO_EXPORT int iou_matrix_batch_f32(const void* a, const void* g, void* out,
                                      int B, int K, int M, void* stream) {
  return launch<float>(a, g, out, B, K, M, stream);
}

REPRO_EXPORT int iou_matrix_batch_bf16(const void* a, const void* g, void* out,
                                       int B, int K, int M, void* stream) {
  return launch<__nv_bfloat16>(a, g, out, B, K, M, stream);
}
