// Per-image pairwise IoU, the `matrix` route of the iou_matrix family:
// out[b, k, m] = iou(a[b, k], g[b, m]).
//
// Replaces the Pallas kernels repro/kernels/iou_matrix/kernel.py:46
// (_iou_batch_kernel, wrapper iou_matrix_batch_pallas at :64, pallas_call at
// :77) and kernel.py:27 (_iou_kernel, wrapper iou_matrix_pallas at :90,
// pallas_call at :100).  The single-matrix form is the B = 1 launch.  The
// serve path's NMS and matching consume their IoU tiles inside their own
// launches (iou_nms.cu, iou_match.cu); this route is the standalone matrix.
//
// Bound on the H100: ~15 flops per output against 4 bytes written per output
// and 16 bytes read per box, so it is bound by bytes, and at the path's sizes
// (at most ~1 MB out) by its launch.  Design: one CTA per (image, tile of
// `rows` rows), rows chosen by iou_plan so that a CTA has about one group of
// 4 outputs a thread.  The CTA stages the image's M g boxes and its rows' a
// boxes into shared memory once, one 16-byte load a float32 box (8 bytes a
// bfloat16 one), and every thread then reads them from there; where M % 4 ==
// 0 a thread writes 4 neighbouring outputs with one aligned 16-byte store (8
// bytes in bfloat16), else one output a store.  Output offsets need no
// division (the tile is contiguous in out); a thread's row and column need one
// 32-bit division.  A programmatic dependent launch: nothing is read before
// griddepcontrol.wait.  The TPU kernel's transposed (4, N) lane layout and
// zero-box padding to tile multiples are not carried over.
//
// Arithmetic is float32 for float32 and bfloat16 inputs (stored in the input
// type), iou_pair in iou.cuh.
#include "iou.cuh"

// the layout fields (iou_plan's MATRIX_FIELDS, in order)
enum { MX_G, MX_A };

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(IOU_THREADS)
iou_matrix_kernel(const T* __restrict__ a, const T* __restrict__ g, T* __restrict__ out, int K,
                  int M, IouPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* gs = plan_at<float4>(smem, p, MX_G);
  float4* as = plan_at<float4>(smem, p, MX_A);
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * p.rows;
  const int rows = min(p.rows, K - k0);
  pdl_wait();
  pdl_launch_dependents();
  const T* gb = g + static_cast<size_t>(b) * M * 4;
  const T* ab = a + (static_cast<size_t>(b) * K + k0) * 4;
  for (int m = threadIdx.x; m < M; m += blockDim.x) gs[m] = load_box(gb + 4 * m);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) as[r] = load_box(ab + 4 * r);
  __syncthreads();
  T* ob = out + (static_cast<size_t>(b) * K + k0) * M;
  if ((M & 3) == 0) {
    const int q = M >> 2;  // groups of 4 outputs a row
    for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
      const int r = idx / q;
      const int c = 4 * (idx - r * q);
      const float4 box = as[r];
      store4(ob + 4 * idx, make_float4(iou_pair(box, gs[c]), iou_pair(box, gs[c + 1]),
                                       iou_pair(box, gs[c + 2]), iou_pair(box, gs[c + 3])));
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * M; idx += blockDim.x) {
      const int r = idx / M;
      ob[idx] = store_f<T>(iou_pair(as[r], gs[idx - r * M]));
    }
  }
}

template <typename T>
static int launch(const void* a, const void* g, void* out, int B, int K, int M,
                  const IouPlan* plan, void* stream) {
  const IouPlan p = *plan;
  const dim3 grid(B, (K + p.rows - 1) / p.rows);
  return launch_pdl(iou_matrix_kernel<T>, grid, IOU_THREADS, static_cast<size_t>(p.smem), stream,
                    0, static_cast<const T*>(a), static_cast<const T*>(g), static_cast<T*>(out),
                    K, M, p);
}

// a (B, K, 4), g (B, M, 4), out (B, K, M): contiguous, on the current device,
// all float32 (_f32) or all bfloat16 (_bf16), boxes aligned to one box.
// B, K, M >= 1; `plan` is iou_plan("matrix", K, M).
REPRO_EXPORT int iou_matrix_f32(const void* a, const void* g, void* out, int B, int K, int M,
                                const IouPlan* plan, void* stream) {
  return launch<float>(a, g, out, B, K, M, plan, stream);
}

REPRO_EXPORT int iou_matrix_bf16(const void* a, const void* g, void* out, int B, int K, int M,
                                 const IouPlan* plan, void* stream) {
  return launch<__nv_bfloat16>(a, g, out, B, K, M, plan, stream);
}
