// COCO greedy matching in one launch, the `match` route of the iou_matrix
// family: tp (B, T, K) and match_gt (B, T, K) for each image's K detection
// slots against its M ground-truth slots at T IoU thresholds, in the
// detections' slot order.
//
// Replaces, on the port's serve path, the IoU launch of the Pallas kernel
// repro/kernels/iou_matrix/kernel.py:46 (_iou_batch_kernel; kernel.py:27
// _iou_kernel at B = 1) together with the eligibility masking, the score sort,
// the serial K-step scan and the un-permute around it.  The function is the
// reference's repro/detection/batch.py:243 _match_inputs and :209
// _greedy_match (a lax.scan over the score-ordered slots); its plain PyTorch
// version is greedy_match_ref (kernels/iou_matrix/ref.py).
//
// One CTA per image, every intermediate in shared memory:
//   1. stage the detections (one 16-byte cp.async a box), scores, classes and
//      mask, the ground truth's boxes, classes and mask: one round trip;
//   2. keys = mask ? score : -inf, ranked stable (block_rank, iou.cuh):
//      order[rank] = slot, the reference's argsort(-keys, stable=True);
//   3. in chunks of `rows` sorted detections (iou_plan; all K on the path):
//      the (rows x M) IoU tile, ineligible pairs (either slot masked, or the
//      classes differ) at -1;
//   4. one warp a threshold (warps loop over T) scans the chunk's rows in
//      order: lanes over GT slots (slot m on lane m % 32, ceil(M / 32) a
//      lane, their taken bits in one register), avail = taken ? -1 : iou,
//      the warp's first maximum by xor shuffles (ties to the smaller slot, as
//      torch.argmax / jnp.argmax), hit = best >= thr, and the winner's lane
//      sets its taken bit; lane 0 writes tp and match_gt (-1 on a miss) at
//      the detection's slot.  The taken bits cross chunks in shared memory.
//
// Bound on the H100: at B 512, K 64, M 8 it reads ~33 bytes a detection and
// ~21 a GT slot and writes 5 bytes a (threshold, detection): ~1.6 MB, under a
// microsecond of HBM; the IoUs are ~10 MFLOP.  It is bound by its launch and
// by the serial floor of the scan: K dependent steps of one warp (a load, a
// select, log2(min(M, 32)) shuffle rounds, a compare), 64 on the path.  M is
// at most 1024 (the taken bits of a lane fit one register), K at most 2048;
// iou_plan owns the layout and refuses more.
#include <limits.h>

#include "iou.cuh"

// the layout fields (iou_plan's MATCH_FIELDS, in order)
enum {
  MT_DET_BOXES, MT_GT_BOXES, MT_KEYS, MT_ORDER, MT_DET_CLASSES, MT_GT_CLASSES, MT_TAKEN,
  MT_TILE, MT_DET_MASK, MT_GT_MASK
};

__global__ void __launch_bounds__(IOU_THREADS)
iou_match_kernel(const float* __restrict__ d_boxes, const float* __restrict__ d_scores,
                 const int* __restrict__ d_classes, const unsigned char* __restrict__ d_mask,
                 const float* __restrict__ g_boxes, const int* __restrict__ g_classes,
                 const unsigned char* __restrict__ g_mask, const float* __restrict__ thresholds,
                 unsigned char* __restrict__ tp, int* __restrict__ match_gt, int K, int M, int T,
                 IouPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* dbx = plan_at<float4>(smem, p, MT_DET_BOXES);
  float4* gbx = plan_at<float4>(smem, p, MT_GT_BOXES);
  float* keys = plan_at<float>(smem, p, MT_KEYS);
  int* order = plan_at<int>(smem, p, MT_ORDER);
  int* dcls = plan_at<int>(smem, p, MT_DET_CLASSES);
  int* gcls = plan_at<int>(smem, p, MT_GT_CLASSES);
  unsigned* taken_s = plan_at<unsigned>(smem, p, MT_TAKEN);
  float* tile = plan_at<float>(smem, p, MT_TILE);
  unsigned char* dm = plan_at<unsigned char>(smem, p, MT_DET_MASK);
  unsigned char* gm = plan_at<unsigned char>(smem, p, MT_GT_MASK);
  const int Kp = (K + 3) & ~3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const size_t db = static_cast<size_t>(b) * K, gb = static_cast<size_t>(b) * M;

  pdl_wait();
  pdl_launch_dependents();
  // 1. stage; a sorted position no slot ranks at (only with NaN scores) stays -1
  for (int i = threadIdx.x; i < max(K, M); i += blockDim.x) {
    if (i < K) {
      cp_async16(smem_u32(dbx + i), d_boxes + 4 * (db + i));
      cp_async4(smem_u32(keys + i), d_scores + db + i);
      cp_async4(smem_u32(dcls + i), d_classes + db + i);
    }
    if (i < M) {
      cp_async16(smem_u32(gbx + i), g_boxes + 4 * (gb + i));
      cp_async4(smem_u32(gcls + i), g_classes + gb + i);
    }
    if (i < K) {
      dm[i] = d_mask[db + i];
      order[i] = -1;
    }
    if (i < M) gm[i] = g_mask[gb + i];
  }
  cp_async_commit();
  for (int i = K + threadIdx.x; i < Kp; i += blockDim.x) keys[i] = -INFINITY;
  for (int i = threadIdx.x; i < 32 * T; i += blockDim.x) taken_s[i] = 0u;
  cp_async_wait<0>();
  __syncthreads();

  // 2. the stable rank by descending key, masked slots last
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    if (!dm[i]) keys[i] = -INFINITY;
  __syncthreads();
  block_rank(keys, K, Kp, p.lanes, [&](int i, int r) { order[r] = i; });
  __syncthreads();

  int width = 1;  // lanes that hold GT slots, rounded up to a power of 2
  while (width < M && width < 32) width <<= 1;
  for (int k0 = 0; k0 < K; k0 += p.rows) {
    const int rows = min(p.rows, K - k0);
    // 3. the chunk's IoU tile, ineligible pairs at -1
    for (int idx = threadIdx.x; idx < rows * M; idx += blockDim.x) {
      const int r = idx / M, m = idx - r * M;
      const int s = order[k0 + r];
      float v = -1.0f;
      if (s >= 0 && dm[s] && gm[m] && dcls[s] == gcls[m]) v = iou_pair(dbx[s], gbx[m]);
      tile[idx] = v;
    }
    __syncthreads();
    // 4. a warp a threshold, the chunk's rows in order
    for (int t = warp; t < T; t += IOU_WARPS) {
      const float thr = thresholds[t];
      unsigned taken = taken_s[32 * t + lane];  // bit c: GT slot lane + 32 c is taken
      for (int r = 0; r < rows; ++r) {
        const float* row = tile + r * M;
        const int s = order[k0 + r];  // read ahead of the reduction it waits on
        float best = -INFINITY;
        int bj = INT_MAX;
        for (int c = 0, m = lane; m < M; ++c, m += 32) {
          const float v = (taken >> c) & 1u ? -1.0f : row[m];
          if (v > best) {
            best = v;
            bj = m;
          }
        }
        for (int off = 1; off < width; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
          if (ov > best || (ov == best && oj < bj)) {
            best = ov;
            bj = oj;
          }
        }
        const bool hit = best >= thr;
        if (hit && bj < M && (bj & 31) == lane) taken |= 1u << (bj >> 5);
        if (lane == 0 && s >= 0) {
          const size_t o = (static_cast<size_t>(b) * T + t) * K + s;
          tp[o] = hit;
          match_gt[o] = hit ? bj : -1;
        }
      }
      taken_s[32 * t + lane] = taken;
    }
    __syncthreads();
  }
}

// Detections: boxes (B, K, 4), scores (B, K) float32, classes (B, K) int32,
// mask (B, K) bool; ground truth: boxes (B, M, 4), classes (B, M), mask
// (B, M); thresholds (T,) float32; out: tp (B, T, K) bool, match_gt (B, T, K)
// int32.  Contiguous, on the current device, boxes 16-byte aligned.  B, K, M,
// T >= 1; `plan` is iou_plan("match", K, M, T).
REPRO_EXPORT int iou_match_f32(const void* d_boxes, const void* d_scores, const void* d_classes,
                               const void* d_mask, const void* g_boxes, const void* g_classes,
                               const void* g_mask, const void* thresholds, void* tp,
                               void* match_gt, int B, int K, int M, int T, const IouPlan* plan,
                               void* stream) {
  const IouPlan p = *plan;
  return launch_pdl(
      iou_match_kernel, dim3(B), IOU_THREADS, static_cast<size_t>(p.smem), stream, 0,
      static_cast<const float*>(d_boxes), static_cast<const float*>(d_scores),
      static_cast<const int*>(d_classes), static_cast<const unsigned char*>(d_mask),
      static_cast<const float*>(g_boxes), static_cast<const int*>(g_classes),
      static_cast<const unsigned char*>(g_mask), static_cast<const float*>(thresholds),
      static_cast<unsigned char*>(tp), static_cast<int*>(match_gt), K, M, T, p);
}
