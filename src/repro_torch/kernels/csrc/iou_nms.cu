// Class-aware greedy NMS in one launch, the `nms` route of the iou_matrix
// family: the keep mask (B, N) of each image's boxes, in their slot order.
//
// Replaces, on the port's serve path, the IoU launch of the Pallas kernels
// repro/kernels/iou_matrix/kernel.py:46 (_iou_batch_kernel) and :27
// (_iou_kernel) together with the score sort, the serial suppression loop and
// the scatter around them.  The function is the reference's
// repro/detection/nms.py:16 (nms: argsort(-scores), IoU of the sorted boxes,
// a fori_loop over the sorted slots), per image; its plain PyTorch version is
// nms_keep_ref (kernels/iou_matrix/ref.py).
//
// One CTA per image, every intermediate in shared memory:
//   1. stage the image's boxes (one 16-byte cp.async a box), scores and
//      classes: one round trip;
//   2. the stable rank of each slot by -score (block_rank, iou.cuh), which is
//      its position in argsort(-scores, stable=True): order[rank] = slot;
//   3. the suppression words, torchvision's bitmask built from the IoU tile:
//      ceil(N / 64) 64-bit words a sorted row, bit j of row i set when
//      j > i, the classes agree and iou(box_i, box_j) > iou_thr, 32 columns a
//      __ballot_sync (a warp a (row, 32 columns), columns wholly at or before
//      the row skipped);
//   4. the greedy scan on one warp, lane w holding keep word w, seeded with
//      score > score_thr: word w's own rows are resolved in series by lane w
//      (a kept row clears its bits in the word), then every later word drops
//      the rows of word w that stayed kept;
//   5. keep[slot] = bit rank[slot].
//
// Bound on the H100: at B 64, N 64 it reads 24 bytes a box and writes one, a
// few hundred ns of HBM, and computes ~N^2 / 2 IoUs an image; it is bound by
// its launch and by the serial floor of the scan: N dependent steps (test a
// bit, clear a word) of one lane, 64 on the path.  N is at most 1024 (the
// suppression words are N^2 / 8 bytes: 128 KB at 1024); iou_plan owns the
// layout and refuses more.
#include "iou.cuh"

// the layout fields (iou_plan's NMS_FIELDS, in order)
enum { NMS_BOXES, NMS_SUP, NMS_KEYS, NMS_ORDER, NMS_RANK, NMS_CLASSES, NMS_KEEP };

__global__ void __launch_bounds__(IOU_THREADS)
iou_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
               const int* __restrict__ classes, unsigned char* __restrict__ keep_out, int N,
               float iou_thr, float score_thr, IouPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bx = plan_at<float4>(smem, p, NMS_BOXES);
  unsigned long long* sup = plan_at<unsigned long long>(smem, p, NMS_SUP);
  float* keys = plan_at<float>(smem, p, NMS_KEYS);
  int* order = plan_at<int>(smem, p, NMS_ORDER);
  int* rank = plan_at<int>(smem, p, NMS_RANK);
  int* cls = plan_at<int>(smem, p, NMS_CLASSES);
  unsigned long long* keep = plan_at<unsigned long long>(smem, p, NMS_KEEP);
  const int W = p.words;
  const int np = (N + 3) & ~3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(blockIdx.x) * N;

  pdl_wait();
  pdl_launch_dependents();
  // 1. stage; every sorted position names some slot even before the rank
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    cp_async16(smem_u32(bx + i), boxes + 4 * (base + i));
    cp_async4(smem_u32(keys + i), scores + base + i);
    cp_async4(smem_u32(cls + i), classes + base + i);
    order[i] = 0;
  }
  cp_async_commit();
  for (int i = N + threadIdx.x; i < np; i += blockDim.x) keys[i] = -INFINITY;
  cp_async_wait<0>();
  __syncthreads();

  // 2. the stable rank by descending score
  block_rank(keys, N, np, p.lanes, [&](int i, int r) {
    order[r] = i;
    rank[i] = r;
  });
  __syncthreads();

  // 3. the suppression words, 32 columns a ballot
  const int halves = 2 * W;  // 32-bit halves a row, low half first
  unsigned* sup32 = reinterpret_cast<unsigned*>(sup);
  for (int pair = warp; pair < N * halves; pair += IOU_WARPS) {
    const int r = pair / halves;
    const int j = 32 * (pair - r * halves) + lane;
    unsigned bits = 0;
    if (j - lane + 31 > r) {  // a half wholly at or before row r holds no later box
      bool hit = false;
      if (j > r && j < N) {
        const int si = order[r], sj = order[j];
        hit = cls[sj] == cls[si] && iou_pair(bx[si], bx[sj]) > iou_thr;
      }
      bits = __ballot_sync(0xffffffffu, hit);
    }
    if (lane == 0) sup32[pair] = bits;
  }
  __syncthreads();

  // 4. the greedy scan on warp 0
  if (warp == 0) {
    unsigned long long kw = 0;  // keep word `lane` (lane < W)
    for (int h = 0; h < halves; ++h) {
      const int r = 32 * h + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, r < N && keys[order[r]] > score_thr);
      if (lane == (h >> 1)) kw |= static_cast<unsigned long long>(bits) << (32 * (h & 1));
    }
    for (int w = 0; w < W; ++w) {
      if (lane == w) {  // word w's own rows, in series
        const unsigned long long* col = sup + static_cast<size_t>(64 * w) * W + w;
        const int n = min(64, N - 64 * w);
        unsigned long long cur = kw;
#pragma unroll 8
        for (int bit = 0; bit < n; ++bit) {
          const unsigned long long s = col[static_cast<size_t>(bit) * W];
          cur &= ~(s & (0ull - ((cur >> bit) & 1ull)));
        }
        kw = cur;
      }
      const unsigned long long kept = __shfl_sync(0xffffffffu, kw, w);
      if (lane > w && lane < W) {  // the later words drop word w's kept rows
        const unsigned long long* rows = sup + static_cast<size_t>(64 * w) * W + lane;
        for (unsigned long long rem = kept; rem != 0; rem &= rem - 1)
          kw &= ~rows[static_cast<size_t>(__ffsll(static_cast<long long>(rem)) - 1) * W];
      }
    }
    if (lane < W) keep[lane] = kw;
  }
  __syncthreads();

  // 5. back to slot order
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int r = rank[i];
    keep_out[base + i] = static_cast<unsigned char>((keep[r >> 6] >> (r & 63)) & 1ull);
  }
}

// boxes (B, N, 4), scores (B, N) float32, classes (B, N) int32, keep (B, N)
// bool: contiguous, on the current device, boxes 16-byte aligned.  B, N >= 1;
// `plan` is iou_plan("nms", N).
REPRO_EXPORT int iou_nms_f32(const void* boxes, const void* scores, const void* classes,
                             void* keep, int B, int N, float iou_thr, float score_thr,
                             const IouPlan* plan, void* stream) {
  const IouPlan p = *plan;
  return launch_pdl(iou_nms_kernel, dim3(B), IOU_THREADS, static_cast<size_t>(p.smem), stream, 0,
                    static_cast<const float*>(boxes), static_cast<const float*>(scores),
                    static_cast<const int*>(classes), static_cast<unsigned char*>(keep), N,
                    iou_thr, score_thr, p);
}
