// The IoU arithmetic shared by the three routes of the iou_matrix family
// (iou_matrix.cu: the matrix; iou_nms.cu: greedy NMS; iou_match.cu: COCO
// greedy matching), and the stable in-kernel rank that score_pipeline.cu uses
// too.
//
// One definition of the IoU arithmetic: float32, op for op as the plain
// PyTorch version (detection/boxes.py box_iou), with the _rn intrinsics so
// that nvcc contracts nothing into FMAs.  A float32 IoU then equals the plain
// version's bit for bit (but for the sign of a zero), so every threshold
// decision and every argmax made on it does too.
//
// Each route's shared-memory layout is owned by iou_plan
// (kernels/iou_matrix/ops.py): the kernels take its byte offsets in IouPlan
// and compute none themselves.
#pragma once

#include "common.cuh"
#include "dtype.cuh"
#include "hopper.cuh"

constexpr int IOU_THREADS = 256;
constexpr int IOU_WARPS = IOU_THREADS / 32;
constexpr int IOU_OFFSETS = 12;

// iou_plan's launch plan, passed by value; field for field the ctypes
// structure _PlanC in kernels/iou_matrix/ops.py.
struct IouPlan {
  int smem;   // dynamic shared memory bytes a CTA
  int rows;   // matrix: rows a CTA; match: IoU tile rows a chunk
  int words;  // nms: 64-bit suppression words a row
  int lanes;  // rank: lanes that count one slot's rank
  int off[IOU_OFFSETS];  // byte offsets of the route's arrays (the route's enum)
};

template <typename P>
__device__ __forceinline__ P* plan_at(unsigned char* smem, const IouPlan& p, int field) {
  return reinterpret_cast<P*>(smem + p.off[field]);
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(max_nan(__fsub_rn(x2, x1), 0.0f), max_nan(__fsub_rn(y2, y1), 0.0f));
}

// iou(a, g) for boxes [x1, y1, x2, y2].  A NaN coordinate in either box
// makes the union NaN and the IoU 0, as in box_iou.  A zero intersection gives 0
// without the division: 0 / u is 0 all the same, and the division's
// full-range check sends a zero dividend to a slow subroutine (most pairs of
// an image do not overlap).
__device__ __forceinline__ float iou_pair(float4 a, float4 g) {
  const float iw = max_nan(__fsub_rn(min_nan(a.z, g.z), max_nan(a.x, g.x)), 0.0f);
  const float ih = max_nan(__fsub_rn(min_nan(a.w, g.w), max_nan(a.y, g.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      __fsub_rn(__fadd_rn(box_area(a.x, a.y, a.z, a.w), box_area(g.x, g.y, g.z, g.w)), inter);
  return uni > 0.0f && inter != 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

// one box in one load: 16 bytes of float32 or 8 of bfloat16 (the wrapper
// checks the alignment)
template <typename T>
__device__ __forceinline__ float4 load_box(const T* p);
template <>
__device__ __forceinline__ float4 load_box<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load_box<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// ---------------------------------------------------------------- stable rank

// Part of slot i's stable rank among keys[0, np) (np a multiple of 4, the
// keys 16-byte aligned in shared memory, slots past the real ones keyed
// -inf): #{j : key_j > key_i or (key_j == key_i and j < i)} over the j in
// j0, j0 + 1, j0 + 2, j0 + 3, j0 + step, ...  Summed over all parts it is the
// position of slot i in argsort(-keys, stable=True).  A pad slot j (keyed
// -inf, j past every real i) never counts.
__device__ __forceinline__ int rank_count(const float* keys, int np, float ki, int i, int j0,
                                          int step) {
  int rank = 0;
#pragma unroll 4
  for (int j = j0; j < np; j += step) {
    const float4 k4 = *reinterpret_cast<const float4*>(keys + j);
    rank += (k4.x > ki) || (k4.x == ki && j < i);
    rank += (k4.y > ki) || (k4.y == ki && j + 1 < i);
    rank += (k4.z > ki) || (k4.z == ki && j + 2 < i);
    rank += (k4.w > ki) || (k4.w == ki && j + 3 < i);
  }
  return rank;
}

// The stable rank of each of one image's n slots, counted by `lanes` lanes of
// a warp a slot (a power of 2 <= 32) from every thread of the CTA; calls
// sink(i, rank) once a slot, from one of its lanes.
template <typename Sink>
__device__ __forceinline__ void block_rank(const float* keys, int n, int np, int lanes,
                                           Sink sink) {
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x - lane; base < n * lanes; base += blockDim.x) {
    const int idx = base + lane;
    const int i = idx / lanes;
    int rank = 0;
    if (i < n) rank = rank_count(keys, np, keys[i], i, 4 * (idx % lanes), 4 * lanes);
    for (int off = lanes / 2; off > 0; off >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (i < n && idx % lanes == 0) sink(i, rank);
  }
}
