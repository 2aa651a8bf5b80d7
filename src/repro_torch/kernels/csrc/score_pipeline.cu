// Fused serve-time score pipeline: padded detections -> reward estimate.
//
// Replaces the Pallas kernel repro/kernels/score_pipeline/kernel.py:32
// (_make_kernel, wrapper score_pipeline_pallas at :92, pallas_call at :111)
// together with the confidence top-k gather its wrapper ran outside the kernel
// (repro/kernels/score_pipeline/ops.py:128-133).
//
// Per image, in one block and in shared memory only:
//   1. stable confidence rank of every slot, keys = mask ? score : -inf:
//        rank_i = #{j : key_j > key_i or (key_j == key_i and j < i)}
//      which is the position of slot i in argsort(-keys, stable=True), so the
//      first top_k positions are the same gather as the reference's;
//   2. the feature row, in the reference's order (kernel.py:35-87):
//        top_k x [s, cx, cy, w, h, area, aspect, onehot(C)]
//        [n / top_k, mean score, max score, entropy], class histogram (C)
//      with positions past K (K < top_k) and masked slots all zero, the max
//      over valid slots only and every global stat zeroed on empty rows;
//   3. (x - mu) / sigma, then the MLP head of mlp.cuh over SP_IMAGES rows.
//
// Bound on the H100: at B = 512, K = 64, F = 387, H = 128 it reads ~0.9 MB of
// detections and weights and does ~51 MFLOP, under a microsecond at either the
// memory or the float32 rate, so it is bound by its launch and by the latency
// of its serial steps: the per-block walk over F (split across SP_SPLIT groups
// in mlp.cuh) and the per-image stats (one warp with shuffle reductions).  The
// design keeps every intermediate (keys, order, feature rows, hidden
// activations) on chip, so the only traffic is one read of the detections and
// of W1 per block and one float written per image.
#include "mlp.cuh"

constexpr int SP_IMAGES = 1;
constexpr int SP_SPLIT = 4;
constexpr int SP_THREADS = SP_SPLIT * MLP_GROUP;
// the static shared memory of mlp_head_rows<SP_IMAGES, SP_SPLIT>
constexpr size_t SP_STATIC_SMEM =
    sizeof(float) * SP_IMAGES * ((SP_SPLIT - 1) * MLP_GROUP + MLP_GROUP / 32);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(SP_THREADS)
score_pipeline_kernel(const float* __restrict__ boxes,
                      const float* __restrict__ scores,
                      const int* __restrict__ classes,
                      const unsigned char* __restrict__ mask,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ mu,
                      const float* __restrict__ sigma, float* __restrict__ out,
                      int B, int K, int top_k, int C, int F, int H,
                      float image_size) {
  extern __shared__ float smem[];
  float* xs = smem;                                  // [SP_IMAGES][F]
  float* keys = xs + SP_IMAGES * F;                  // [K]
  int* order = reinterpret_cast<int*>(keys + K);     // [top_k]
  const int img0 = blockIdx.x * SP_IMAGES;
  const int rows = min(SP_IMAGES, B - img0);
  const int per_box = 7 + C;
  const int n_sel = min(K, top_k);
  const int glob = top_k * per_box;  // offset of the global stats

  for (int r = 0; r < rows; ++r) {
    const size_t base = (size_t)(img0 + r) * K;
    float* row = xs + (size_t)r * F;

    for (int i = threadIdx.x; i < K; i += blockDim.x)
      keys[i] = mask[base + i] ? scores[base + i] : -INFINITY;
    __syncthreads();
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const float ki = keys[i];
      int rank = 0;
      for (int j = 0; j < K; ++j) {
        const float kj = keys[j];
        rank += (kj > ki) || (kj == ki && j < i);
      }
      if (rank < top_k) order[rank] = i;
    }
    __syncthreads();

    for (int p = threadIdx.x; p < top_k; p += blockDim.x) {
      float* fb = row + p * per_box;
      for (int j = 0; j < per_box; ++j) fb[j] = 0.0f;
      if (p < n_sel) {
        const int i = order[p];
        const float m = mask[base + i] ? 1.0f : 0.0f;
        const float* bx = boxes + (base + i) * 4;
        const float x1 = bx[0] / image_size, y1 = bx[1] / image_size;
        const float x2 = bx[2] / image_size, y2 = bx[3] / image_size;
        const float cx = (x1 + x2) / 2.0f;
        const float cy = (y1 + y2) / 2.0f;
        const float w = fmaxf(x2 - x1, 0.0f);
        const float h = fmaxf(y2 - y1, 0.0f);
        const float area = w * h;
        const float aspect = fminf(fmaxf(w / fmaxf(h, 1e-6f), 0.0f), 10.0f) / 10.0f;
        fb[0] = scores[base + i] * m;
        fb[1] = cx * m;
        fb[2] = cy * m;
        fb[3] = w * m;
        fb[4] = h * m;
        fb[5] = area * m;
        fb[6] = aspect * m;
        if (m > 0.0f) fb[7 + min(max(classes[base + i], 0), C - 1)] = 1.0f;
      }
    }
    __syncthreads();

    if (threadIdx.x < 32) {  // global stats: one warp over the top_k positions
      const int lane = threadIdx.x;
      float* g = row + glob;
      for (int j = lane; j < 4 + C; j += 32) g[j] = 0.0f;
      __syncwarp();
      float n = 0.0f, s_sum = 0.0f, s_max = -INFINITY;
      for (int p = lane; p < n_sel; p += 32) {
        const float s = row[p * per_box];
        if (mask[base + order[p]]) {
          n += 1.0f;
          s_max = fmaxf(s_max, s);
          // counts of 1.0 are exact in any order
          atomicAdd(&g[4 + min(max(classes[base + order[p]], 0), C - 1)], 1.0f);
        }
        s_sum += s;
      }
      n = warp_sum(n);
      s_sum = warp_sum(s_sum);
      s_max = warp_max(s_max);
      if (n > 0.0f) {
        const float denom = fmaxf(s_sum, 1e-9f);
        float ent = 0.0f;
        for (int p = lane; p < n_sel; p += 32) {
          const float q = row[p * per_box] / denom;
          ent -= q * logf(fmaxf(q, 1e-12f));
        }
        ent = warp_sum(ent);
        __syncwarp();
        if (lane == 0) {
          g[0] = n / (float)top_k;
          g[1] = s_sum / n;
          g[2] = s_max;
          g[3] = ent;
        }
        for (int c = lane; c < C; c += 32) g[4 + c] /= n;
      }
    }
    __syncthreads();

    for (int f = threadIdx.x; f < F; f += blockDim.x) row[f] = (row[f] - mu[f]) / sigma[f];
    __syncthreads();
  }
  mlp_head_rows<SP_IMAGES, SP_SPLIT>(xs, F, rows, F, H, w1, b1, w2, b2, out + img0);
}

// boxes (B, K, 4) float32, scores (B, K) float32, classes (B, K) int32,
// mask (B, K) bool as bytes, w1 (F, H), b1 (H,), w2 (H,), b2 (), mu (F,),
// sigma (F,), out (B,): contiguous, on the current device.  B, K >= 1 and
// F == top_k * (7 + C) + 4 + C.  Returns cudaGetLastError().
REPRO_EXPORT int score_pipeline_f32(const void* boxes, const void* scores,
                                    const void* classes, const void* mask,
                                    const float* w1, const float* b1,
                                    const float* w2, const float* b2,
                                    const float* mu, const float* sigma,
                                    float* out, int B, int K, int top_k, int C,
                                    int F, int H, float image_size,
                                    void* stream) {
  const size_t smem = sizeof(float) * ((size_t)SP_IMAGES * F + K) + sizeof(int) * top_k;
  if (smem + SP_STATIC_SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_pipeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + SP_IMAGES - 1) / SP_IMAGES;
  score_pipeline_kernel<<<blocks, SP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const int*>(classes), static_cast<const unsigned char*>(mask), w1, b1,
      w2, b2, mu, sigma, out, B, K, top_k, C, F, H, image_size);
  return static_cast<int>(cudaGetLastError());
}
