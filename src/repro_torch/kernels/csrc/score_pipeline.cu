// Fused serve-time score pipeline: padded detections -> reward estimate.
//
// Replaces the Pallas kernel repro/kernels/score_pipeline/kernel.py:32
// (_make_kernel, wrapper score_pipeline_pallas at :92, pallas_call at :111)
// together with the confidence top-k gather its wrapper ran outside the kernel
// (repro/kernels/score_pipeline/ops.py:128-133).
//
// A thread block cluster takes TB images at a time (mlp.cuh).  Each CTA first
// issues the bulk copies of its slice of W1, then, while W1 lands, loads the
// tile's detections into shared memory (one round trip) and builds the TB
// feature rows there, all images at once:
//   1. stable confidence rank of every slot, keys = mask ? score : -inf:
//        rank_i = #{j : key_j > key_i or (key_j == key_i and j < i)}
//      which is the position of slot i in argsort(-keys, stable=True), so the
//      first top_k positions are the same gather as the reference's (each
//      slot's count split over up to 8 lanes);
//   2. the feature row, in the reference's order (kernel.py:35-87):
//        top_k x [s, cx, cy, w, h, area, aspect, onehot(C)]
//        [n / top_k, mean score, max score, entropy], class histogram (C)
//      with positions past K (K < top_k) and masked slots all zero, the max
//      over valid slots only and every global stat zeroed on empty rows;
//   3. (x - mu) / sigma, on the columns of the rank's slice;
// then the head of mlp.cuh over its F slice, reduced over distributed shared
// memory.  Every rank builds the whole rows: the rank and the global stats
// need all K slots and all top_k positions anyway, a row is ~1.5 KB, and a
// rank that builds only its slice would have to share the order and stats
// over the cluster, which costs more barriers than the redundant work.
//
// Bound on the H100: at B = 64, K = 64, F = 387, H = 128 it reads ~0.3 MB of
// detections and weights and does ~6.5 MFLOP, well under a microsecond at
// either the memory or the float32 rate, so it is bound by its launch and by
// the latency of its serial steps: the detections' round trip, the rank, the
// per-image stats (a warp an image, shuffle reductions and ballots), and the
// cluster's two barriers.  Every intermediate (keys, order, feature rows,
// partial and hidden activations) stays on chip, so the only traffic is one
// read of the detections per rank, one of each W1 slice per CTA, and one
// float written per image.
#include "iou.cuh"  // rank_count
#include "mlp.cuh"

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The tile's scratch after the head's layout: mu and sigma (ldx each), then,
// for each of the TB images, its keys (K rounded up to 4, padded with -inf,
// 16-byte aligned), its detections (scores, boxes, classes, mask bytes) and
// its top-k order.
struct SpScratch {
  float *mu, *sigma, *keys, *scores, *boxes;
  int *classes, *order;
  unsigned char* mask;
};

__host__ __device__ inline size_t sp_extra(int K, int top_k, int ldx, int tb) {
  return sizeof(float) * 2 * static_cast<size_t>(ldx) +
         static_cast<size_t>(tb) *
             (sizeof(float) * (mlp_pad4(K) + 6 * K) + sizeof(int) * top_k + K);
}

__device__ SpScratch sp_scratch(unsigned char* base, int K, int top_k, int ldx, int tb) {
  SpScratch s;
  s.mu = reinterpret_cast<float*>(base);
  s.sigma = s.mu + ldx;
  s.keys = s.sigma + ldx;
  s.scores = s.keys + tb * mlp_pad4(K);
  s.boxes = s.scores + tb * K;
  s.classes = reinterpret_cast<int*>(s.boxes + 4 * tb * K);
  s.order = s.classes + tb * K;
  s.mask = reinterpret_cast<unsigned char*>(s.order + tb * top_k);
  return s;
}

// The TB feature rows of images img0 .. img0 + TB - 1 into xs[TB][ldx],
// standardized in the columns [f0, f0 + width) (zeros past F; images past B
// are built as empty rows and never stored), every image at once, from every
// thread of the CTA.
template <int TB>
__device__ void build_rows(float* xs, int ldx, int f0, int width, const SpScratch& t, int img0,
                           int rows,
                           const float* __restrict__ boxes, const float* __restrict__ scores,
                           const int* __restrict__ classes,
                           const unsigned char* __restrict__ mask, int K, int top_k, int C,
                           int F, float image_size) {
  const int per_box = 7 + C;
  const int n_sel = min(K, top_k);
  const int glob = top_k * per_box;  // offset of the global stats

  // the detections into shared memory, all loads in flight at once (with
  // b1, w2, b2, mu and sigma on the first tile): one round trip
  for (int idx = threadIdx.x; idx < TB * K; idx += blockDim.x) {
    const bool valid = idx / K < rows;
    const size_t g = valid ? static_cast<size_t>(img0) * K + idx : 0;
    cp_async4(smem_u32(t.scores + idx), scores + g, valid);
    cp_async4(smem_u32(t.classes + idx), classes + g, valid);
#pragma unroll
    for (int d = 0; d < 4; ++d)
      cp_async4(smem_u32(t.boxes + 4 * idx + d), boxes + 4 * g + d, valid);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < TB * K; idx += blockDim.x)
    t.mask[idx] = idx / K < rows ? mask[static_cast<size_t>(img0) * K + idx] : 0;
  cp_async_wait<0>();
  __syncthreads();
  const int Kp = mlp_pad4(K);  // a slot past K is keyed -inf: it ranks after every real one
  for (int idx = threadIdx.x; idx < TB * Kp; idx += blockDim.x) {
    const int im = idx / Kp, i = idx % Kp, s = im * K + i;
    t.keys[idx] = i < K && t.mask[s] ? t.scores[s] : -INFINITY;
  }
  __syncthreads();

  // each slot's rank counted by S lanes of one warp (S the largest power of 2
  // <= 8 with TB K S threads), 4 keys a load, their counts added by shuffles
  int S = 1;
  while (S < 8 && TB * K * S * 2 <= static_cast<int>(blockDim.x)) S *= 2;
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x - lane; base < TB * K * S; base += blockDim.x) {
    const int idx = base + lane;
    const bool ok = idx < TB * K * S;
    const int im = idx / S / K, i = idx / S % K;
    int rank = 0;
    if (ok) {
      const float* keys = t.keys + im * Kp;
      rank = rank_count(keys, Kp, keys[i], i, 4 * (idx % S), 4 * S);
    }
    for (int off = S / 2; off > 0; off >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (ok && idx % S == 0 && rank < top_k) t.order[im * top_k + rank] = i;
  }
  __syncthreads();

  // the per-box features (threads from 0 up) and the global stats (a warp an
  // image, warps from the last down) at once: the stats read the scores, not
  // the rows
  for (int idx = threadIdx.x; idx < TB * top_k; idx += blockDim.x) {
    const int im = idx / top_k, p = idx % top_k;
    float* fb = xs + static_cast<size_t>(im) * ldx + p * per_box;
    for (int j = 0; j < per_box; ++j) fb[j] = 0.0f;
    if (p < n_sel) {
      const int i = im * K + t.order[idx];
      const float m = t.mask[i] ? 1.0f : 0.0f;
      const float* bx = t.boxes + 4 * i;
      const float x1 = bx[0] / image_size, y1 = bx[1] / image_size;
      const float x2 = bx[2] / image_size, y2 = bx[3] / image_size;
      const float cx = (x1 + x2) / 2.0f;
      const float cy = (y1 + y2) / 2.0f;
      // a NaN coordinate stays NaN in its features, as in box_feature_stack
      const float w = max_nan(x2 - x1, 0.0f);
      const float h = max_nan(y2 - y1, 0.0f);
      const float area = w * h;
      const float aspect = min_nan(max_nan(w / max_nan(h, 1e-6f), 0.0f), 10.0f) / 10.0f;
      fb[0] = t.scores[i] * m;
      fb[1] = cx * m;
      fb[2] = cy * m;
      fb[3] = w * m;
      fb[4] = h * m;
      fb[5] = area * m;
      fb[6] = aspect * m;
      if (m > 0.0f) fb[7 + min(max(t.classes[i], 0), C - 1)] = 1.0f;
    }
  }
  for (int im = MLP_WARPS - 1 - (threadIdx.x >> 5); im < TB; im += MLP_WARPS) {
    const int* order = t.order + im * top_k;
    const unsigned char* msk = t.mask + im * K;
    const int* cls = t.classes + im * K;
    const float* sc = t.scores + im * K;
    float* g = xs + static_cast<size_t>(im) * ldx + glob;
    for (int c = lane; c < C; c += 32) g[4 + c] = 0.0f;
    __syncwarp();
    int n = 0;
    float s_sum = 0.0f, s_max = -INFINITY;
    for (int p0 = 0; p0 < n_sel; p0 += 32) {
      const int p = p0 + lane;
      const int i = p < n_sel ? order[p] : 0;
      const bool valid = p < n_sel && msk[i];
      const float s = valid ? sc[i] : 0.0f;  // the row's score column
      n += __popc(__ballot_sync(0xffffffffu, valid));
      if (valid) s_max = fmaxf(s_max, s);
      s_sum += s;
      // the class histogram: the lowest lane of each class's valid lanes
      // adds their count, an exact integer
      const int cl = valid ? min(max(cls[i], 0), C - 1) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, cl);
      if (valid && lane == __ffs(peers) - 1) g[4 + cl] += static_cast<float>(__popc(peers));
      __syncwarp();
    }
    s_sum = warp_sum(s_sum);
    s_max = warp_max(s_max);
    if (n > 0) {
      const float nf = static_cast<float>(n);
      const float denom = fmaxf(s_sum, 1e-9f);
      float ent = 0.0f;
      for (int p = lane; p < n_sel; p += 32) {
        const int i = order[p];
        const float q = (msk[i] ? sc[i] : 0.0f) / denom;
        ent -= q * logf(fmaxf(q, 1e-12f));
      }
      ent = warp_sum(ent);
      if (lane == 0) {
        g[0] = nf / (float)top_k;
        g[1] = s_sum / nf;
        g[2] = s_max;
        g[3] = ent;
      }
      for (int c = lane; c < C; c += 32) g[4 + c] /= nf;
    } else if (lane < 4) {
      g[lane] = 0.0f;  // the bins are all 0 already
    }
  }
  __syncthreads();

  // standardize the columns [f0, f0 + width) this rank reads, zero past F
  for (int idx = threadIdx.x; idx < TB * width; idx += blockDim.x) {
    const int f = f0 + idx % width;
    float* v = xs + static_cast<size_t>(idx / width) * ldx + f;
    *v = f < F ? (*v - t.mu[f]) / t.sigma[f] : 0.0f;
  }
  // mlp_partials' first barrier publishes the rows
}

template <int TB, bool VEC>
__global__ void __launch_bounds__(MLP_THREADS, 1)
score_pipeline_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                      const int* __restrict__ classes, const unsigned char* __restrict__ mask,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ mu, const float* __restrict__ sigma,
                      float* __restrict__ out, int B, int K, int top_k, int C, int F, int H,
                      float image_size, int slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / cs, nclusters = gridDim.x / cs;
  const int tiles = (B + TB - 1) / TB;
  const int my_tiles = (tiles - cid + nclusters - 1) / nclusters;
  const int ldx = mlp_pad4(F);
  const MlpLayout L = mlp_layout(F, H, cs, TB, slab_rows, ldx, sp_extra(K, top_k, ldx, TB));
  const MlpCta c = mlp_begin(smem, L, F, H, cs, rank, my_tiles, w1, b1, w2, b2);  // W1 first
  const bool direct = mlp_direct(c, cs, H);
  float* xs = reinterpret_cast<float*>(smem + L.xs);  // [TB][ldx]
  const SpScratch t = sp_scratch(smem + L.extra, K, top_k, ldx, TB);
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    cp_async4(smem_u32(t.mu + f), mu + f);
    cp_async4(smem_u32(t.sigma + f), sigma + f);
  }

  for (int it = 0; it < my_tiles; ++it) {
    const int img0 = (cid + it * nclusters) * TB;
    const int rows = mlp_min(TB, B - img0);
    build_rows<TB>(xs, ldx, c.f0, mlp_pad4(c.rows), t, img0, rows, boxes, scores, classes, mask,
                   K, top_k, C, F, image_size);
    if (direct) {
      mlp_partials<TB, VEC>(c, xs + c.f0, ldx, w1, H, it, out + img0, rows);
    } else {
      mlp_partials<TB, VEC>(c, xs + c.f0, ldx, w1, H, it);
      mlp_reduce<TB>(cluster, c, rows, H, out + img0);
    }
  }
}

// the kernel for tiles of TB rows, with 16-byte W1 loads when `vec`
template <int TB>
static auto instance(bool vec) {
  return vec ? &score_pipeline_kernel<TB, true> : &score_pipeline_kernel<TB, false>;
}

// boxes (B, K, 4) float32, scores (B, K) float32, classes (B, K) int32,
// mask (B, K) bool as bytes, w1 (F, H) 16-byte aligned, b1 (H,), w2 (H,),
// b2 (), mu (F,), sigma (F,), out (B,): contiguous, on the current device.
// B, K >= 1 and F == top_k * (7 + C) + 4 + C.  The launch plan (cs, tb,
// grid, slab_rows, smem) is the wrapper's mlp_plan with full feature rows.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan this file
// does not take.
REPRO_EXPORT int score_pipeline_f32(const void* boxes, const void* scores, const void* classes,
                                    const void* mask, const float* w1, const float* b1,
                                    const float* w2, const float* b2, const float* mu,
                                    const float* sigma, float* out, int B, int K, int top_k,
                                    int C, int F, int H, float image_size, int cs, int tb,
                                    int grid, int slab_rows, int smem, void* stream) {
  const int ldx = mlp_pad4(F);
  const MlpLayout L = mlp_layout(F, H, cs, tb, slab_rows, ldx, sp_extra(K, top_k, ldx, tb));
  if (!mlp_plan_ok(L, cs, tb, grid, static_cast<size_t>(smem)))
    return static_cast<int>(cudaErrorInvalidValue);
  // W1 rows of a multiple of 4 floats take 16-byte loads
  const bool vec = H % 4 == 0;
  const auto kernel = tb == 2 ? instance<2>(vec) : tb == 4 ? instance<4>(vec)
                    : tb == 8 ? instance<8>(vec) : tb == 16 ? instance<16>(vec)
                    : tb == 32 ? instance<32>(vec) : instance<64>(vec);
  return launch_pdl(kernel, dim3(grid), MLP_THREADS, static_cast<size_t>(smem), stream, cs,
                    static_cast<const float*>(boxes), static_cast<const float*>(scores),
                    static_cast<const int*>(classes), static_cast<const unsigned char*>(mask), w1,
                    b1, w2, b2, mu, sigma, out, B, K, top_k, C, F, H, image_size, slab_rows);
}
