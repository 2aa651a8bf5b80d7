// Fused reward-estimator MLP: out[b] = sigmoid(gelu_tanh(x[b] W1 + b1) . w2 + b2).
//
// Replaces the Pallas kernel repro/kernels/estimator_mlp/kernel.py:19
// (_mlp_kernel, wrapper estimator_mlp_pallas at :27, pallas_call at :39).
//
// Bound on the H100: at serve shapes (B <= 4096, F = 387, H = 128) the work is
// 2*B*F*H flops (~0.4 GFLOP at B = 4096) over ~6.5 MB of x and 0.2 MB of W1,
// well under a microsecond at the card's rates, so the kernel is bound by its
// launch, by how fast each SM gets its share of W1 and by the latency of its
// steps.  The design (mlp.cuh) spreads F over a thread block cluster: each
// CTA stages only its slice of W1 (B 512: 2 ranks, ~100 KB; B 64 and below:
// 4 ranks, ~50 KB) once, by bulk async copy, while its x tile (TB rows of the
// slice) arrives by cp.async; the partial pre-activations come from shared
// memory only and meet over distributed shared memory, so the hidden
// activation never goes to device memory (the point of the TPU kernel).
// There is no 128-lane padding of F, H or w2 (a TPU artefact): any F and H
// are taken as they are.
#include "mlp.cuh"

template <int TB, bool VEC>
__global__ void __launch_bounds__(MLP_THREADS, 1)
estimator_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, int B, int F, int H,
                     int slab_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / cs, nclusters = gridDim.x / cs;
  const int tiles = (B + TB - 1) / TB;
  const int my_tiles = (tiles - cid + nclusters - 1) / nclusters;
  const MlpLayout L = mlp_layout(F, H, cs, TB, slab_rows, 0, 0);
  const MlpCta c = mlp_begin(smem, L, F, H, cs, rank, my_tiles, w1, b1, w2, b2);  // W1 first
  const bool direct = mlp_direct(c, cs, H);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  const int ldx = L.x_cols;

  for (int it = 0; it < my_tiles; ++it) {
    const int row0 = (cid + it * nclusters) * TB;
    const int rows = mlp_min(TB, B - row0);
    // the tile's rows of this rank's slice; rows past B and columns past the
    // slice are zero-filled
    for (int i = threadIdx.x; i < TB * ldx; i += blockDim.x) {
      const int r = i / ldx, f = i % ldx;
      const bool valid = r < rows && f < c.rows;
      cp_async4(smem_u32(xs + i), valid ? x + static_cast<size_t>(row0 + r) * F + c.f0 + f : x,
                valid);
    }
    cp_async_commit();  // with b1, w2 and b2 on the first tile
    cp_async_wait<0>();
    if (direct) {
      mlp_partials<TB, VEC>(c, xs, ldx, w1, H, it, out + row0, rows);
    } else {
      mlp_partials<TB, VEC>(c, xs, ldx, w1, H, it);
      mlp_reduce<TB>(cluster, c, rows, H, out + row0);
    }
  }
}

// the kernel for tiles of TB rows, with 16-byte W1 loads when `vec`
template <int TB>
static auto instance(bool vec) {
  return vec ? &estimator_mlp_kernel<TB, true> : &estimator_mlp_kernel<TB, false>;
}

// x (B, F), w1 (F, H), b1 (H,), w2 (H,), b2 () and out (B,): contiguous
// float32 on the current device, w1 16-byte aligned.  B >= 1.  The launch
// plan (cs, tb, grid, slab_rows, smem) is the wrapper's mlp_plan.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan this file does not
// take.
REPRO_EXPORT int estimator_mlp_f32(const float* x, const float* w1, const float* b1,
                                   const float* w2, const float* b2, float* out, int B, int F,
                                   int H, int cs, int tb, int grid, int slab_rows, int smem,
                                   void* stream) {
  const MlpLayout L = mlp_layout(F, H, cs, tb, slab_rows, 0, 0);
  if (!mlp_plan_ok(L, cs, tb, grid, static_cast<size_t>(smem)))
    return static_cast<int>(cudaErrorInvalidValue);
  // W1 rows of a multiple of 4 floats take 16-byte loads
  const bool vec = H % 4 == 0;
  const auto kernel = tb == 2 ? instance<2>(vec) : tb == 4 ? instance<4>(vec)
                    : tb == 8 ? instance<8>(vec) : tb == 16 ? instance<16>(vec)
                    : tb == 32 ? instance<32>(vec) : instance<64>(vec);
  return launch_pdl(kernel, dim3(grid), MLP_THREADS, static_cast<size_t>(smem), stream, cs, x, w1,
                    b1, w2, b2, out, B, F, H, slab_rows);
}

// Clusters of `cs` CTAs with `smem` bytes of dynamic shared memory that the
// current device holds at once (the plan's grid is at most this many), or 0
// when the query fails.
REPRO_EXPORT int estimator_mlp_max_clusters(int cs, int smem) {
  return mlp_max_clusters(&estimator_mlp_kernel<16, true>, cs, static_cast<size_t>(smem));
}
