// Fused reward-estimator MLP: out[b] = sigmoid(gelu_tanh(x[b] W1 + b1) . w2 + b2).
//
// Replaces the Pallas kernel repro/kernels/estimator_mlp/kernel.py:19
// (_mlp_kernel, wrapper estimator_mlp_pallas at :27, pallas_call at :39).
//
// Bound on the H100: at serve shapes (B <= 4096, F = 387, H = 128) the work is
// 2*B*F*H flops (~0.4 GFLOP at B = 4096) over ~6.5 MB of x and 0.2 MB of W1,
// well under a microsecond at the card's rates, so the kernel is bound by its
// launch and by the latency of one block's walk over F, which mlp.cuh splits
// across MLP_SPLIT groups of threads.  The design keeps the hidden activation
// on chip (the point of the TPU kernel: no round trip of the (B, H) hidden
// layer through device memory) and reuses every W1 read across MLP_ROWS rows
// of one block.  There is no 128-lane padding of F, H or w2 (a TPU
// artefact): any F and H are taken as they are.
#include "mlp.cuh"

constexpr int MLP_ROWS = 4;
constexpr int MLP_SPLIT = 4;
constexpr int MLP_THREADS = MLP_SPLIT * MLP_GROUP;

__global__ void __launch_bounds__(MLP_THREADS)
estimator_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int B, int F, int H) {
  const int row0 = blockIdx.x * MLP_ROWS;
  const int rows = min(MLP_ROWS, B - row0);
  mlp_head_rows<MLP_ROWS, MLP_SPLIT>(x + (size_t)row0 * F, F, rows, F, H, w1, b1,
                                     w2, b2, out + row0);
}

// x (B, F), w1 (F, H), b1 (H,), w2 (H,), b2 () and out (B,): contiguous
// float32 on the current device.  B >= 1.  Returns cudaGetLastError().
REPRO_EXPORT int estimator_mlp_f32(const float* x, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, float* out, int B, int F,
                                   int H, void* stream) {
  const int blocks = (B + MLP_ROWS - 1) / MLP_ROWS;
  estimator_mlp_kernel<<<blocks, MLP_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, w1, b1, w2, b2,
                                                              out, B, F, H);
  return static_cast<int>(cudaGetLastError());
}
