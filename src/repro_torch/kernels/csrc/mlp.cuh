// The reward-estimator head shared by estimator_mlp.cu and score_pipeline.cu:
//
//     out[r] = sigmoid(sum_h gelu_tanh(x[r] . W1[:, h] + b1[h]) * w2[h] + b2)
//
// for up to TB rows of one block of SPLIT * MLP_GROUP threads.  Within a group
// of MLP_GROUP threads each thread owns one hidden unit h of a chunk of
// MLP_GROUP units; the SPLIT groups walk interleaved slices of F (f = g, g +
// SPLIT, ...), each thread keeping TB accumulators in registers and reading
// W1[f, h] (W1 is (F, H) row-major, so a warp reads 32 consecutive floats of a
// row).  Splitting F gives each SM SPLIT times the warps to hide the W1 and x
// load latency behind, and each warp a walk SPLIT times shorter, since the
// walk, not the arithmetic, bounds the head at serve shapes.  The groups'
// partial sums meet in shared memory, and group 0 applies gelu and w2 at once,
// so the hidden activation never goes to device memory; a warp-shuffle
// reduction over group 0 gives each row's sum.  Any F and H.
#pragma once

#include "common.cuh"

constexpr int MLP_GROUP = 128;

template <int TB, int SPLIT>
__device__ void mlp_head_rows(const float* __restrict__ xs, int ldx, int rows,
                              int F, int H,
                              const float* __restrict__ w1,
                              const float* __restrict__ b1,
                              const float* __restrict__ w2,
                              const float* __restrict__ b2,
                              float* __restrict__ out) {
  static_assert(SPLIT >= 2, "the F walk is split across at least two groups");
  __shared__ float partial[SPLIT - 1][TB][MLP_GROUP];
  __shared__ float red[TB][MLP_GROUP / 32];
  const int g = threadIdx.x / MLP_GROUP;
  const int u = threadIdx.x % MLP_GROUP;
  // rows past the end of a ragged last tile recompute the last real row; their
  // results are never stored
  const float* xr[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) xr[r] = xs + (size_t)min(r, rows - 1) * ldx;

  float part[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) part[r] = 0.0f;

  for (int h0 = 0; h0 < H; h0 += MLP_GROUP) {
    const int h = h0 + u;
    float acc[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.0f;
    if (h < H) {
      for (int f = g; f < F; f += SPLIT) {
        const float w = w1[(size_t)f * H + h];
#pragma unroll
        for (int r = 0; r < TB; ++r) acc[r] = fmaf(xr[r][f], w, acc[r]);
      }
    }
    if (g > 0) {
#pragma unroll
      for (int r = 0; r < TB; ++r) partial[g - 1][r][u] = acc[r];
    }
    __syncthreads();
    if (g == 0 && h < H) {
      const float bias = b1[h];
      const float head = w2[h];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        float a = acc[r];
        for (int k = 0; k < SPLIT - 1; ++k) a += partial[k][r][u];
        part[r] += gelu_tanh(a + bias) * head;
      }
    }
    __syncthreads();  // partial is rewritten by the next chunk
  }

  if (g == 0) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      float v = part[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[r][warp] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < MLP_GROUP / 32; ++w) s += red[threadIdx.x][w];
    out[threadIdx.x] = sigmoid(s + b2[0]);
  }
}
