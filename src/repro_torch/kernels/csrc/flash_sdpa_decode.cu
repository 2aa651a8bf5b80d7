// Split-K attention for a few query rows a KV head: the "decode" route of
// flash_sdpa (bfloat16, D in {64, 80, 128}, S <= G = H / KH), taken by every
// decode step of the dense stack (S = 1).
//
// Replaces the Pallas kernel repro/kernels/flash_sdpa/kernel.py:24
// (_flash_kernel; wrapper flash_sdpa_pallas at :65, pallas_call at :83) at
// its decode shape.  Same function as flash_sdpa.cu; all arithmetic float32,
// the output rounded to bfloat16 once.
//
// Bound on the H100 at qwen2-7b's decode step (B = 8, S = 1, 28 query heads
// over 4 KV heads, D = 128, q_offset = 512, T = 528 cache slots): the 513
// visible keys' K and V are 8.4 MB, 2.5 us at 3.35 TB/s; the products are
// 4 D B H 513 = 59 MFLOP, about 14 flops a byte, far below the ~295 at which
// bf16 stops being bound by bytes -- so CUDA-core float32 dot products are
// the right tool and the kernel's job is to keep bytes in flight.  The first
// version (flash_sdpa.cu at S = 1, now the float32 route) took 0.534 ms, its
// tile-load revision 0.0563 ms (NVIDIA H100 80GB HBM3, 700 W): one 16-row block a
// query head, so every key was read by the G = 7 heads of its group and each
// block walked its 17 tiles one after another.  What this design does:
// - one CTA a (batch, KV head, split of the key range): it holds all
//   R = S G query rows of the group (7 at qwen2-7b), so each K/V byte is read
//   once, not G times;
// - the key range [kbeg, kend) is cut into 32-key tiles and the tiles into
//   `splits` runs (flash_sdpa/ops.py: decode_plan; 9 at qwen2-7b, so 32
//   (batch, KV head) pairs x 9 = 288 CTAs, over twice the 132 SMs);
// - tiles stream through a 2-stage ring of cp.async copies (the next tile's
//   K and V are in flight while this one is used), K rows padded by 16 bytes
//   so the 32 lanes' 16-byte reads of 32 keys hit distinct banks;
// - each split writes its partial row max m (log2 domain), denominator l and
//   unnormalised output acc to a float32 scratch, and a second small kernel
//   merges the splits by the log-sum-exp rule; a split (or a whole row) that
//   sees no key has m = -inf and weighs 0, and a row no split sees gives 0.
// D = 80 (zamba2-2.7b) needs nothing of its own: a K row is 10 16-byte
// chunks (176 bytes padded, so 8 lanes' 16-byte reads still hit distinct
// banks), a V row 160 bytes, the P V pass 40 column pairs and the merge 80
// threads, every offset a multiple of 16 bytes.
// ptxas (sm_90a): the split kernel 48 registers at D = 128 (32 at D = 64),
// the merge 32, no spills; 41,952 bytes of dynamic shared memory at
// qwen2-7b's R = 7 rows.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int DEC_TK = 32;       // keys a tile (one a lane in the softmax)
constexpr int DEC_THREADS = 128;
constexpr float NEG_INF = -INFINITY;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Byte offsets of the dynamic shared memory for R rows of width D.
struct DecodeSmem {
  int q, k, v, p, acc, m, l, alpha, bytes;
  __host__ __device__ DecodeSmem(int R, int D) {
    q = 0;                                         // R x D float
    k = q + R * D * 4;                             // 2 x TK x (D + 8) bf16
    v = k + 2 * DEC_TK * (D + 8) * 2;              // 2 x TK x D bf16
    p = v + 2 * DEC_TK * D * 2;                    // R x TK float
    acc = p + R * DEC_TK * 4;                      // R x D float
    m = acc + R * D * 4;                           // R float each
    l = m + ((R * 4 + 15) & ~15);
    alpha = l + ((R * 4 + 15) & ~15);
    bytes = alpha + ((R * 4 + 15) & ~15);
  }
};

template <int D>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int S, int T, int H, int KH, int causal,
                          int window, int q_offset, int kbeg, int kend, int tiles_per_split,
                          float scale_log2) {
  constexpr int KP = D + 8;  // padded K row (elements)
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, splits = gridDim.x;
  const int G = H / KH, R = S * G;
  const DecodeSmem lay(R, D);
  float* Qs = reinterpret_cast<float*>(smem + lay.q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + lay.k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + lay.v);
  float* Ps = reinterpret_cast<float*>(smem + lay.p);
  float* Acc = reinterpret_cast<float*>(smem + lay.acc);
  float* Ms = reinterpret_cast<float*>(smem + lay.m);
  float* Ls = reinterpret_cast<float*>(smem + lay.l);
  float* Al = reinterpret_cast<float*>(smem + lay.alpha);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int n_tiles = kend > kbeg ? (kend - kbeg + DEC_TK - 1) / DEC_TK : 0;
  const int tile_lo = split * tiles_per_split;
  const int nt = max(0, min(n_tiles, tile_lo + tiles_per_split) - tile_lo);

  // K and V of tile `it` of this split into ring slot `buf`; keys at or past
  // kend are zero-filled
  auto load_tile = [&](int it, int buf) {
    constexpr int CH = D / 8;  // 16-byte chunks a row
    const int key0 = kbeg + (tile_lo + it) * DEC_TK;
    for (int i = tid; i < DEC_TK * CH; i += DEC_THREADS) {
      const int j = i / CH, c = i % CH, key = key0 + j;
      const bool ok = key < kend;
      const long long off = ((static_cast<long long>(b) * T + (ok ? key : 0)) * KH + kvh) * D + c * 8;
      cp_async16(smem_u32(Ks + (buf * DEC_TK + j) * KP + c * 8), k + off, ok);
      cp_async16(smem_u32(Vs + (buf * DEC_TK + j) * D + c * 8), v + off, ok);
    }
    cp_async_commit();
  };
  if (nt > 0) load_tile(0, 0);

  // the group's rows: row r = s G + g is query s of head kvh G + g
  for (int i = tid; i < R * D; i += DEC_THREADS) {
    const int r = i / D, d = i % D, s = r / G, g = r % G;
    Qs[i] = __bfloat162float(q[((static_cast<long long>(b) * S + s) * H + kvh * G + g) * D + d]);
    Acc[i] = 0.0f;
  }
  for (int r = tid; r < R; r += DEC_THREADS) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.0f;
  }

  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    if (it + 1 < nt) {
      load_tile(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed (and Qs, Acc, Ms, Ls are set)
    const int key0 = kbeg + (tile_lo + it) * DEC_TK;

    // scores: one (row, key) pair a thread at a time, D-long dot products
    // with two partial sums; the lanes of a warp take the 32 keys of a row
    for (int pi = tid; pi < R * DEC_TK; pi += DEC_THREADS) {
      const int r = pi / DEC_TK, j = pi % DEC_TK;
      const __nv_bfloat16* kr = Ks + (buf * DEC_TK + j) * KP;
      const float* qr = Qs + r * D;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const __nv_bfloat162* kh = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float4 q0 = *reinterpret_cast<const float4*>(qr + c);
        const float4 q1 = *reinterpret_cast<const float4*>(qr + c + 4);
        const float2 k0 = __bfloat1622float2(kh[0]), k1 = __bfloat1622float2(kh[1]);
        const float2 k2 = __bfloat1622float2(kh[2]), k3 = __bfloat1622float2(kh[3]);
        a0 = fmaf(q0.x, k0.x, a0);
        a1 = fmaf(q0.y, k0.y, a1);
        a0 = fmaf(q0.z, k1.x, a0);
        a1 = fmaf(q0.w, k1.y, a1);
        a0 = fmaf(q1.x, k2.x, a0);
        a1 = fmaf(q1.y, k2.y, a1);
        a0 = fmaf(q1.z, k3.x, a0);
        a1 = fmaf(q1.w, k3.y, a1);
      }
      const int key = key0 + j, qpos = q_offset + r / G;
      const bool ok = key < kend && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
      Ps[pi] = ok ? (a0 + a1) * scale_log2 : NEG_INF;
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ...; lane j holds key j
    for (int r = warp; r < R; r += DEC_THREADS / 32) {
      const float x = Ps[r * DEC_TK + lane];
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_safe = m_new == NEG_INF ? 0.0f : m_new;
      const float p = exp2f(x - m_safe);  // masked: exp2(-inf) = 0
      const float alpha = m_old == NEG_INF ? 0.0f : exp2f(m_old - m_safe);
      const float sum = warp_sum(p);
      Ps[r * DEC_TK + lane] = p;
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
        Al[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + P V: a thread takes (row, 2 adjacent columns)
    for (int e = tid; e < R * (D / 2); e += DEC_THREADS) {
      const int r = e / (D / 2), dp = e % (D / 2);
      const float* pr = Ps + r * DEC_TK;
      const __nv_bfloat16* vc = Vs + buf * DEC_TK * D + 2 * dp;
      float x0 = 0.0f, x1 = 0.0f;
#pragma unroll 8
      for (int j = 0; j < DEC_TK; ++j) {
        const float pj = pr[j];
        const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vc + j * D));
        x0 = fmaf(pj, vv.x, x0);
        x1 = fmaf(pj, vv.y, x1);
      }
      float2* a = reinterpret_cast<float2*>(Acc + r * D + 2 * dp);
      const float al = Al[r];
      const float2 cur = *a;
      *a = make_float2(fmaf(cur.x, al, x0), fmaf(cur.y, al, x1));
    }
    __syncthreads();  // the slot is free for the load two tiles on
  }
  if (nt == 0) __syncthreads();

  // partials: row (b, kvh, split, r) of the scratch
  const long long row = (static_cast<long long>(b * KH + kvh) * splits + split) * R;
  for (int i = tid; i < R * D; i += DEC_THREADS) part_acc[row * D + i] = Acc[i];
  for (int r = tid; r < R; r += DEC_THREADS) {
    part_ml[(row + r) * 2] = Ms[r];
    part_ml[(row + r) * 2 + 1] = Ls[r];
  }
}

// out[b, s, kvh G + g, d] = sum_i 2^(m_i - M) acc_i[d] / sum_i 2^(m_i - M) l_i
// over the splits i, M = max_i m_i; 0 when no split saw a key
template <int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                            __nv_bfloat16* __restrict__ out, int S, int H, int KH, int splits) {
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = H / KH, R = S * G, s = r / G, g = r % G;
  const long long row = static_cast<long long>(b * KH + kvh) * splits * R + r;
  float M = NEG_INF;
  for (int i = 0; i < splits; ++i) M = fmaxf(M, part_ml[(row + i * R) * 2]);
  float l = 0.0f, a = 0.0f;
  if (M != NEG_INF) {
    for (int i = 0; i < splits; ++i) {
      const float m = part_ml[(row + i * R) * 2];
      if (m == NEG_INF) continue;
      const float w = exp2f(m - M);
      l = fmaf(w, part_ml[(row + i * R) * 2 + 1], l);
      a = fmaf(w, part_acc[(row + i * R) * D + d], a);
    }
  }
  out[((static_cast<long long>(b) * S + s) * H + kvh * G + g) * D + d] =
      __float2bfloat16(a / fmaxf(l, 1e-30f));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* part_acc,
           float* part_ml, int B, int S, int T, int H, int KH, int causal, int window,
           int q_offset, int kbeg, int kend, int tiles_per_split, int splits,
           cudaStream_t stream) {
  const int R = S * (H / KH);
  const int smem = DecodeSmem(R, D).bytes;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_decode_split_kernel<D><<<dim3(splits, KH, B), DEC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), part_acc, part_ml, S, T, H, KH, causal, window,
      q_offset, kbeg, kend, tiles_per_split, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_combine_kernel<D><<<dim3(R, KH, B), D, 0, stream>>>(
      part_acc, part_ml, static_cast<__nv_bfloat16*>(out), S, H, KH, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out (B, S, H, D); k, v (B, T, KH, D): contiguous bfloat16 on the current
// device, k and v 16-byte aligned; H % KH == 0, D in {64, 80, 128}, S (H / KH)
// <= 64.  The keys [kbeg, kend) are cut into 32-key tiles, tiles_per_split
// of them a split, `splits` splits; part_acc (B, KH, splits, S H / KH, D) and
// part_ml (B, KH, splits, S H / KH, 2) are float32 scratch.  Two launches:
// the splits, then their merge.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for another D).
REPRO_EXPORT int flash_sdpa_decode(const void* q, const void* k, const void* v, void* out,
                                   float* part_acc, float* part_ml, int B, int S, int T, int H,
                                   int KH, int D, int causal, int window, int q_offset, int kbeg,
                                   int kend, int tiles_per_split, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, part_acc, part_ml, B, S, T, H, KH, causal, window, q_offset,
                        kbeg, kend, tiles_per_split, splits, st);
    case 80:
      return launch<80>(q, k, v, out, part_acc, part_ml, B, S, T, H, KH, causal, window, q_offset,
                        kbeg, kend, tiles_per_split, splits, st);
    case 128:
      return launch<128>(q, k, v, out, part_acc, part_ml, B, S, T, H, KH, causal, window,
                         q_offset, kbeg, kend, tiles_per_split, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
