// Stage kernels of the block-GRU core step, shared by blockgru.cu and
// observe.cu.
//
// Replaces the core of the Pallas TPU kernels embodied_tpu/ops/blockgru.py
// (_kernel) and embodied_tpu/ops/observe.py (_obs_kernel). It computes the
// same function, not the same blocks: the TPU kernel keeps all weights in
// VMEM and runs one unrolled matmul per GRU block; here the step is a short
// chain of launches, one per matmul stage, with a `finish` launch after
// each stage whose output goes through an RMS norm:
//
//   in_proj  pre = [deter @ w0 + b0, stoch @ w1 + b1]          (B, 2H) f32
//   finish   xn = bf16(silu(rms(pre half) * s0 | s1))           (B, 2H) bf16
//   hidden   hpre = blockdiag(deter, wblk) + bblk + [xn, act] @ win (B, D)
//   finish   h = bf16(silu(rms(hpre) * sh))                      (B, D) bf16
//   gru      gates = blockdiag(h, wg) + bg, then
//            deter' = u * tanh(r * c) + (1 - u) * deter          (B, D) bf16
//
// Bound on an H100: at acting batch (B = 16) the step reads each weight
// byte once and does 2 B = 32 flops per bf16 weight (16 per byte), far
// below the ~295 per byte the card needs to be bound by operations, so the
// bound is bytes (weights over 3.35 TB/s). What the design does about it:
// one block per 16 x 16 output tile reads its weight tile once per row
// tile, with 16-byte loads, and every row of the tile reuses it from
// shared memory. A matmul stage with few output tiles (the input
// projection has 32 at B = 16, the posterior head 16) would leave most of
// the 132 SMs idle while a few blocks walk K thousands deep, so the
// contraction is split (split-K, grid z): every split writes its own f32
// partial sums and the `finish` kernel adds them in a fixed order, so the
// result does not depend on scheduling. The wrapper picks the split count
// from the batch and the SM count (1 at large batch). Products run on the
// FMA units in f32, not on the tensor cores, so at large batch (B = 1024,
// bound by operations) the kernel is far from its bound. Tensor cores
// (wgmma), TMA and one persistent launch are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blockgru {

typedef __nv_bfloat16 bf16;

constexpr int TM = 16;            // rows per block
constexpr int TN = 16;            // output columns per block
constexpr int KC = 128;           // contraction chunk staged in shared memory
constexpr int THREADS = TM * TN;  // one output (row, column) per thread
constexpr int FIN_THREADS = 256;  // threads of a finish block (one row)

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

// X(row, k) = x[row * ld + k] for a bf16 matrix.
struct LoadBf16 {
  const bf16* x;
  int ld;
  __device__ float operator()(int row, int k) const {
    return to_f(x[(size_t)row * ld + k]);
  }
};

// Split z of a contraction of depth K cut into ns nearly equal parts.
__device__ __forceinline__ void split_range(int K, int ns, int z, int* lo,
                                            int* hi) {
  *lo = (int)((long long)K * z / ns);
  *hi = (int)((long long)K * (z + 1) / ns);
}

// acc[j] += sum_k X(row, k) * W_j[k, c] over k in [lo, hi), for the
// thread's (row, c) of the tile. W_j = w + j * wstep points at column 0 of
// the tile in a row-major bf16 matrix with row stride ldw. The NW weight
// tiles share the staged input chunk. Requires ldw and the tile's column
// offset to be multiples of 8 and w 16-byte aligned (16-byte loads); the
// wrapper checks the shapes. All threads of the block must call it alike.
template <int NW, class Loader>
__device__ void tile_mm(float (&acc)[NW], const Loader& load, int lo, int hi,
                        const bf16* w, int wstep, int ldw, int row0, int B,
                        float* xs, float* ws) {
  const int t = threadIdx.x, r = t / TN, c = t % TN;
  for (int k0 = lo; k0 < hi; k0 += KC) {
    for (int i = t; i < TM * KC; i += THREADS) {
      const int rr = i / KC, kk = i % KC;
      const int row = row0 + rr, k = k0 + kk;
      xs[i] = (row < B && k < hi) ? load(row, k) : 0.f;
    }
    for (int i = t; i < NW * KC * 2; i += THREADS) {
      const int j = i / (KC * 2), rem = i % (KC * 2);
      const int kk = rem / 2, half = rem % 2, k = k0 + kk;
      float* dst = ws + (j * KC + kk) * TN + half * 8;
      if (k < hi) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            w + (size_t)j * wstep + (size_t)k * ldw + half * 8);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[q] = to_f(e[q]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[q] = 0.f;
      }
    }
    __syncthreads();
    const float* xr = xs + r * KC;
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float x = xr[kk];
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] += x * ws[(j * KC + kk) * TN + c];
    }
    __syncthreads();
  }
}

// The part of segment [seg, seg + len) of a concatenated contraction that
// falls in this split's [lo, hi): X and W are indexed from the segment's
// start. The condition is the same for every thread of the block.
template <class Loader>
__device__ void segment_mm(float (&acc)[1], const Loader& load, int seg,
                           int len, int lo, int hi, const bf16* w, int ldw,
                           int row0, int B, float* xs, float* ws) {
  const int a = max(lo - seg, 0), b = min(hi - seg, len);
  if (a < b) tile_mm<1>(acc, load, a, b, w, 0, ldw, row0, B, xs, ws);
}

// Stage 1, split z = blockIdx.z: pre[z][:, :H] and pre[z][:, H:], the
// split's partial sums of deter @ w0 and stoch @ w1; split 0 adds b0, b1.
// Grid (2 * H / TN, ceil(B / TM), ns).
__global__ void __launch_bounds__(THREADS)
in_proj_kernel(const bf16* deter, const bf16* stoch, const bf16* w0,
               const bf16* b0, const bf16* w1, const bf16* b1, float* pre,
               int B, int D, int S, int H, int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int tiles = H / TN, z = blockIdx.z;
  const bool second = blockIdx.x >= tiles;
  const int col0 = (blockIdx.x % tiles) * TN, row0 = blockIdx.y * TM;
  int lo, hi;
  split_range(second ? S : D, ns, z, &lo, &hi);
  float acc[1] = {0.f};
  const LoadBf16 load = second ? LoadBf16{stoch, S} : LoadBf16{deter, D};
  tile_mm<1>(acc, load, lo, hi, (second ? w1 : w0) + col0, 0, H, row0, B,
             xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    const float bias = z ? 0.f : to_f((second ? b1 : b0)[col]);
    pre[((size_t)z * B + row) * 2 * H + (second ? H : 0) + col] =
        acc[0] + bias;
  }
}

// out[row, g W + c] = bf16(silu(x * rsqrt(mean(x^2) + eps) * scale_g[c]))
// over the W columns of group g (blockIdx.y; scale0 or scale1), where
// x = the sum of the ns partial sums parts[s][row, g W + c] (row stride
// ld). One block per (row, group); the sum runs in split order.
__global__ void __launch_bounds__(FIN_THREADS)
finish_kernel(const float* parts, int ns, int B, int ld, int W,
              const float* scale0, const float* scale1, float eps,
              bf16* out) {
  __shared__ float red[FIN_THREADS / 32];
  const int row = blockIdx.x, g = blockIdx.y;
  const float* scale = g ? scale1 : scale0;
  const size_t base = (size_t)row * ld + (size_t)g * W;
  const size_t step = (size_t)B * ld;
  float ss = 0.f;
  for (int c = threadIdx.x; c < W; c += FIN_THREADS) {
    float v = 0.f;
    for (int s = 0; s < ns; ++s) v += parts[s * step + base + c];
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < FIN_THREADS / 32; ++i) total += red[i];
  const float rstd = rsqrtf(total / W + eps);
  for (int c = threadIdx.x; c < W; c += FIN_THREADS) {
    float v = 0.f;
    for (int s = 0; s < ns; ++s) v += parts[s * step + base + c];
    out[base + c] = __float2bfloat16(silu(v * rstd * scale[c]));
  }
}

// Stage 2, split z: the split's partial sums of the contraction
// [deter block (dg) | xn (2H) | act (A)] against [wblk[blk]; win], where
// blk is the GRU block of the tile's columns; split 0 adds bblk.
// Grid (D / TN, ceil(B / TM), ns); a column tile lies inside one GRU block.
__global__ void __launch_bounds__(THREADS)
hidden_kernel(const bf16* xn, const bf16* act, const bf16* deter,
              const bf16* wblk, const bf16* bblk, const bf16* win,
              float* hpre, int B, int D, int H, int A, int g, int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM, z = blockIdx.z;
  const int dg = D / g, blk = col0 / dg;
  int lo, hi;
  split_range(dg + 2 * H + A, ns, z, &lo, &hi);
  float acc[1] = {0.f};
  segment_mm(acc, LoadBf16{deter + (size_t)blk * dg, D}, 0, dg, lo, hi,
             wblk + (size_t)blk * dg * dg + (col0 - blk * dg), dg, row0, B,
             xs, ws);
  segment_mm(acc, LoadBf16{xn, 2 * H}, dg, 2 * H, lo, hi, win + col0, D,
             row0, B, xs, ws);
  segment_mm(acc, LoadBf16{act, A}, dg + 2 * H, A, lo, hi,
             win + (size_t)2 * H * D + col0, D, row0, B, xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    const float bias = z ? 0.f : to_f(bblk[col]);
    hpre[((size_t)z * B + row) * D + col] = acc[0] + bias;
  }
}

// Stage 3: the gate products of block `blk` for the tile's columns i (reset
// i, candidate dg + i, update 2 dg + i of wg[blk]) and the GRU update.
// Grid (D / TN, ceil(B / TM)).
__global__ void __launch_bounds__(THREADS)
gru_kernel(const bf16* h, const bf16* wg, const bf16* bg, const bf16* deter,
           bf16* out, int B, int D, int g) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[3 * KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM;
  const int dg = D / g, blk = col0 / dg, i0 = col0 - blk * dg;
  float acc[3] = {0.f, 0.f, 0.f};
  tile_mm<3>(acc, LoadBf16{h + (size_t)blk * dg, D}, 0, dg,
             wg + (size_t)blk * dg * 3 * dg + i0, dg, 3 * dg, row0, B, xs,
             ws);
  const int row = row0 + threadIdx.x / TN, c = threadIdx.x % TN;
  if (row < B) {
    const size_t gb = (size_t)blk * 3 * dg + i0 + c;
    const float r = sigmoid(acc[0] + to_f(bg[gb]));
    const float cand = tanhf(r * (acc[1] + to_f(bg[gb + dg])));
    const float u = sigmoid(acc[2] + to_f(bg[gb + 2 * dg]) - 1.f);
    const size_t at = (size_t)row * D + col0 + c;
    const float prev = to_f(deter[at]);
    out[at] = __float2bfloat16(u * cand + (1.f - u) * prev);
  }
}

inline dim3 grid_for(int cols, int B, int ns = 1) {
  return dim3(cols / TN, (B + TM - 1) / TM, ns);
}

// The core stages on `stream`. Scratch: `pre` (ns1, B, 2H) f32, `xn`
// (B, 2H) bf16, `hpre` (ns2, B, D) f32, `h` (B, D) bf16; ns1 and ns2 are
// the split counts of the input projection and the hidden stage.
inline void launch_core(const bf16* deter, const bf16* stoch, const bf16* act,
                        const bf16* w0, const bf16* b0, const float* s0,
                        const bf16* w1, const bf16* b1, const float* s1,
                        const bf16* wblk, const bf16* bblk, const bf16* win,
                        const float* sh, const bf16* wg, const bf16* bg,
                        bf16* out, float* pre, bf16* xn, float* hpre, bf16* h,
                        int B, int D, int H, int S, int A, int g, int ns1,
                        int ns2, float eps, cudaStream_t stream) {
  in_proj_kernel<<<grid_for(2 * H, B, ns1), THREADS, 0, stream>>>(
      deter, stoch, w0, b0, w1, b1, pre, B, D, S, H, ns1);
  finish_kernel<<<dim3(B, 2), FIN_THREADS, 0, stream>>>(
      pre, ns1, B, 2 * H, H, s0, s1, eps, xn);
  hidden_kernel<<<grid_for(D, B, ns2), THREADS, 0, stream>>>(
      xn, act, deter, wblk, bblk, win, hpre, B, D, H, A, g, ns2);
  finish_kernel<<<dim3(B, 1), FIN_THREADS, 0, stream>>>(
      hpre, ns2, B, D, D, sh, sh, eps, h);
  gru_kernel<<<grid_for(D, B), THREADS, 0, stream>>>(
      h, wg, bg, deter, out, B, D, g);
}

}  // namespace blockgru
