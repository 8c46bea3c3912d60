// What the whole-window kernels observe_seq.cu (the observe window,
// forward and backward) and imagine_seq.cu (the imagination rollout) add
// to the core-step and posterior-head stages of blockgru_common.cuh.
//
// A window is a chain of dependent steps, and blocks on the card run in no
// order, so the recurrent state cannot live in one block's registers the
// way the TPU kernels keep it in VMEM across sequential grid steps. Here
// the host loop inside one C entry point enqueues every step's stages on
// one stream, in order: each stage is a launch, the stream orders them,
// and a step reads the previous step's state from the slice of the output
// where that step wrote it. Python makes one ctypes call per window.
//
// The forward steps are blockgru_common.cuh's stages (core_stages,
// post_head, mm, finish), which save what the backward needs when asked;
// this file adds the stochastic sample. Backward stages add the transposed
// products (input gradients, X W^T), the RMS-norm/SiLU backward, the GRU
// gate backward, and one weight gradient kernel that contracts all T x B
// rows at once (dW = X^T dY): no atomics, so results do not depend on
// scheduling.

#pragma once

#include "blockgru_common.cuh"

namespace seq {

using namespace blockgru;

// The value bf16 would store: products of the backward take their dY
// operand in the compute dtype, as the TPU kernel casts it.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float dsilu(float y) {
  const float s = sigmoid(y);
  return s * (1.f + y * (1.f - s));
}

// Categorical sample of every (row, group) of C classes: the unimix blend
// p = (1 - unimix) softmax(logit) + unimix / C, then Gumbel-max
// argmax(log p + gumbel) (the first index on a tie), written as a one-hot.
// One warp per (row, group), eight per block.
__global__ void sample_kernel(const float* logit, const float* gum, int B,
                              int S, int C, float unimix, bf16* out) {
  const int lane = threadIdx.x % 32;
  const int wid = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (wid >= B * S) return;
  const size_t base = (size_t)wid * C;  // row * L + group * C
  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, logit[base + c]);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += expf(logit[base + c] - m);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float best = -INFINITY;
  int arg = C;
  for (int c = lane; c < C; c += 32) {
    const float sm = expf(logit[base + c] - m) / sum;
    const float y = logf((1.f - unimix) * sm + unimix / C) + gum[base + c];
    if (y > best) {
      best = y;
      arg = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  for (int c = lane; c < C; c += 32)
    out[base + c] = __float2bfloat16(c == arg ? 1.f : 0.f);
}

inline void sample(const float* logit, const float* gum, int B, int S, int C,
                   float unimix, bf16* out, cudaStream_t st) {
  const int warps = B * S;
  sample_kernel<<<(warps + 7) / 8, 256, 0, st>>>(logit, gum, B, S, C, unimix,
                                                 out);
}

// --- Backward stages --------------------------------------------------------

// dY(row, k) = bf16(y[row * ld + k]) for an f32 gradient.
struct LoadF32R {
  const float* y;
  int ld;
  __device__ float operator()(int row, int k) const {
    return round_bf16(y[(size_t)row * ld + k]);
  }
};

// acc += sum over k in [lo, hi) of Y(row, k) * w[c * ldw + k]: the product
// with a transposed weight, for the thread's (row, c) of the tile; w points
// at the tile's first column. Threads read consecutive k of one weight row.
template <class Loader>
__device__ void tile_mmt(float (&acc)[1], const Loader& load, int lo, int hi,
                         const bf16* w, int ldw, int row0, int B, float* xs,
                         float* ws) {
  const int t = threadIdx.x, r = t / TN, c = t % TN;
  for (int k0 = lo; k0 < hi; k0 += KC) {
    for (int i = t; i < TM * KC; i += THREADS) {
      const int rr = i / KC, kk = i % KC;
      const int row = row0 + rr, k = k0 + kk;
      xs[i] = (row < B && k < hi) ? load(row, k) : 0.f;
    }
    for (int i = t; i < TN * KC; i += THREADS) {
      const int cc = i / KC, kk = i % KC, k = k0 + kk;
      ws[kk * TN + cc] = k < hi ? to_f(w[(size_t)cc * ldw + k]) : 0.f;
    }
    __syncthreads();
    const float* xr = xs + r * KC;
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) acc[0] += xr[kk] * ws[kk * TN + c];
    __syncthreads();
  }
}

// One operand of a transposed product. Output column n lies in group
// q = n / gN at offset j = n % gN; the segment adds
//   sum over k < len of bf16(y[row * ldy + q * ygs + k]) * w[q * wgs + j * ldw + k].
// A dense W^T has ygs = 0 and wgs = gN * ldw; a block-diagonal one steps
// both per block.
struct TSeg {
  const float* y;
  int ldy;
  int ygs;
  const bf16* w;
  int ldw;
  size_t wgs;
  int len;
};

__device__ __forceinline__ void tseg_mm(float (&acc)[1], const TSeg& s,
                                        int seg, int lo, int hi, int q,
                                        int j0, int row0, int B, float* xs,
                                        float* ws) {
  const int a = max(lo - seg, 0), b = min(hi - seg, s.len);
  if (a < b) {
    tile_mmt(acc, LoadF32R{s.y + (size_t)q * s.ygs, s.ldy}, a, b,
             s.w + (size_t)q * s.wgs + (size_t)j0 * s.ldw, s.ldw, row0, B,
             xs, ws);
  }
}

// parts[z][row, n] (row stride N): split z of the transposed products of
// segments a and b (b.len may be 0). Grid (N / TN, ceil(B / TM), ns); a
// tile never straddles a group (gN % TN == 0).
__global__ void __launch_bounds__(THREADS)
mmt_kernel(TSeg a, TSeg b, int gN, float* parts, int B, int N, int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM, z = blockIdx.z;
  const int q = col0 / gN, j0 = col0 - q * gN;
  int lo, hi;
  split_range(a.len + b.len, ns, z, &lo, &hi);
  float acc[1] = {0.f};
  tseg_mm(acc, a, 0, lo, hi, q, j0, row0, B, xs, ws);
  tseg_mm(acc, b, a.len, lo, hi, q, j0, row0, B, xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) parts[((size_t)z * B + row) * N + col] = acc[0];
}

inline int mmt(TSeg a, TSeg b, int gN, float* parts, int B, int N, int sms,
               cudaStream_t st) {
  const int ns = splits(N, B, a.len + b.len, sms);
  mmt_kernel<<<grid_for(N, B, ns), THREADS, 0, st>>>(a, b, gN, parts, B, N,
                                                     ns);
  return ns;
}

inline TSeg no_seg() { return TSeg{nullptr, 0, 0, nullptr, 0, 0, 0}; }

// The backward of silu(rms(pre) * scale) for group g = blockIdx.y of W
// columns of one row (blockIdx.x). dx = the sum of ns partials
// dparts[s][row, g W + c] (row stride ldd); pre (row stride ldp) and
// rstd[row * gridDim.y + g] come from the recompute. With n = pre * rstd,
// y = n * scale and dy = dx * dsilu(y), it writes the pre-activation
// gradient rstd (dn - n mean(dn n)), dn = dy * scale, to out_g (row stride
// ldo) and the scale's per-row term dy * n to dsc_g.
__global__ void __launch_bounds__(FIN_THREADS)
rms_bwd_kernel(const float* dparts, int ns, int B, int ldd, int W,
               const float* pre, int ldp, const float* rstd,
               const float* scale0, const float* scale1, float* out0,
               float* out1, int ldo, float* dsc0, float* dsc1) {
  __shared__ float red[FIN_THREADS / 32];
  const int row = blockIdx.x, g = blockIdx.y;
  const float* scale = g ? scale1 : scale0;
  float* out = (g ? out1 : out0) + (size_t)row * ldo;
  float* dsc = (g ? dsc1 : dsc0) + (size_t)row * ldo;
  const float* p = pre + (size_t)row * ldp + (size_t)g * W;
  const size_t base = (size_t)row * ldd + (size_t)g * W;
  const size_t step = (size_t)B * ldd;
  const float r = rstd[row * gridDim.y + g];
  float dot = 0.f;
  for (int c = threadIdx.x; c < W; c += FIN_THREADS) {
    float dx = 0.f;
    for (int s = 0; s < ns; ++s) dx += dparts[s * step + base + c];
    const float n = p[c] * r;
    const float dn = dx * dsilu(n * scale[c]) * scale[c];
    dot += dn * n;
  }
  const float mean = block_sum(dot, red) / W;
  for (int c = threadIdx.x; c < W; c += FIN_THREADS) {
    float dx = 0.f;
    for (int s = 0; s < ns; ++s) dx += dparts[s * step + base + c];
    const float n = p[c] * r;
    const float dy = dx * dsilu(n * scale[c]);
    dsc[c] = dy * n;
    out[c] = r * (dy * scale[c] - n * mean);
  }
}

// out[row, c] = (add[row, c] + sum of ns partials parts[s][row, c]) *
// keep[row], for c < N; parts row stride ldp, add row stride N; add and
// keep optional. Writes f32 (outf) or bf16 (outb), row stride ldo.
__global__ void combine_kernel(const float* parts, int ns, int B, int ldp,
                               int N, const float* add, const float* keep,
                               float* outf, bf16* outb, int ldo) {
  const int row = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float v = add ? add[(size_t)row * N + c] : 0.f;
  for (int s = 0; s < ns; ++s) v += parts[((size_t)s * B + row) * ldp + c];
  if (keep) v *= keep[row];
  if (outf) outf[(size_t)row * ldo + c] = v;
  if (outb) outb[(size_t)row * ldo + c] = __float2bfloat16(v);
}

inline void combine(const float* parts, int ns, int B, int ldp, int N,
                    const float* add, const float* keep, float* outf,
                    bf16* outb, int ldo, cudaStream_t st) {
  combine_kernel<<<dim3((N + 255) / 256, B), 256, 0, st>>>(
      parts, ns, B, ldp, N, add, keep, outf, outb, ldo);
}

// The GRU update's backward for every (row, column j) of D: dout = the
// upstream gradient of the new deter (dup + carry + sum of ns partials
// from the posterior head), the gates recomputed from their saved
// pre-activations, and deter the masked previous deter. Writes the gate
// pre-activation gradients to dgates (row stride 3D, wg's column layout)
// and dout (1 - u), the direct path to the previous deter, to ddir.
__global__ void gate_bwd_kernel(const float* parts, int ns, int B, int D,
                                int g, const float* dup, const float* carry,
                                const float* gates, const bf16* deter,
                                float* dgates, float* ddir) {
  const int row = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  const int dg = D / g, blk = j / dg, i = j - blk * dg;
  const size_t at = (size_t)row * D + j;
  float dout = dup[at] + carry[at];
  for (int s = 0; s < ns; ++s) dout += parts[(size_t)s * B * D + at];
  const size_t gb = (size_t)row * 3 * D + (size_t)blk * 3 * dg + i;
  const float gr = gates[gb], gc = gates[gb + dg], gu = gates[gb + 2 * dg];
  const float r = sigmoid(gr);
  const float c = tanhf(r * gc);
  const float u = sigmoid(gu - 1.f);
  const float prev = to_f(deter[at]);
  const float du = dout * (c - prev) * u * (1.f - u);
  const float dt = dout * u * (1.f - c * c);
  dgates[gb] = dt * gc * r * (1.f - r);
  dgates[gb + dg] = dt * r;
  dgates[gb + 2 * dg] = du;
  ddir[at] = dout * (1.f - u);
}

// The straight-through sample's backward folded into the logit gradient,
// per (row, group) warp: with sm = softmax(logit) and dst = dstoch + carry,
// out = dlogit + (1 - unimix) sm (dst - sum(dst sm)).
__global__ void st_bwd_kernel(const float* logit, const float* dstoch,
                              const float* carry, const float* dlogit, int B,
                              int S, int C, float unimix, float* out) {
  const int lane = threadIdx.x % 32;
  const int wid = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (wid >= B * S) return;
  const size_t base = (size_t)wid * C;
  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, logit[base + c]);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += expf(logit[base + c] - m);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float dot = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float sm = expf(logit[base + c] - m) / sum;
    dot += (dstoch[base + c] + carry[base + c]) * sm;
  }
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  for (int c = lane; c < C; c += 32) {
    const float sm = expf(logit[base + c] - m) / sum;
    const float dst = dstoch[base + c] + carry[base + c];
    out[base + c] = dlogit[base + c] + (1.f - unimix) * sm * (dst - dot);
  }
}

// Weight gradient over all R rows at once:
//   out[q][m, n] = sum over r < R of X[r, q xgs + m] * bf16(Y[r, q ygs + n])
// (X bf16 row stride ldx, Y f32 row stride ldy), written in bf16 with row
// stride ldo and group stride ogs. Grid (N / TN, M / TM, groups): one
// 16 x 16 tile per block walks all R rows in 128-row chunks, so no partial
// sums cross blocks and the order of the sum is fixed.
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const bf16* X, int ldx, int xgs, const float* Y, int ldy,
             int ygs, int R, bf16* out, int ldo, size_t ogs) {
  __shared__ float xs[KC * TM];
  __shared__ float ys[KC * TN];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN, q = blockIdx.z;
  X += (size_t)q * xgs + m0;
  Y += (size_t)q * ygs + n0;
  const int t = threadIdx.x, m = t / TN, n = t % TN;
  float acc = 0.f;
  for (int r0 = 0; r0 < R; r0 += KC) {
    for (int i = t; i < KC * TM; i += THREADS) {
      const int rr = i / TM, c = i % TM, r = r0 + rr;
      xs[i] = r < R ? to_f(X[(size_t)r * ldx + c]) : 0.f;
      ys[i] = r < R ? round_bf16(Y[(size_t)r * ldy + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < KC; ++rr) acc += xs[rr * TM + m] * ys[rr * TN + n];
    __syncthreads();
  }
  out[(size_t)q * ogs + (size_t)(m0 + m) * ldo + n0 + n] =
      __float2bfloat16(acc);
}

inline void wgrad(const bf16* X, int ldx, int xgs, const float* Y, int ldy,
                  int ygs, int R, int M, int N, int groups, bf16* out,
                  int ldo, size_t ogs, cudaStream_t st) {
  wgrad_kernel<<<dim3(N / TN, M / TM, groups), THREADS, 0, st>>>(
      X, ldx, xgs, Y, ldy, ygs, R, out, ldo, ogs);
}

// Column sums of Y (R rows, row stride ldy, N columns) in row order: the
// bias and norm-scale gradients. Writes bf16 (outb) or f32 (outf).
__global__ void colsum_kernel(const float* Y, int R, int ldy, int N,
                              bf16* outb, float* outf) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float v = 0.f;
  for (int r = 0; r < R; ++r) v += Y[(size_t)r * ldy + c];
  if (outb) outb[c] = __float2bfloat16(v);
  if (outf) outf[c] = v;
}

inline void colsum(const float* Y, int R, int ldy, int N, bf16* outb,
                   float* outf, cudaStream_t st) {
  colsum_kernel<<<(N + 255) / 256, 256, 0, st>>>(Y, R, ldy, N, outb, outf);
}

}  // namespace seq
