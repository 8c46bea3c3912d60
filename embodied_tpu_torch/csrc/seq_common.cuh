// What the whole-window kernels observe_seq.cu (the observe window,
// forward and backward) and imagine_seq.cu (the imagination rollout) add
// to the core-step and posterior-head stages of blockgru_common.cuh, and
// the steps they share with the per-step kernels: the observe step's
// backward (step_bwd, weight_grads), which blockgru.cu and observe.cu run
// once at T = 1, and the rollout step after the action embedding
// (imag_step), which imagine.cu runs once.
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

// One operand of a transposed product (X W^T, X the f32 gradient dY):
// blockgru_common.cuh's Opnd, read with trans = true. Output column n lies
// in group q = n / gN at offset j = n % gN; the segment adds
//   sum over k < len of bf16(y[row * ldy + q * ygs + k]) * w[q * wgs + j * ldw + k].
// A dense W^T has ygs = 0 and one group; a block-diagonal one steps both
// per block.
typedef Opnd TSeg;

// parts[z][row, n] (row stride N): split z of the transposed products of
// segments a and b (b.len may be 0) on the 16-row tensor-core stage.
// Returns the split count.
inline int mmt(TSeg a, TSeg b, int gN, float* parts, int B, int N, int sms,
               cudaStream_t st) {
  const int ns = tc_splits(N, gN, B, a.len + b.len, sms);
  tc16<true>(a, b, gN, (const bf16*)nullptr, parts, N, B, N, ns, st);
  return ns;
}

inline TSeg no_seg() { return no_opnd(); }

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

// Weight gradient over all R rows at once, on the tensor cores:
//   out[q][m, n] = sum over r < R of X[r, q xgs + m] * bf16(Y[r, q ygs + n])
// (X bf16 row stride ldx, Y f32 row stride ldy, rounded to bf16 as it is
// staged), written in bf16 with row stride ldo and group stride ogs. A
// block owns one WG_BM x WG_BN output tile (four warps of 32 x 32) and
// walks all R rows in WG_BR-row chunks, double-buffered (X by cp.async),
// so no partial sums cross blocks and the order of the sum is fixed. X^T
// reaches the A fragments through ldmatrix.trans, Y the B fragments too.
// M and N are multiples of 16, ldx, xgs, ldy and ygs of 8.
constexpr int WG_BM = 64, WG_BN = 64, WG_BR = 32, WG_THREADS = 128;

struct WgStage {
  bf16 x[WG_BR][WG_BM + 8];  // [r][m], padded as TcStage's rows
  bf16 y[WG_BR][WG_BN + 8];  // [r][n]
};

__device__ __forceinline__ void wg_stage(WgStage& s, const bf16* X, int ldx,
                                         const float* Y, int ldy, int r0,
                                         int R, int M, int N, int m0,
                                         int n0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < WG_BR * WG_BM / 8 / WG_THREADS; ++j) {
    const int i = t + j * WG_THREADS;
    const int r = i / (WG_BM / 8), c = (i % (WG_BM / 8)) * 8;
    const bool ok = r0 + r < R && m0 + c < M;
    cp_async16(&s.x[r][c], ok ? X + (size_t)(r0 + r) * ldx + m0 + c : X,
               ok ? 16 : 0);
  }
#pragma unroll
  for (int j = 0; j < WG_BR * WG_BN / 8 / WG_THREADS; ++j) {
    const int i = t + j * WG_THREADS;
    const int r = i / (WG_BN / 8), c = (i % (WG_BN / 8)) * 8;
    store8_bf16(&s.y[r][c], Y + (size_t)(r0 + r) * ldy + n0 + c,
                r0 + r < R && n0 + c < N);
  }
}

// Grid (ceil(N / WG_BN), ceil(M / WG_BM), groups).
__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const bf16* X, int ldx, int xgs, const float* Y, int ldy,
             int ygs, int R, int M, int N, bf16* out, int ldo, size_t ogs) {
  __shared__ __align__(128) WgStage s[2];
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN, q = blockIdx.z;
  X += (size_t)q * xgs;
  Y += (size_t)q * ygs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 32;
  const int mi = lane / 8, l8 = lane % 8;
  float acc[2][4][4] = {};
  const int chunks = (R + WG_BR - 1) / WG_BR;
  wg_stage(s[0], X, ldx, Y, ldy, 0, R, M, N, m0, n0);
  cp_commit();
  for (int i = 0; i < chunks; ++i) {
    if (i + 1 < chunks)
      wg_stage(s[(i + 1) % 2], X, ldx, Y, ldy, (i + 1) * WG_BR, R, M, N, m0,
               n0);
    cp_commit();
    cp_wait<1>();  // chunk i has landed
    __syncthreads();
    const WgStage& c = s[i % 2];
#pragma unroll
    for (int kk = 0; kk < WG_BR; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        ldsm4<true>(a[t], &c.x[kk + (mi >> 1) * 8 + l8][wm + t * 16 +
                                                        (mi & 1) * 8]);
        ldsm4<true>(b[t], &c.y[kk + (mi & 1) * 8 + l8][wn + t * 16 +
                                                       (mi >> 1) * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                   b[nt / 2][(nt % 2) * 2], b[nt / 2][(nt % 2) * 2 + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with chunk i before its refill
  }
  const int g = lane / 4, tq = lane % 4;
  out += (size_t)q * ogs;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + h * 8;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + nt * 8 + tq * 2 + e;
          if (n < N)
            out[(size_t)m * ldo + n] = __float2bfloat16(acc[mt][nt][h * 2 + e]);
        }
      }
    }
  }
}

inline void wgrad(const bf16* X, int ldx, int xgs, const float* Y, int ldy,
                  int ygs, int R, int M, int N, int groups, bf16* out,
                  int ldo, size_t ogs, cudaStream_t st) {
  const dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM, groups);
  wgrad_kernel<<<grid, WG_THREADS, 0, st>>>(X, ldx, xgs, Y, ldy, ygs, R, M,
                                            N, out, ldo, ogs);
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

// --- One observe step, its backward and the weight gradients ----------------
//
// The observe window (observe_seq.cu) runs these T times; the per-step
// kernels (blockgru.cu, observe.cu) once, at T = 1.

template <class W>
struct ObsWeightsT {
  CoreT<W> core;
  HeadT<W> head;
};
typedef ObsWeightsT<bf16> ObsWeights;

// The core's 12 weights, then (with `head`) the posterior head's 5.
inline ObsWeights obs_weights(const void* const* p, bool head) {
  return ObsWeights{core_weights(p), head ? head_weights(p + 12) : Head{}};
}

// T steps of B rows; the state entering a step is deter (D) and stoch (S),
// the action embedding A wide, the tokens K wide, the logits L wide (groups
// of C classes). Without `head` the step is the core alone (K unused). In
// the window, S = L: the stoch entering a step is the previous sample.
struct Dims {
  int T, B, D, H, S, L, A, K, g, C, sms;
  bool head;
};

// One observe step: mask the state and action by keep (copies where keep
// is null) into dm, sm and the last A columns of x (B, 2H + A), run the
// core into h and the new deter `out` and, with d.head, the posterior head
// into xo and the f32 logits (skipped where `logit` is null). With `save`,
// `preo` and `rstdo`, also keeps what the backward needs.
template <class W>
inline void obs_step(const ObsWeightsT<W>& w, const Dims& d,
                     const bf16* deter, const bf16* stoch, const bf16* act,
                     const bf16* tok, const float* keep, bf16* dm, bf16* sm,
                     bf16* x, bf16* h, bf16* out, bf16* xo, float* logit,
                     float* parts, const CoreSave& save, float* preo,
                     float* rstdo, float eps, cudaStream_t st) {
  const int B = d.B, D = d.D, H = d.H, S = d.S, A = d.A;
  const int lx = 2 * H + A;
  mask(deter, D, D, keep, dm, D, B, st);
  mask(stoch, S, S, keep, sm, S, B, st);
  mask(act, A, A, keep, x + 2 * H, lx, B, st);
  core_stages(w.core, dm, sm, x, h, out, parts, save, B, D, H, S, A, d.g,
              d.sms, eps, st);
  if (d.head)
    post_head(w.head, out, tok, xo, logit, parts, preo, rstdo, B, D, H, d.K,
              d.L, d.sms, eps, st);
}

// --- The observe window's forward -------------------------------------------
//
// observe_seq.cu runs it on bf16 weights, qcore.cu on int8 weights with
// column scales: one copy of the window's step.

struct FwdScratch {
  bf16 *dm, *sm, *x, *h, *xo;
  float* parts;
};

inline FwdScratch carve_fwd(Arena& a, const Dims& d) {
  FwdScratch s;
  s.dm = a.take<bf16>((size_t)d.B * d.D);
  s.sm = a.take<bf16>((size_t)d.B * d.L);
  s.x = a.take<bf16>((size_t)d.B * (2 * d.H + d.A));
  s.h = a.take<bf16>((size_t)d.B * d.D);
  s.xo = a.take<bf16>((size_t)d.B * d.H);
  const size_t core = core_parts(d.B, d.D, d.H, d.L, d.A, d.g, d.sms);
  const size_t head = head_parts(d.B, d.D, d.H, d.K, d.sms);
  s.parts = a.take<float>(core > head ? core : head);
  return s;
}

// The window's dimensions: the stoch entering a step is the previous
// step's sample, L wide.
inline Dims window(int T, int B, int D, int H, int L, int A, int K, int g,
                   int C, int sms) {
  return Dims{T, B, D, H, L, L, A, K, g, C, sms, true};
}

// The bytes of workspace window_fwd carves.
inline size_t window_fwd_workspace(const Dims& d) {
  Arena a{nullptr, 0};
  carve_fwd(a, d);
  return a.used + 256;
}

// The window's forward: for each step, the masked observe step from the
// previous step's outputs (deter0, stoch0 at t = 0), then the sample.
// Inputs time-major: act (T, B, A), tok (T, B, K), keep (T, B) f32, gum
// (T, B, L) f32. Outputs deter_seq (T, B, D), stoch_seq (T, B, L)
// one-hots, logit_seq (T, B, L) f32.
template <class W>
inline int window_fwd(const ObsWeightsT<W>& w, const Dims& d,
                      const void* deter0, const void* stoch0, const void* act,
                      const void* tok, const void* keep, const void* gum,
                      void* deter_seq, void* stoch_seq, void* logit_seq,
                      void* workspace, float eps, float unimix,
                      cudaStream_t st) {
  const int B = d.B, D = d.D, L = d.L, A = d.A, K = d.K, C = d.C;
  Arena a{(char*)workspace, 0};
  const FwdScratch s = carve_fwd(a, d);
  bf16* dseq = (bf16*)deter_seq;
  bf16* sseq = (bf16*)stoch_seq;
  float* lseq = (float*)logit_seq;
  for (int t = 0; t < d.T; ++t) {
    const size_t o = (size_t)t * B, p = o - B;
    const bf16* deter = t ? dseq + p * D : (const bf16*)deter0;
    const bf16* stoch = t ? sseq + p * L : (const bf16*)stoch0;
    obs_step(w, d, deter, stoch, (const bf16*)act + o * A,
             (const bf16*)tok + o * K, (const float*)keep + o, s.dm, s.sm,
             s.x, s.h, dseq + o * D, s.xo, lseq + o * L, s.parts,
             CoreSave{}, nullptr, nullptr, eps, st);
    sample(lseq + o * L, (const float*)gum + o * L, B, L / C, C, unimix,
           sseq + o * L, st);
  }
  return (int)cudaGetLastError();
}

// --- The observe step's backward ---------------------------------------------

struct BwdScratch {
  // (T B, .) rows of the recompute: the products' X operands.
  bf16 *deterX, *stochX, *xX, *hX, *newX, *xoX;
  // (T B, .) f32 gradients of the pre-activations: the products' dY.
  float *dP0, *dP1, *dHp, *dG, *dPo, *dLg;
  // (T B, .) f32 per-row terms of the norm scales' gradients.
  float *dS0, *dS1, *dSh, *dSo;
  // Per-step buffers; cd and cs carry the gradients of the state entering
  // a step to the step before it.
  float *pre01, *rstd01, *hpre, *rstdh, *gates, *preo, *rstdo, *logit;
  float *ddir, *cd, *cs, *parts;
};

inline BwdScratch carve_bwd(Arena& a, const Dims& d) {
  const size_t R = (size_t)d.T * d.B, B = d.B;
  const size_t RH = d.head ? R : 0, BH = d.head ? B : 0;
  const int D = d.D, H = d.H, S = d.S, L = d.L, lx = 2 * d.H + d.A;
  BwdScratch s;
  s.deterX = a.take<bf16>(R * D);
  s.stochX = a.take<bf16>(R * S);
  s.xX = a.take<bf16>(R * lx);
  s.hX = a.take<bf16>(R * D);
  s.newX = a.take<bf16>(R * D);
  s.xoX = a.take<bf16>(RH * H);
  s.dP0 = a.take<float>(R * H);
  s.dP1 = a.take<float>(R * H);
  s.dHp = a.take<float>(R * D);
  s.dG = a.take<float>(R * 3 * D);
  s.dPo = a.take<float>(RH * H);
  s.dLg = a.take<float>(RH * L);
  s.dS0 = a.take<float>(R * H);
  s.dS1 = a.take<float>(R * H);
  s.dSh = a.take<float>(R * D);
  s.dSo = a.take<float>(RH * H);
  s.pre01 = a.take<float>(B * 2 * H);
  s.rstd01 = a.take<float>(B * 2);
  s.hpre = a.take<float>(B * D);
  s.rstdh = a.take<float>(B);
  s.gates = a.take<float>(B * 3 * D);
  s.preo = a.take<float>(BH * H);
  s.rstdo = a.take<float>(BH);
  s.logit = a.take<float>(BH * L);
  s.ddir = a.take<float>(B * D);
  s.cd = a.take<float>(B * D);
  s.cs = a.take<float>(B * S);
  // The split partials of the largest stage (the mmt splits of step_bwd).
  const int dg = D / d.g, sms = d.sms, Bi = d.B;
  size_t most = core_parts(Bi, D, H, S, d.A, d.g, sms);
  const size_t core[] = {
      (size_t)most_splits(D, Bi, 3 * dg, sms) * B * D,
      (size_t)most_splits(lx, Bi, D, sms) * B * lx,
      (size_t)most_splits(D, Bi, dg + H, sms) * B * D,
      (size_t)most_splits(S, Bi, H, sms) * B * S};
  for (size_t v : core) most = v > most ? v : most;
  if (d.head) {
    const size_t head[] = {
        head_parts(Bi, D, H, d.K, sms),
        (size_t)most_splits(H, Bi, L, sms) * B * H,
        (size_t)most_splits(d.K, Bi, H, sms) * B * d.K,
        (size_t)most_splits(D, Bi, H, sms) * B * D};
    for (size_t v : head) most = v > most ? v : most;
  }
  s.parts = a.take<float>(most);
  return s;
}

// The backward of one observe step, at rows o (= t B) of the (T B, .)
// arrays: deter, stoch, act and tok are the step's inputs (the state
// entering it unmasked), keep (null: no mask) masks them as the forward
// did, and ddet, dsto, dlog are the f32 upstream gradients of its outputs.
// It recomputes the step's forward, keeping the products' operands at rows
// o of the scratch, then runs the gradients back: the straight-through
// sample's into the logits' (where dsto is given; else s.dLg already holds
// the logits' gradient, the per-step kernel's input), the posterior
// head's (with d.head), the GRU gates' from ddet and the carry s.cd, the
// hidden layer's and the input projections'. Writes dact (and dtok, with
// the head) in bf16 at rows o, and replaces s.cd and s.cs with the f32
// gradients of the state entering the step, masked by keep.
inline void step_bwd(const ObsWeights& w, const Dims& d, const BwdScratch& s,
                     size_t o, const bf16* deter, const bf16* stoch,
                     const bf16* act, const bf16* tok, const float* keep,
                     const float* ddet, const float* dsto, const float* dlog,
                     bf16* dact, bf16* dtok, float eps, float unimix,
                     cudaStream_t st) {
  const int B = d.B, D = d.D, H = d.H, S = d.S, L = d.L, A = d.A, K = d.K;
  const int g = d.g, sms = d.sms, lx = 2 * H + A, dg = D / g;
  const float* kp = keep ? keep + o : nullptr;
  const CoreSave save{s.pre01, s.rstd01, s.hpre, s.rstdh, s.gates};
  const TSeg none = no_seg();
  // Recompute the step's forward, keeping the products' operands.
  obs_step(w, d, deter + o * D, stoch + o * S, act + o * A,
           d.head ? tok + o * K : nullptr, kp, s.deterX + o * D,
           s.stochX + o * S, s.xX + o * lx, s.hX + o * D, s.newX + o * D,
           s.xoX + o * H, dsto ? s.logit : nullptr, s.parts, save, s.preo,
           s.rstdo, eps, st);
  int ns = 0;  // split partials of the head's gradient into the new deter
  if (d.head) {
    // The straight-through sample: its gradient joins the logits'.
    if (dsto) {
      const int groups = L / d.C;
      st_bwd_kernel<<<(B * groups + 7) / 8, 256, 0, st>>>(
          s.logit, dsto + o * L, s.cs, dlog + o * L, B, groups, d.C, unimix,
          s.dLg + o * L);
    }
    // Posterior head.
    const Head& wh = w.head;
    ns = mmt(TSeg{s.dLg + o * L, L, 0, wh.wl, L, 0, L}, none, H, s.parts, B,
             H, sms, st);
    rms_bwd_kernel<<<dim3(B, 1), FIN_THREADS, 0, st>>>(
        s.parts, ns, B, H, H, s.preo, H, s.rstdo, wh.so, wh.so,
        s.dPo + o * H, s.dPo + o * H, H, s.dSo + o * H, s.dSo + o * H);
    ns = mmt(TSeg{s.dPo + o * H, H, 0, wh.wo + (size_t)D * H, H, 0, H}, none,
             K, s.parts, B, K, sms, st);
    combine(s.parts, ns, B, K, K, nullptr, nullptr, nullptr, dtok + o * K, K,
            st);
    ns = mmt(TSeg{s.dPo + o * H, H, 0, wh.wo, H, 0, H}, none, D, s.parts, B,
             D, sms, st);
  }
  // GRU gates.
  gate_bwd_kernel<<<dim3((D + 255) / 256, B), 256, 0, st>>>(
      s.parts, ns, B, D, g, ddet + o * D, s.cd, s.gates, s.deterX + o * D,
      s.dG + o * 3 * D, s.ddir);
  // Hidden layer.
  ns = mmt(TSeg{s.dG + o * 3 * D, 3 * D, 3 * dg, w.core.wg, 3 * dg,
                (size_t)dg * 3 * dg, 3 * dg},
           none, dg, s.parts, B, D, sms, st);
  rms_bwd_kernel<<<dim3(B, 1), FIN_THREADS, 0, st>>>(
      s.parts, ns, B, D, D, s.hpre, D, s.rstdh, w.core.sh, w.core.sh,
      s.dHp + o * D, s.dHp + o * D, D, s.dSh + o * D, s.dSh + o * D);
  ns = mmt(TSeg{s.dHp + o * D, D, 0, w.core.win, D, 0, D}, none, lx, s.parts,
           B, lx, sms, st);
  // Input projections, and the action embedding's gradient.
  rms_bwd_kernel<<<dim3(B, 2), FIN_THREADS, 0, st>>>(
      s.parts, ns, B, lx, H, s.pre01, 2 * H, s.rstd01, w.core.s0, w.core.s1,
      s.dP0 + o * H, s.dP1 + o * H, H, s.dS0 + o * H, s.dS1 + o * H);
  combine(s.parts + 2 * H, ns, B, lx, A, nullptr, kp, nullptr, dact + o * A,
          A, st);
  // The state entering the step: deter through the gates' direct path,
  // the block-diagonal hidden weights and the input projection.
  ns = mmt(TSeg{s.dHp + o * D, D, dg, w.core.wblk, dg, (size_t)dg * dg, dg},
           TSeg{s.dP0 + o * H, H, 0, w.core.w0, H, (size_t)dg * H, H}, dg,
           s.parts, B, D, sms, st);
  combine(s.parts, ns, B, D, D, s.ddir, kp, s.cd, nullptr, D, st);
  ns = mmt(TSeg{s.dP1 + o * H, H, 0, w.core.w1, H, 0, H}, none, S, s.parts, B,
           S, sms, st);
  combine(s.parts, ns, B, S, S, nullptr, kp, s.cs, nullptr, S, st);
}

// The gradients of the state entering the first step, s.cd and s.cs, in
// bf16.
inline void state_grads(const Dims& d, const BwdScratch& s, bf16* ddeter,
                        bf16* dstoch, cudaStream_t st) {
  combine(s.cd, 1, d.B, d.D, d.D, nullptr, nullptr, nullptr, ddeter, d.D,
          st);
  combine(s.cs, 1, d.B, d.S, d.S, nullptr, nullptr, nullptr, dstoch, d.S,
          st);
}

// The weight gradients over all T B rows of the scratch, into `grads` in
// FIELDS order (bf16; f32 for the norm scales): the core's 12, then with
// d.head the posterior head's 5 (tok (T B, K) is their X operand). One
// wgrad per weight contracts all rows at once (no atomics: the order of
// the sum is fixed), one colsum per bias or norm scale.
inline void weight_grads(const Dims& d, const BwdScratch& s, const bf16* tok,
                         void* const* grads, cudaStream_t st) {
  const int R = d.T * d.B, D = d.D, H = d.H, S = d.S, L = d.L, K = d.K;
  const int g = d.g, dg = D / g, lx = 2 * H + d.A;
  auto gb = [&](int i) { return (bf16*)grads[i]; };
  auto gf = [&](int i) { return (float*)grads[i]; };
  wgrad(s.deterX, D, 0, s.dP0, H, 0, R, D, H, 1, gb(0), H, 0, st);
  colsum(s.dP0, R, H, H, gb(1), nullptr, st);
  colsum(s.dS0, R, H, H, nullptr, gf(2), st);
  wgrad(s.stochX, S, 0, s.dP1, H, 0, R, S, H, 1, gb(3), H, 0, st);
  colsum(s.dP1, R, H, H, gb(4), nullptr, st);
  colsum(s.dS1, R, H, H, nullptr, gf(5), st);
  wgrad(s.deterX, D, dg, s.dHp, D, dg, R, dg, dg, g, gb(6), dg,
        (size_t)dg * dg, st);
  colsum(s.dHp, R, D, D, gb(7), nullptr, st);
  wgrad(s.xX, lx, 0, s.dHp, D, 0, R, lx, D, 1, gb(8), D, 0, st);
  colsum(s.dSh, R, D, D, nullptr, gf(9), st);
  wgrad(s.hX, D, dg, s.dG, 3 * D, 3 * dg, R, dg, 3 * dg, g, gb(10), 3 * dg,
        (size_t)dg * 3 * dg, st);
  colsum(s.dG, R, 3 * D, 3 * D, gb(11), nullptr, st);
  if (!d.head) return;
  wgrad(s.newX, D, 0, s.dPo, H, 0, R, D, H, 1, gb(12), H, 0, st);
  wgrad(tok, K, 0, s.dPo, H, 0, R, K, H, 1, gb(12) + (size_t)D * H, H, 0, st);
  colsum(s.dPo, R, H, H, gb(13), nullptr, st);
  colsum(s.dSo, R, H, H, nullptr, gf(14), st);
  wgrad(s.xoX, H, 0, s.dLg, L, 0, R, H, L, 1, gb(15), L, 0, st);
  colsum(s.dLg, R, L, L, gb(16), nullptr, st);
}

// --- One imagination step after the action embedding ------------------------
//
// The per-step kernel (imagine.cu) runs it once; the whole-horizon rollout
// (imagine_seq.cu) once per step, after its policy and action embedding.

// The prior's weights in ops/imagine.py FIELDS order (after the core's 12).
struct Prior {
  const bf16 *w0, *b0;
  const float* s0;
  const bf16 *w1, *b1;
  const float* s1;
  const bf16 *wl, *bl;
};

inline Prior prior_weights(const void* const* p) {
  auto b = [&](int i) { return (const bf16*)p[i]; };
  auto f = [&](int i) { return (const float*)p[i]; };
  return Prior{b(0), b(1), f(2), b(3), b(4), f(5), b(6), b(7)};
}

// Floats of split partials imag_step needs at most.
inline size_t imag_parts(int B, int D, int H, int L, int A, int g, int sms) {
  size_t most = core_parts(B, D, H, L, A, g, sms);
  const size_t prior[] = {(size_t)most_splits(H, B, D, sms) * B * H,
                          (size_t)most_splits(H, B, H, sms) * B * H};
  for (size_t v : prior) most = v > most ? v : most;
  return most;
}

// The core on (deter, stoch), with the action embedding in the last A
// columns of x (B, 2H + A), writing the new deter to `out`; the two-layer
// prior and its f32 logits (B, L); and the unimix Gumbel-max sample of
// each group of C classes with the noise gum (B, L), written as one-hots.
// h (B, D), px and py (B, H) and parts (imag_parts floats) are scratch.
inline void imag_step(const Core& core, const Prior& p, const bf16* deter,
                      const bf16* stoch, bf16* x, bf16* h, bf16* px,
                      bf16* py, float* parts, bf16* out, float* logit,
                      const float* gum, bf16* onehot, int B, int D, int H,
                      int L, int A, int g, int C, int sms, float eps,
                      float unimix, cudaStream_t st) {
  const XSeg none{nullptr, 0, 0};
  core_stages(core, deter, stoch, x, h, out, parts, CoreSave{}, B, D, H, L,
              A, g, sms, eps, st);
  int ns = mm_splits<bf16>(B, H, D, sms);
  mm(XSeg{out, D, D}, none, p.w0, p.b0, parts, B, H, ns, st);
  finish(parts, ns, B, H, H, 1, p.s0, p.s0, eps, px, H, nullptr, nullptr, st);
  ns = mm_splits<bf16>(B, H, H, sms);
  mm(XSeg{px, H, H}, none, p.w1, p.b1, parts, B, H, ns, st);
  finish(parts, ns, B, H, H, 1, p.s1, p.s1, eps, py, H, nullptr, nullptr, st);
  mm(XSeg{py, H, H}, none, p.wl, p.bl, logit, B, L, 1, st);
  sample(logit, gum, B, L / C, C, unimix, onehot, st);
}

}  // namespace seq
