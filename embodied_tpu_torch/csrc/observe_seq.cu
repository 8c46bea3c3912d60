// The whole observe window on Hopper, forward and backward: the port of the
// Pallas TPU kernels embodied_tpu/ops/observe_seq.py:fused_observe_seq
// (_seq_kernel) and fused_observe_seq_bwd (_seq_bwd_kernel).
//
// Forward, per step t (T steps in one C call; the stages of
// blockgru_common.cuh and the sample of seq_common.cuh):
//   mask     deter, stoch and act of the step times keep[t]
//   core     the block-GRU core, new deter written to deter_seq[t]
//   post     silu(rms([new, tok[t]] @ wo + bo) * so)
//   logits   xo @ wl + bl, f32, written to logit_seq[t]
//   sample   unimix Gumbel-max one-hot per group, written to stoch_seq[t]
// Step t + 1 reads its state from deter_seq[t] and stoch_seq[t].
//
// Backward, for t = T - 1 down to 0: the forward of step t is recomputed
// from the stored previous states, saving the activations the gradients
// need into (T, B, .) scratch; then the straight-through term joins the
// logit gradient and the input gradients run back through the posterior
// head, the GRU gates, the hidden layer and the input projections, each a
// transposed product (X W^T) or a row kernel. The gradients of the state
// entering step t are carried to step t - 1. After the loop, one weight
// gradient kernel per weight contracts all T * B rows at once (dW = X^T dY)
// and one column-sum kernel per bias or norm scale adds its rows: the
// GPU's answer to the TPU kernel's VMEM accumulators, with a deep
// contraction instead of T thin ones and no atomics.
//
// Bound on an H100 at T = 64, B = 16 (size12m): each step reads the 11 MB
// of bf16 weights and does 2 B flops per weight, so one step is bound by
// bytes, but the 50 MB L2 keeps the weights after the first step, and the
// whole window's flops over the peak rate bind it (ops/observe_seq.work).
// What bounds it in practice is the chain of 64 dependent steps of small
// launches (about 13 forward, 27 backward per step): latency, not bytes or
// flops. A persistent kernel with grid-wide barriers, tensor cores and a
// CUDA graph are later work.

#include "seq_common.cuh"

namespace seq {

struct ObsWeights {
  Core core;
  Head head;
};

inline ObsWeights obs_weights(const void* const* p) {
  return ObsWeights{core_weights(p), head_weights(p + 12)};
}

struct Dims {
  int T, B, D, H, L, A, K, g, C, sms;
};

// One observe step: mask the state and action by keep, run the core and
// the posterior head. Writes x (B, 2H + A), h, the new deter `out`, xo and
// f32 logits; with `save`, also what the backward needs.
inline void obs_step(const ObsWeights& w, const Dims& d, const bf16* deter,
                     const bf16* stoch, const bf16* act, const bf16* tok,
                     const float* keep, bf16* dm, bf16* sm, bf16* x, bf16* h,
                     bf16* out, bf16* xo, float* logit, float* parts,
                     const CoreSave& save, float* preo, float* rstdo,
                     float eps, cudaStream_t st) {
  const int B = d.B, D = d.D, H = d.H, L = d.L, A = d.A;
  const int lx = 2 * H + A;
  mask(deter, D, D, keep, dm, D, B, st);
  mask(stoch, L, L, keep, sm, L, B, st);
  mask(act, A, A, keep, x + 2 * H, lx, B, st);
  core_stages(w.core, dm, sm, x, h, out, parts, save, B, D, H, L, A, d.g,
              d.sms, eps, st);
  post_head(w.head, out, tok, xo, logit, parts, preo, rstdo, B, D, H, d.K, L,
            d.sms, eps, st);
}

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

struct BwdScratch {
  // (T B, .) rows of the recompute: the products' X operands.
  bf16 *deterX, *stochX, *xX, *hX, *newX, *xoX;
  // (T B, .) f32 gradients of the pre-activations: the products' dY.
  float *dP0, *dP1, *dHp, *dG, *dPo, *dLg;
  // (T B, .) f32 per-row terms of the norm scales' gradients.
  float *dS0, *dS1, *dSh, *dSo;
  // Per-step buffers.
  float *pre01, *rstd01, *hpre, *rstdh, *gates, *preo, *rstdo, *logit;
  float *ddir, *cd, *cs, *parts;
};

inline BwdScratch carve_bwd(Arena& a, const Dims& d) {
  const size_t R = (size_t)d.T * d.B, B = d.B;
  const int D = d.D, H = d.H, L = d.L, lx = 2 * d.H + d.A;
  BwdScratch s;
  s.deterX = a.take<bf16>(R * D);
  s.stochX = a.take<bf16>(R * L);
  s.xX = a.take<bf16>(R * lx);
  s.hX = a.take<bf16>(R * D);
  s.newX = a.take<bf16>(R * D);
  s.xoX = a.take<bf16>(R * H);
  s.dP0 = a.take<float>(R * H);
  s.dP1 = a.take<float>(R * H);
  s.dHp = a.take<float>(R * D);
  s.dG = a.take<float>(R * 3 * D);
  s.dPo = a.take<float>(R * H);
  s.dLg = a.take<float>(R * L);
  s.dS0 = a.take<float>(R * H);
  s.dS1 = a.take<float>(R * H);
  s.dSh = a.take<float>(R * D);
  s.dSo = a.take<float>(R * H);
  s.pre01 = a.take<float>(B * 2 * H);
  s.rstd01 = a.take<float>(B * 2);
  s.hpre = a.take<float>(B * D);
  s.rstdh = a.take<float>(B);
  s.gates = a.take<float>(B * 3 * D);
  s.preo = a.take<float>(B * H);
  s.rstdo = a.take<float>(B);
  s.logit = a.take<float>(B * L);
  s.ddir = a.take<float>(B * D);
  s.cd = a.take<float>(B * D);
  s.cs = a.take<float>(B * L);
  const int dg = D / d.g, sms = d.sms, Bi = d.B;
  size_t most = core_parts(Bi, D, H, L, d.A, d.g, sms);
  const size_t stages[] = {
      head_parts(Bi, D, H, d.K, sms),
      (size_t)splits(H, Bi, L, sms) * B * H,
      (size_t)splits(d.K, Bi, H, sms) * B * d.K,
      (size_t)splits(D, Bi, H, sms) * B * D,
      (size_t)splits(D, Bi, 3 * dg, sms) * B * D,
      (size_t)splits(lx, Bi, D, sms) * B * lx,
      (size_t)splits(D, Bi, dg + H, sms) * B * D,
      (size_t)splits(L, Bi, H, sms) * B * L};
  for (size_t v : stages) most = v > most ? v : most;
  s.parts = a.take<float>(most);
  return s;
}

}  // namespace seq

using seq::bf16;

extern "C" size_t observe_seq_fwd_workspace(int T, int B, int D, int H,
                                            int L, int A, int K, int g,
                                            int C, int sms) {
  seq::Arena a{nullptr, 0};
  seq::carve_fwd(a, seq::Dims{T, B, D, H, L, A, K, g, C, sms});
  return a.used + 256;
}

extern "C" size_t observe_seq_bwd_workspace(int T, int B, int D, int H,
                                            int L, int A, int K, int g,
                                            int C, int sms) {
  seq::Arena a{nullptr, 0};
  seq::carve_bwd(a, seq::Dims{T, B, D, H, L, A, K, g, C, sms});
  return a.used + 256;
}

// Inputs time-major: act (T, B, A), tok (T, B, K), keep (T, B) f32, gum
// (T, B, L) f32; params the 17 weights of ops/observe.FIELDS. Outputs
// deter_seq (T, B, D), stoch_seq (T, B, L) one-hots, logit_seq (T, B, L)
// f32.
extern "C" int observe_seq_fwd(
    const void* deter0, const void* stoch0, const void* act, const void* tok,
    const void* keep, const void* gum, const void* const* params,
    void* deter_seq, void* stoch_seq, void* logit_seq, void* workspace,
    int T, int B, int D, int H, int L, int A, int K, int g, int C, int sms,
    float eps, float unimix, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const seq::Dims d{T, B, D, H, L, A, K, g, C, sms};
  seq::Arena a{(char*)workspace, 0};
  const seq::FwdScratch s = seq::carve_fwd(a, d);
  const seq::ObsWeights w = seq::obs_weights(params);
  bf16* dseq = (bf16*)deter_seq;
  bf16* sseq = (bf16*)stoch_seq;
  float* lseq = (float*)logit_seq;
  for (int t = 0; t < T; ++t) {
    const size_t o = (size_t)t * B, p = o - B;
    const bf16* deter = t ? dseq + p * D : (const bf16*)deter0;
    const bf16* stoch = t ? sseq + p * L : (const bf16*)stoch0;
    seq::obs_step(w, d, deter, stoch, (const bf16*)act + o * A,
                  (const bf16*)tok + o * K, (const float*)keep + o, s.dm,
                  s.sm, s.x, s.h, dseq + o * D, s.xo, lseq + o * L, s.parts,
                  seq::CoreSave{}, nullptr, nullptr, eps, st);
    seq::sample(lseq + o * L, (const float*)gum + o * L, B, L / C, C, unimix,
                sseq + o * L, st);
  }
  return (int)cudaGetLastError();
}

// Inputs: the states entering each step, deter_prev (T, B, D) and
// stoch_prev (T, B, L); act, tok, keep as the forward; the f32 upstream
// gradients ddet (T, B, D), dsto (T, B, L), dlog (T, B, L). Outputs the
// gradients of deter0 and stoch0 (bf16), of act and tok (T, B, .) bf16,
// and `grads`, the 17 weight gradients (bf16; f32 for the norm scales).
extern "C" int observe_seq_bwd(
    const void* deter_prev, const void* stoch_prev, const void* act,
    const void* tok, const void* keep, const void* const* params,
    const void* ddet, const void* dsto, const void* dlog, void* ddeter0,
    void* dstoch0, void* dact, void* dtok, void* const* grads,
    void* workspace, int T, int B, int D, int H, int L, int A, int K, int g,
    int C, int sms, float eps, float unimix, void* stream) {
  using namespace seq;
  cudaStream_t st = (cudaStream_t)stream;
  const Dims d{T, B, D, H, L, A, K, g, C, sms};
  Arena a{(char*)workspace, 0};
  const BwdScratch s = carve_bwd(a, d);
  const ObsWeights w = obs_weights(params);
  const int lx = 2 * H + A, dg = D / g, S = L / C, R = T * B;
  const CoreSave save{s.pre01, s.rstd01, s.hpre, s.rstdh, s.gates};
  cudaMemsetAsync(s.cd, 0, sizeof(float) * B * D, st);
  cudaMemsetAsync(s.cs, 0, sizeof(float) * B * L, st);
  const TSeg none = no_seg();
  for (int t = T - 1; t >= 0; --t) {
    const size_t o = (size_t)t * B;
    const float* kp = (const float*)keep + o;
    // Recompute the step's forward, keeping the products' operands.
    obs_step(w, d, (const bf16*)deter_prev + o * D,
             (const bf16*)stoch_prev + o * L, (const bf16*)act + o * A,
             (const bf16*)tok + o * K, kp, s.deterX + o * D,
             s.stochX + o * L, s.xX + o * lx, s.hX + o * D, s.newX + o * D,
             s.xoX + o * H, s.logit, s.parts, save, s.preo, s.rstdo, eps,
             st);
    // The straight-through sample: its gradient joins the logits'.
    st_bwd_kernel<<<(B * S + 7) / 8, 256, 0, st>>>(
        s.logit, (const float*)dsto + o * L, s.cs, (const float*)dlog + o * L,
        B, S, C, unimix, s.dLg + o * L);
    // Posterior head.
    const Head& wh = w.head;
    int ns = mmt(TSeg{s.dLg + o * L, L, 0, wh.wl, L, 0, L}, none, H, s.parts,
                 B, H, sms, st);
    rms_bwd_kernel<<<dim3(B, 1), FIN_THREADS, 0, st>>>(
        s.parts, ns, B, H, H, s.preo, H, s.rstdo, wh.so, wh.so, s.dPo + o * H,
        s.dPo + o * H, H, s.dSo + o * H, s.dSo + o * H);
    ns = mmt(TSeg{s.dPo + o * H, H, 0, wh.wo + (size_t)D * H, H, 0, H}, none,
             K, s.parts, B, K, sms, st);
    combine(s.parts, ns, B, K, K, nullptr, nullptr, nullptr,
            (bf16*)dtok + o * K, K, st);
    ns = mmt(TSeg{s.dPo + o * H, H, 0, wh.wo, H, 0, H}, none, D, s.parts, B,
             D, sms, st);
    // GRU gates.
    gate_bwd_kernel<<<dim3((D + 255) / 256, B), 256, 0, st>>>(
        s.parts, ns, B, D, g, (const float*)ddet + o * D, s.cd, s.gates,
        s.deterX + o * D, s.dG + o * 3 * D, s.ddir);
    // Hidden layer.
    ns = mmt(TSeg{s.dG + o * 3 * D, 3 * D, 3 * dg, w.core.wg, 3 * dg,
                  (size_t)dg * 3 * dg, 3 * dg},
             none, dg, s.parts, B, D, sms, st);
    rms_bwd_kernel<<<dim3(B, 1), FIN_THREADS, 0, st>>>(
        s.parts, ns, B, D, D, s.hpre, D, s.rstdh, w.core.sh, w.core.sh,
        s.dHp + o * D, s.dHp + o * D, D, s.dSh + o * D, s.dSh + o * D);
    ns = mmt(TSeg{s.dHp + o * D, D, 0, w.core.win, D, 0, D}, none, lx,
             s.parts, B, lx, sms, st);
    // Input projections, and the action embedding's gradient.
    rms_bwd_kernel<<<dim3(B, 2), FIN_THREADS, 0, st>>>(
        s.parts, ns, B, lx, H, s.pre01, 2 * H, s.rstd01, w.core.s0,
        w.core.s1, s.dP0 + o * H, s.dP1 + o * H, H, s.dS0 + o * H,
        s.dS1 + o * H);
    combine(s.parts + 2 * H, ns, B, lx, A, nullptr, kp, nullptr,
            (bf16*)dact + o * A, A, st);
    // The state entering the step: deter through the gates' direct path,
    // the block-diagonal hidden weights and the input projection.
    ns = mmt(TSeg{s.dHp + o * D, D, dg, w.core.wblk, dg, (size_t)dg * dg, dg},
             TSeg{s.dP0 + o * H, H, 0, w.core.w0, H, (size_t)dg * H, H}, dg,
             s.parts, B, D, sms, st);
    combine(s.parts, ns, B, D, D, s.ddir, kp, s.cd, nullptr, D, st);
    ns = mmt(TSeg{s.dP1 + o * H, H, 0, w.core.w1, H, 0, H}, none, L,
             s.parts, B, L, sms, st);
    combine(s.parts, ns, B, L, L, nullptr, kp, s.cs, nullptr, L, st);
  }
  combine(s.cd, 1, B, D, D, nullptr, nullptr, nullptr, (bf16*)ddeter0, D,
          st);
  combine(s.cs, 1, B, L, L, nullptr, nullptr, nullptr, (bf16*)dstoch0, L,
          st);
  // Weight gradients over all T B rows, in FIELDS order.
  auto gb = [&](int i) { return (bf16*)grads[i]; };
  auto gf = [&](int i) { return (float*)grads[i]; };
  wgrad(s.deterX, D, 0, s.dP0, H, 0, R, D, H, 1, gb(0), H, 0, st);
  colsum(s.dP0, R, H, H, gb(1), nullptr, st);
  colsum(s.dS0, R, H, H, nullptr, gf(2), st);
  wgrad(s.stochX, L, 0, s.dP1, H, 0, R, L, H, 1, gb(3), H, 0, st);
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
  wgrad(s.newX, D, 0, s.dPo, H, 0, R, D, H, 1, gb(12), H, 0, st);
  wgrad((const bf16*)tok, K, 0, s.dPo, H, 0, R, K, H, 1,
        gb(12) + (size_t)D * H, H, 0, st);
  colsum(s.dPo, R, H, H, gb(13), nullptr, st);
  colsum(s.dSo, R, H, H, nullptr, gf(14), st);
  wgrad(s.xoX, H, 0, s.dLg, L, 0, R, H, L, 1, gb(15), L, 0, st);
  colsum(s.dLg, R, L, L, gb(16), nullptr, st);
  return (int)cudaGetLastError();
}
