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
// At the default dims (178 MB of bf16 weights) the weights exceed the L2
// and every step streams them again: 3.4 ms per window forward and twice
// that backward at the memory rate. Every 16-row product runs on the
// tensor-core stage of blockgru_common.cuh (tc16_kernel), the transposed
// products of the backward too, and the weight gradients on the
// tensor cores (seq_common.cuh, wgrad_kernel). What remains is the chain
// of 64 dependent steps of launches (about 13 forward, 27 backward per
// step); a persistent kernel with grid-wide barriers and a CUDA graph are
// later work.

#include "seq_common.cuh"

using seq::bf16;

extern "C" size_t observe_seq_fwd_workspace(int T, int B, int D, int H,
                                            int L, int A, int K, int g,
                                            int C, int sms) {
  return seq::window_fwd_workspace(
      seq::window(T, B, D, H, L, A, K, g, C, sms));
}

extern "C" size_t observe_seq_bwd_workspace(int T, int B, int D, int H,
                                            int L, int A, int K, int g,
                                            int C, int sms) {
  seq::Arena a{nullptr, 0};
  seq::carve_bwd(a, seq::window(T, B, D, H, L, A, K, g, C, sms));
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
  return seq::window_fwd(seq::obs_weights(params, true),
                         seq::window(T, B, D, H, L, A, K, g, C, sms), deter0,
                         stoch0, act, tok, keep, gum, deter_seq, stoch_seq,
                         logit_seq, workspace, eps, unimix,
                         (cudaStream_t)stream);
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
  const Dims d = window(T, B, D, H, L, A, K, g, C, sms);
  Arena a{(char*)workspace, 0};
  const BwdScratch s = carve_bwd(a, d);
  const ObsWeights w = obs_weights(params, true);
  cudaMemsetAsync(s.cd, 0, sizeof(float) * B * D, st);
  cudaMemsetAsync(s.cs, 0, sizeof(float) * B * L, st);
  for (int t = T - 1; t >= 0; --t) {
    step_bwd(w, d, s, (size_t)t * B, (const bf16*)deter_prev,
             (const bf16*)stoch_prev, (const bf16*)act, (const bf16*)tok,
             (const float*)keep, (const float*)ddet, (const float*)dsto,
             (const float*)dlog, (bf16*)dact, (bf16*)dtok, eps, unimix, st);
  }
  state_grads(d, s, (bf16*)ddeter0, (bf16*)dstoch0, st);
  weight_grads(d, s, (const bf16*)tok, grads, st);
  return (int)cudaGetLastError();
}
