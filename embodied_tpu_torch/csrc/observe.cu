// One RSSM observe step (block-GRU core plus posterior head) on Hopper,
// forward and backward: the port of the Pallas TPU kernels
// embodied_tpu/ops/observe.py:fused_obs_step (_obs_kernel) and
// fused_obs_bwd (_obs_bwd_kernel).
//
// The core runs as the stages of blockgru_common.cuh (core_stages), then
// its posterior head (post_head): the split product
// new @ wo[:D] + tok @ wo[D:] (the concatenation is never materialised;
// at acting batch it is split along its D + K = 4352-deep contraction like
// the input projection), the RMS/SiLU finish, and the logit layer written
// in bf16. Bound on an H100: bytes at acting batch, as for the core (the
// weights are 11.1 MB in bf16 at size12m against 0.18 GFLOP at B = 16);
// see blockgru_common.cuh for what the design does about it.
//
// The backward is the observe window's step backward (seq_common.cuh,
// step_bwd) at T = 1 with no sample: the logits' gradient comes in whole
// (the straight-through term is PyTorch's, outside). It recomputes the
// step, runs the gradients back through the posterior head and the core,
// and contracts the B rows into each of the 17 weight gradients. Bound on
// an H100 at B = 16: bytes, the 11 MB of weights read and as many gradient
// bytes written (about 7 us); in practice the chain of small launches.

#include "seq_common.cuh"

namespace blockgru {

struct ObsScratch {
  bf16 *x, *h, *xo;
  float* parts;
};

inline ObsScratch carve_obs(Arena& a, int B, int D, int H, int S, int A,
                            int K, int g, int sms) {
  ObsScratch s;
  s.x = a.take<bf16>((size_t)B * (2 * H + A));
  s.h = a.take<bf16>((size_t)B * D);
  s.xo = a.take<bf16>((size_t)B * H);
  const size_t core = core_parts(B, D, H, S, A, g, sms);
  const size_t head = head_parts(B, D, H, K, sms);
  s.parts = a.take<float>(core > head ? core : head);
  return s;
}

}  // namespace blockgru

using blockgru::bf16;

extern "C" size_t observe_obs_workspace(int B, int D, int H, int S, int A,
                                        int K, int g, int sms) {
  blockgru::Arena a{nullptr, 0};
  blockgru::carve_obs(a, B, D, H, S, A, K, g, sms);
  return a.used + 256;
}

// deter (B, D), stoch (B, S), act (B, A), tok (B, K) bf16; params the 17
// weights of ops/observe.FIELDS. Writes the new deter to out (B, D) and the
// posterior logits to logit (B, L), both bf16.
extern "C" int observe_obs_step(const void* deter, const void* stoch,
                                const void* act, const void* tok,
                                const void* const* params, void* out,
                                void* logit, void* workspace, int B, int D,
                                int H, int S, int A, int K, int L, int g,
                                int sms, float eps, void* stream) {
  using namespace blockgru;
  cudaStream_t st = (cudaStream_t)stream;
  Arena a{(char*)workspace, 0};
  const ObsScratch s = carve_obs(a, B, D, H, S, A, K, g, sms);
  const int lx = 2 * H + A;
  mask((const bf16*)act, A, A, nullptr, s.x + 2 * H, lx, B, st);
  core_stages(core_weights(params), (const bf16*)deter, (const bf16*)stoch,
              s.x, s.h, (bf16*)out, s.parts, CoreSave{}, B, D, H, S, A, g,
              sms, eps, st);
  post_head(head_weights(params + 12), (const bf16*)out, (const bf16*)tok,
            s.xo, (bf16*)logit, s.parts, nullptr, nullptr, B, D, H, K, L,
            sms, eps, st);
  return (int)cudaGetLastError();
}

namespace {

// The backward's dimensions: one step with the posterior head.
seq::Dims obs_dims(int B, int D, int H, int S, int A, int K, int L, int g,
                   int sms) {
  return seq::Dims{1, B, D, H, S, L, A, K, g, 1, sms, true};
}

}  // namespace

extern "C" size_t observe_obs_bwd_workspace(int B, int D, int H, int S,
                                            int A, int K, int L, int g,
                                            int sms) {
  seq::Arena a{nullptr, 0};
  seq::carve_bwd(a, obs_dims(B, D, H, S, A, K, L, g, sms));
  return a.used + 256;
}

// Inputs as observe_obs_step, and the f32 gradients of its outputs, dout
// (B, D) and dlogit (B, L). Outputs the gradients of deter, stoch, act and
// tok (bf16) and `grads`, the 17 weight gradients (bf16; f32 for the norm
// scales).
extern "C" int observe_obs_bwd(const void* deter, const void* stoch,
                               const void* act, const void* tok,
                               const void* const* params, const void* dout,
                               const void* dlogit, void* ddeter,
                               void* dstoch, void* dact, void* dtok,
                               void* const* grads, void* workspace, int B,
                               int D, int H, int S, int A, int K, int L,
                               int g, int sms, float eps, void* stream) {
  using namespace seq;
  cudaStream_t st = (cudaStream_t)stream;
  const Dims d = obs_dims(B, D, H, S, A, K, L, g, sms);
  Arena a{(char*)workspace, 0};
  BwdScratch s = carve_bwd(a, d);
  s.dLg = (float*)dlogit;  // no sample: the logits' gradient as it came
  cudaMemsetAsync(s.cd, 0, sizeof(float) * B * D, st);
  cudaMemsetAsync(s.cs, 0, sizeof(float) * B * S, st);
  step_bwd(obs_weights(params, true), d, s, 0, (const bf16*)deter,
           (const bf16*)stoch, (const bf16*)act, (const bf16*)tok, nullptr,
           (const float*)dout, nullptr, (const float*)dlogit, (bf16*)dact,
           (bf16*)dtok, eps, 0.f, st);
  state_grads(d, s, (bf16*)ddeter, (bf16*)dstoch, st);
  weight_grads(d, s, (const bf16*)tok, grads, st);
  return (int)cudaGetLastError();
}
