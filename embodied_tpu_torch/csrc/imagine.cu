// One imagination step on Hopper (core, two-layer prior and the stochastic
// sample): the port of the Pallas TPU kernel
// embodied_tpu/ops/imagine.py:fused_imag_step (_kernel).
//
// The stages are seq_common.cuh's imag_step, which the whole-horizon
// rollout (imagine_seq.cu) runs once per step after its policy: the
// block-GRU core (blockgru_common.cuh), two silu(rms(.)) prior layers, the
// f32 logits, and the unimix Gumbel-max one-hot of each group with the
// noise an input. The action embedding comes in whole and is copied into
// the last A columns of the core's input row x = [xd, x0, act].
//
// Bound on an H100 at B = 1024 rows (the train step's rollout at size12m):
// operations, about 10 GFLOP against 18 MB of weights and rows. From 128
// rows on, the products run on the 128-row tensor-core stage (wgmma fed by
// TMA, split-K where the tiles are fewer than the SMs); at the report's
// B = 6 the stages are bound by the weight bytes and take the split-K
// 16-row tensor-core products (blockgru_common.cuh, tc16_kernel).

#include "seq_common.cuh"

namespace seq {

struct StepScratch {
  bf16 *x, *h, *px, *py;
  float* parts;
};

inline StepScratch carve_step(Arena& a, int B, int D, int H, int L, int A,
                              int g, int sms) {
  StepScratch s;
  s.x = a.take<bf16>((size_t)B * (2 * H + A));
  s.h = a.take<bf16>((size_t)B * D);
  s.px = a.take<bf16>((size_t)B * H);
  s.py = a.take<bf16>((size_t)B * H);
  s.parts = a.take<float>(imag_parts(B, D, H, L, A, g, sms));
  return s;
}

}  // namespace seq

using seq::bf16;

extern "C" size_t imagine_step_workspace(int B, int D, int H, int L, int A,
                                         int g, int sms) {
  seq::Arena a{nullptr, 0};
  seq::carve_step(a, B, D, H, L, A, g, sms);
  return a.used + 256;
}

// deter (B, D), stoch (B, L), act (B, A) bf16, gum (B, L) f32; params the
// 20 weights of ops/imagine.FIELDS. Writes the new deter (B, D) and the
// one-hot sample (B, L) in bf16 and the prior logits (B, L) in f32.
extern "C" int imagine_step(const void* deter, const void* stoch,
                            const void* act, const void* gum,
                            const void* const* params, void* deter_out,
                            void* stoch_out, void* logit_out,
                            void* workspace, int B, int D, int H, int L,
                            int A, int g, int C, int sms, float eps,
                            float unimix, void* stream) {
  using namespace seq;
  cudaStream_t st = (cudaStream_t)stream;
  Arena a{(char*)workspace, 0};
  const StepScratch s = carve_step(a, B, D, H, L, A, g, sms);
  mask((const bf16*)act, A, A, nullptr, s.x + 2 * H, 2 * H + A, B, st);
  imag_step(core_weights(params), prior_weights(params + 12),
            (const bf16*)deter, (const bf16*)stoch, s.x, s.h, s.px, s.py,
            s.parts, (bf16*)deter_out, (float*)logit_out, (const float*)gum,
            (bf16*)stoch_out, B, D, H, L, A, g, C, sms, eps, unimix, st);
  return (int)cudaGetLastError();
}
