// One block-GRU core step on Hopper: the port of the Pallas TPU kernel
// embodied_tpu/ops/blockgru.py:fused_core_step (_kernel). The stages, the
// bound and the design are described in blockgru_common.cuh. Built with
// nvcc into a shared library with a C interface (ops/build.py) and called
// through ctypes by embodied_tpu_torch/ops/blockgru.py.
//
// The action features are copied into the last A columns of the hidden
// stage's input row x = [xd, x0, act], which the core stages take whole.

#include "blockgru_common.cuh"

namespace blockgru {

struct StepScratch {
  bf16 *x, *h;
  float* parts;
};

inline StepScratch carve_step(Arena& a, int B, int D, int H, int S, int A,
                              int g, int sms) {
  StepScratch s;
  s.x = a.take<bf16>((size_t)B * (2 * H + A));
  s.h = a.take<bf16>((size_t)B * D);
  s.parts = a.take<float>(core_parts(B, D, H, S, A, g, sms));
  return s;
}

}  // namespace blockgru

using blockgru::bf16;

extern "C" size_t blockgru_core_workspace(int B, int D, int H, int S, int A,
                                          int g, int sms) {
  blockgru::Arena a{nullptr, 0};
  blockgru::carve_step(a, B, D, H, S, A, g, sms);
  return a.used + 256;
}

// deter (B, D), stoch (B, S), act (B, A) bf16; params the 12 weights of
// ops/blockgru.FIELDS. Writes the new deter to out (B, D).
extern "C" int blockgru_core_step(const void* deter, const void* stoch,
                                  const void* act, const void* const* params,
                                  void* out, void* workspace, int B, int D,
                                  int H, int S, int A, int g, int sms,
                                  float eps, void* stream) {
  using namespace blockgru;
  cudaStream_t st = (cudaStream_t)stream;
  Arena a{(char*)workspace, 0};
  const StepScratch s = carve_step(a, B, D, H, S, A, g, sms);
  const int lx = 2 * H + A;
  mask((const bf16*)act, A, A, nullptr, s.x + 2 * H, lx, B, st);
  core_stages(core_weights(params), (const bf16*)deter, (const bf16*)stoch,
              s.x, s.h, (bf16*)out, s.parts, CoreSave{}, B, D, H, S, A, g,
              sms, eps, st);
  return (int)cudaGetLastError();
}
