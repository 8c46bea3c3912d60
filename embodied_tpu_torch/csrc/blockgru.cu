// One block-GRU core step on Hopper: the port of the Pallas TPU kernel
// embodied_tpu/ops/blockgru.py:fused_core_step (_kernel). The stages, the
// bound and the design are described in blockgru_common.cuh. Built with
// nvcc into a shared library with a C interface (ops/build.py) and called
// through ctypes by embodied_tpu_torch/ops/blockgru.py.

#include "blockgru_common.cuh"

using blockgru::bf16;

extern "C" int blockgru_core_step(
    const void* deter, const void* stoch, const void* act, const void* w0,
    const void* b0, const void* s0, const void* w1, const void* b1,
    const void* s1, const void* wblk, const void* bblk, const void* win,
    const void* sh, const void* wg, const void* bg, void* out, void* pre,
    void* xn, void* hpre, void* h, int B, int D, int H, int S, int A, int g,
    int ns1, int ns2, float eps, void* stream) {
  blockgru::launch_core(
      (const bf16*)deter, (const bf16*)stoch, (const bf16*)act,
      (const bf16*)w0, (const bf16*)b0, (const float*)s0, (const bf16*)w1,
      (const bf16*)b1, (const float*)s1, (const bf16*)wblk,
      (const bf16*)bblk, (const bf16*)win, (const float*)sh, (const bf16*)wg,
      (const bf16*)bg, (bf16*)out, (float*)pre, (bf16*)xn, (float*)hpre,
      (bf16*)h, B, D, H, S, A, g, ns1, ns2, eps, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
