// One block-GRU core step on Hopper, forward and backward: the port of the
// Pallas TPU kernels embodied_tpu/ops/blockgru.py:fused_core_step (_kernel)
// and fused_core_bwd (_bwd_kernel). The forward's stages, its bound and
// its design are described in blockgru_common.cuh. Built with nvcc into a
// shared library with a C interface (ops/build.py) and called through
// ctypes by embodied_tpu_torch/ops/blockgru.py.
//
// The action features are copied into the last A columns of the hidden
// stage's input row x = [xd, x0, act], which the core stages take whole.
//
// The backward is the observe window's step backward (seq_common.cuh,
// step_bwd) at T = 1 without the posterior head: it recomputes the core,
// runs the gradient of the new deter back through the gates, the hidden
// layer and the input projections, and contracts the B rows into each
// weight gradient. Bound on an H100 at B = 16 (size12m): bytes, the 8.7 MB
// of bf16 weights read and as many gradient bytes written (about 5 us);
// in practice the chain of about 20 small launches, as for the forward.

#include "seq_common.cuh"

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

namespace {

// The backward's dimensions: one step of the core alone.
seq::Dims core_dims(int B, int D, int H, int S, int A, int g, int sms) {
  return seq::Dims{1, B, D, H, S, S, A, 0, g, 1, sms, false};
}

}  // namespace

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

extern "C" size_t blockgru_core_bwd_workspace(int B, int D, int H, int S,
                                              int A, int g, int sms) {
  seq::Arena a{nullptr, 0};
  seq::carve_bwd(a, core_dims(B, D, H, S, A, g, sms));
  return a.used + 256;
}

// Inputs as blockgru_core_step, and dout (B, D) f32, the gradient of the
// new deter. Outputs the gradients of deter, stoch and act (bf16) and
// `grads`, the 12 weight gradients (bf16; f32 for the norm scales).
extern "C" int blockgru_core_bwd(const void* deter, const void* stoch,
                                 const void* act, const void* const* params,
                                 const void* dout, void* ddeter, void* dstoch,
                                 void* dact, void* const* grads,
                                 void* workspace, int B, int D, int H, int S,
                                 int A, int g, int sms, float eps,
                                 void* stream) {
  using namespace seq;
  cudaStream_t st = (cudaStream_t)stream;
  const Dims d = core_dims(B, D, H, S, A, g, sms);
  Arena a{(char*)workspace, 0};
  const BwdScratch s = carve_bwd(a, d);
  cudaMemsetAsync(s.cd, 0, sizeof(float) * B * D, st);
  cudaMemsetAsync(s.cs, 0, sizeof(float) * B * S, st);
  step_bwd(obs_weights(params, false), d, s, 0, (const bf16*)deter,
           (const bf16*)stoch, (const bf16*)act, nullptr, nullptr,
           (const float*)dout, nullptr, nullptr, (bf16*)dact, nullptr, eps,
           0.f, st);
  state_grads(d, s, (bf16*)ddeter, (bf16*)dstoch, st);
  weight_grads(d, s, nullptr, grads, st);
  return (int)cudaGetLastError();
}

namespace {

// The forward product of blockgru_stage_product on weights W.
template <class W>
int product16(const void* x, const void* w, const float* scale,
              const void* x2, const void* w2, const float* scale2, void* out,
              int B, int N, int K, int K2, int g, int ns, int sms,
              cudaStream_t st) {
  using namespace blockgru;
  const int gN = N / g;
  if (ns <= 0) ns = tc_splits<W>(N, gN, B, K + K2, sms);
  const OpndT<W> a{x, g * K, K, (const W*)w, gN, (size_t)K * gN, K, scale};
  const OpndT<W> b =
      K2 ? OpndT<W>{x2, K2, 0, (const W*)w2, N, (size_t)gN, K2, scale2}
         : no_opnd<W>();
  tc16<false>(a, b, gN, (const bf16*)nullptr, (float*)out, N, B, N, ns, st);
  return ns;
}

}  // namespace

// The 16-row tensor-core product and the weight gradient of the stages on
// their own, for the card tests and the smoke run's stage rows
// (ops/blockgru.py stage_product, stage_wgrad). Block-diagonal in g groups
// of K rows: x (B, g K), w (g, K, N / g) and out[q] = x[:, q] @ w[q]
// forward, plus, where K2 > 0, x2 (B, K2) dense against w2 (K2, N) (as the
// hidden layer's x against win); with is_int8, w and w2 are int8 and each
// segment's sums are times its column scales (scale, scale2: N f32, by
// flat column). With `trans` (bf16, K2 = 0), x f32 (rounded to bf16), w
// (g, N / g, K) and out[q] = x[:, q] @ w[q]^T. Writes the ns split
// partials (ns, B, N) f32; ns <= 0 takes tc_splits. Returns ns, or minus
// the CUDA error.
extern "C" int blockgru_stage_product(const void* x, const void* w,
                                      const void* scale, const void* x2,
                                      const void* w2, const void* scale2,
                                      void* out, int trans, int is_int8,
                                      int B, int N, int K, int K2, int g,
                                      int ns, int sms, void* stream) {
  using namespace blockgru;
  cudaStream_t st = (cudaStream_t)stream;
  const int gN = N / g;
  if (trans) {
    if (ns <= 0) ns = tc_splits(N, gN, B, K, sms);
    tc16<true>(Opnd{x, g * K, K, (const bf16*)w, K, (size_t)K * gN, K},
               no_opnd(), gN, (const bf16*)nullptr, (float*)out, N, B, N, ns,
               st);
  } else if (is_int8) {
    ns = product16<int8_t>(x, w, (const float*)scale, x2, w2,
                           (const float*)scale2, out, B, N, K, K2, g, ns,
                           sms, st);
  } else {
    ns = product16<bf16>(x, w, nullptr, x2, w2, nullptr, out, B, N, K, K2, g,
                         ns, sms, st);
  }
  const int code = (int)cudaGetLastError();
  return code ? -code : ns;
}

namespace {

template <class Bias, class Out>
void product128(blockgru::Opnd a, blockgru::Opnd b, int gN,
                const void* bias, void* out, int B, int N, int ns,
                cudaStream_t st) {
  blockgru::tc128(a, b, gN, (const Bias*)bias, (Out*)out, N, B, N, ns, st);
}

}  // namespace

// The 128-row tensor-core product on its own, for the card tests and the
// smoke run's stage rows (ops/blockgru.py stage_product128): x (B, g K)
// block-diagonal against w (g, K, N / g), plus, where K2 > 0, x2 (B, K2)
// dense against w2 (K2, N) (as the hidden layer's x against win), plus
// bias (N) (bf16, or f32 with bias_f32; none where null). Writes the ns
// split partials (ns, B, N) f32, or with out_bf16 the finished product
// (B, N) bf16 (ns 1). ns <= 0 takes tc128_splits. Returns ns, or minus
// the CUDA error.
extern "C" int blockgru_stage_product128(const void* x, const void* w,
                                         const void* x2, const void* w2,
                                         const void* bias, void* out,
                                         int bias_f32, int out_bf16, int B,
                                         int N, int K, int K2, int g, int ns,
                                         int sms, void* stream) {
  using namespace blockgru;
  cudaStream_t st = (cudaStream_t)stream;
  const int gN = N / g;
  if (ns <= 0) ns = tc128_splits(N, gN, B, K + K2, sms);
  const Opnd a{x, g * K, K, (const bf16*)w, gN, (size_t)K * gN, K};
  const Opnd b = K2 ? Opnd{x2, K2, 0, (const bf16*)w2, N, (size_t)gN, K2}
                    : no_opnd();
  if (out_bf16 && bias_f32)
    product128<float, bf16>(a, b, gN, bias, out, B, N, ns, st);
  else if (out_bf16)
    product128<bf16, bf16>(a, b, gN, bias, out, B, N, ns, st);
  else if (bias_f32)
    product128<float, float>(a, b, gN, bias, out, B, N, ns, st);
  else
    product128<bf16, float>(a, b, gN, bias, out, B, N, ns, st);
  const int code = (int)cudaGetLastError();
  return code ? -code : ns;
}

// out[q] = x[:, q]^T @ bf16(y[:, q]) over R rows: x (R, g M) bf16, y
// (R, g N) f32, out (g, M, N) bf16.
extern "C" int blockgru_stage_wgrad(const void* x, const void* y, void* out,
                                    int R, int M, int N, int g,
                                    void* stream) {
  seq::wgrad((const bf16*)x, g * M, M, (const float*)y, g * N, N, R, M, N, g,
             (bf16*)out, N, (size_t)M * N, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
