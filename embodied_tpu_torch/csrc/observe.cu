// One RSSM observe step (block-GRU core plus posterior head) on Hopper: the
// port of the Pallas TPU kernel embodied_tpu/ops/observe.py:fused_obs_step
// (_obs_kernel).
//
// The core runs as the stages of blockgru_common.cuh. Three launches follow
// for the posterior head:
//
//   post    preo = new @ wo[:D] + tok @ wo[D:] + bo       (ns3, B, H) f32
//   finish  xo = bf16(silu(rms(preo) * so))                   (B, H) bf16
//   logits  logit = xo @ wl + bl                              (B, L) bf16
//
// `post` keeps the split product, so [new, tok] is never materialised; it
// is split along its contraction (D + K = 4352 deep at size12m) like the
// input projection. Bound on an H100: bytes at acting batch, as for the
// core (the weights are 11.1 MB in bf16 at size12m against 0.18 GFLOP at
// B = 16); see blockgru_common.cuh for what the design does about it.

#include "blockgru_common.cuh"

namespace blockgru {

// Stage 4, split z: the split's partial sums of [new (D) | tok (K)] @ wo;
// split 0 adds bo. Grid (H / TN, ceil(B / TM), ns).
__global__ void __launch_bounds__(THREADS)
post_kernel(const bf16* state, const bf16* tok, const bf16* wo,
            const bf16* bo, float* preo, int B, int D, int K, int H, int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM, z = blockIdx.z;
  int lo, hi;
  split_range(D + K, ns, z, &lo, &hi);
  float acc[1] = {0.f};
  segment_mm(acc, LoadBf16{state, D}, 0, D, lo, hi, wo + col0, H, row0, B,
             xs, ws);
  segment_mm(acc, LoadBf16{tok, K}, D, K, lo, hi, wo + (size_t)D * H + col0,
             H, row0, B, xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    const float bias = z ? 0.f : to_f(bo[col]);
    preo[((size_t)z * B + row) * H + col] = acc[0] + bias;
  }
}

// Stage 5: logit = xo @ wl + bl. Grid (L / TN, ceil(B / TM)).
__global__ void __launch_bounds__(THREADS)
logit_kernel(const bf16* xo, const bf16* wl, const bf16* bl, bf16* logit,
             int B, int H, int L) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM;
  float acc[1] = {0.f};
  tile_mm<1>(acc, LoadBf16{xo, H}, 0, H, wl + col0, 0, L, row0, B, xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    logit[(size_t)row * L + col] = __float2bfloat16(acc[0] + to_f(bl[col]));
  }
}

}  // namespace blockgru

using blockgru::bf16;

extern "C" int observe_obs_step(
    const void* deter, const void* stoch, const void* act, const void* tok,
    const void* w0, const void* b0, const void* s0, const void* w1,
    const void* b1, const void* s1, const void* wblk, const void* bblk,
    const void* win, const void* sh, const void* wg, const void* bg,
    const void* wo, const void* bo, const void* so, const void* wl,
    const void* bl, void* out, void* logit, void* pre, void* xn, void* hpre,
    void* h, void* preo, void* xo, int B, int D, int H, int S, int A, int K,
    int L, int g, int ns1, int ns2, int ns3, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  blockgru::launch_core(
      (const bf16*)deter, (const bf16*)stoch, (const bf16*)act,
      (const bf16*)w0, (const bf16*)b0, (const float*)s0, (const bf16*)w1,
      (const bf16*)b1, (const float*)s1, (const bf16*)wblk,
      (const bf16*)bblk, (const bf16*)win, (const float*)sh, (const bf16*)wg,
      (const bf16*)bg, (bf16*)out, (float*)pre, (bf16*)xn, (float*)hpre,
      (bf16*)h, B, D, H, S, A, g, ns1, ns2, eps, st);
  blockgru::post_kernel<<<blockgru::grid_for(H, B, ns3), blockgru::THREADS, 0,
                          st>>>(
      (const bf16*)out, (const bf16*)tok, (const bf16*)wo, (const bf16*)bo,
      (float*)preo, B, D, K, H, ns3);
  blockgru::finish_kernel<<<dim3(B, 1), blockgru::FIN_THREADS, 0, st>>>(
      (const float*)preo, ns3, B, H, H, (const float*)so, (const float*)so,
      eps, (bf16*)xo);
  blockgru::logit_kernel<<<blockgru::grid_for(L, B), blockgru::THREADS, 0,
                           st>>>(
      (const bf16*)xo, (const bf16*)wl, (const bf16*)bl, (bf16*)logit, B, H,
      L);
  return (int)cudaGetLastError();
}
