// The observe window's forward on int8 weights, on Hopper: the port of the
// Pallas TPU kernel embodied_tpu/ops/qcore.py:qobs_window (_q_kernel,
// _q_step, _qmm).
//
// It is the bf16 window's forward (seq_common.cuh, window_fwd, which
// observe_seq.cu runs on bf16 weights) on the seven matrices w0, w1, wblk,
// win, wg, wo and wl in int8. Every product runs on the 16-row
// tensor-core stage of blockgru_common.cuh (tc16_kernel), which streams
// the int8 tiles as they lie (16 weights per 16-byte cp.async load,
// 128-deep chunks), forms the bf16 fragments from them in registers
// (exact: |q| <= 127) and, once its f32 sums are formed, multiplies them
// by the matrix's per-output-column f32 scales before split 0 adds the
// bias: the scale multiplies the (B, cols) output, never the weight, as
// the TPU kernel's _qmm does. wblk and wg carry one scale per block column
// ((g, dg) and (g, 3 dg)); wo one scale for both of its parts (new and
// tokens); the hidden layer's two segments (wblk, win) each their own.
// Biases and norm scales stay exact. The TPU kernel's column chunks
// (`nch`, a bound on a VMEM temporary) have no counterpart: the stage
// already stages 64-column tiles.
//
// Bound on an H100 at the default configuration (D 8192, H 1024, L 2048,
// K 9216, T 64, B 16): the seven matrices hold 89 M weights, 89 MB in int8
// and 178 MB in bf16. Either is beyond the 50 MB L2, so unlike the TPU
// kernel's VMEM residency, every step streams its weights from device
// memory: 64 x 89 MB over 3.35 TB/s is a floor of 1.7 ms per window (3.4
// ms in bf16). At 16 rows a product does 32 flops per weight, far below
// the rate at which operations would bind, so the design streams the int8
// tiles through the same ring and fragments as bf16, with half the bytes
// a column; the window's row stages and launches (finish, mask, the gate
// update, the sample) are those of the bf16 window.

#include "seq_common.cuh"

namespace seq {

// The 17 weights of ops/qcore.FIELDS, the seven QUANT matrices in int8,
// and their f32 column scales in QUANT order (w0, w1, wblk, win, wg, wo,
// wl).
inline ObsWeightsT<int8_t> qobs_weights(const void* const* p,
                                        const void* const* q) {
  auto i8 = [&](int i) { return (const int8_t*)p[i]; };
  auto b = [&](int i) { return (const bf16*)p[i]; };
  auto f = [&](int i) { return (const float*)p[i]; };
  auto s = [&](int i) { return (const float*)q[i]; };
  const CoreT<int8_t> core{i8(0), b(1), f(2),  i8(3), b(4), f(5),
                           i8(6), b(7), i8(8), f(9),  i8(10), b(11),
                           s(0),  s(1), s(2),  s(3),  s(4)};
  const HeadT<int8_t> head{i8(12), b(13), f(14), i8(15), b(16), s(5), s(6)};
  return ObsWeightsT<int8_t>{core, head};
}

}  // namespace seq

extern "C" size_t qobs_window_workspace(int T, int B, int D, int H, int L,
                                        int A, int K, int g, int C,
                                        int sms) {
  return seq::window_fwd_workspace(
      seq::window(T, B, D, H, L, A, K, g, C, sms));
}

// Inputs time-major as observe_seq_fwd's: act (T, B, A), tok (T, B, K),
// keep (T, B) f32, gum (T, B, L) f32; params the 17 weights (QUANT
// matrices int8), scales the seven column-scale vectors. Outputs
// deter_seq (T, B, D), stoch_seq (T, B, L) one-hots, logit_seq (T, B, L)
// f32.
extern "C" int qobs_window_fwd(
    const void* deter0, const void* stoch0, const void* act, const void* tok,
    const void* keep, const void* gum, const void* const* params,
    const void* const* scales, void* deter_seq, void* stoch_seq,
    void* logit_seq, void* workspace, int T, int B, int D, int H, int L,
    int A, int K, int g, int C, int sms, float eps, float unimix,
    void* stream) {
  return seq::window_fwd(seq::qobs_weights(params, scales),
                         seq::window(T, B, D, H, L, A, K, g, C, sms), deter0,
                         stoch0, act, tok, keep, gum, deter_seq, stoch_seq,
                         logit_seq, workspace, eps, unimix,
                         (cudaStream_t)stream);
}
