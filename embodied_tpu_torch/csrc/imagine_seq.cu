// The whole imagination rollout on Hopper, forward only: the port of the
// Pallas TPU kernel embodied_tpu/ops/imagine_seq.py:fused_imagine_seq
// (_seq_kernel).
//
// Per step t (the horizon in one C call; the stages of blockgru_common.cuh
// and the sample of seq_common.cuh):
//   policy   npol layers of silu(rms(x @ wm + bm) * sm) on [deter, stoch]
//   head     the action head's pre-activations, f32 (categorical logits,
//            or the bounded normal's mean and stddev)
//   action   one thread per row: the Gumbel-max one-hot, or
//            tanh(mean) + std * noise; the record goes to act_seq[t], the
//            clipped action a / max(1, |a|) to the embedding
//   embed    silu(rms(act @ wa + ba) * sa) into the core's input row
//   core     the block-GRU core, new deter written to deter_seq[t]
//   prior    two silu(rms(.)) layers and the logits, f32, to logit_seq[t]
//   sample   unimix Gumbel-max one-hot per group, to stoch_seq[t]
// The last three are seq_common.cuh's imag_step, which the per-step kernel
// (imagine.cu) runs alone.
// Step t + 1 reads its state from deter_seq[t] and stoch_seq[t].
//
// The action width (5 or 6 on the dummy tasks) is padded by the wrapper to
// the kernel's 16-column tile: zero weight columns and rows, and a -1e9
// bias on padded classes; only the first A lanes are sampled.
//
// Bound on an H100: operations. At B = 1024 rows a step does 12 GFLOP
// against 12 MB of weights at size12m and 191 GFLOP against 190 MB at the
// default dims (ops/imagine_seq.products lists the products; work() gives
// the bound), a thousand flops per weight byte, far above the ~295 per
// byte where the card stops being bound by memory. What the design does
// about it: every product of 64 columns or more runs on the 128-row
// tensor-core stage of blockgru_common.cuh (tc128_kernel: wgmma m64n256k16
// on 128 x 256 tiles, both operands fed by TMA into a 4-deep ring of
// swizzled shared memory), and the products of 1,024 columns, 32 tiles at
// 1,024 rows, split their contraction to fill the SMs (tc128_splits, f32
// partials added in split order by finish). The action head's 16 or 32
// columns stay on the FMA stage. Left for later: one persistent launch per
// step or horizon (the row stages and some 20 launches a step), and the
// GRU update fused into the gates' epilogue.

#include "seq_common.cuh"

namespace seq {

// One thread per row: the action head's sample (see the file's note).
// head (B, ldh) f32: the logits, or the mean's AP columns then the
// stddev's; noise (B, AP) f32.
__global__ void act_kernel(const float* head, int ldh, const float* noise,
                           int B, int A, int AP, int disc, float minstd,
                           float maxstd, float* act, bf16* act_in) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* h = head + (size_t)row * ldh;
  const float* z = noise + (size_t)row * AP;
  float* out = act + (size_t)row * AP;
  bf16* in = act_in + (size_t)row * AP;
  if (disc) {
    int arg = 0;
    float best = -INFINITY;
    for (int a = 0; a < A; ++a) {
      const float y = h[a] + z[a];
      if (y > best) {
        best = y;
        arg = a;
      }
    }
    for (int a = 0; a < AP; ++a) {
      out[a] = a == arg ? 1.f : 0.f;
      in[a] = __float2bfloat16(a == arg ? 1.f : 0.f);
    }
    return;
  }
  for (int a = 0; a < AP; ++a) {
    float v = 0.f;
    if (a < A) {
      const float std =
          (maxstd - minstd) * sigmoid(h[AP + a] + 2.f) + minstd;
      v = tanhf(h[a]) + std * z[a];
    }
    out[a] = v;
    in[a] = __float2bfloat16(v / fmaxf(1.f, fabsf(v)));
  }
}

struct ImagDims {
  int steps, B, D, H, L, A, U, AP, NH, npol, g, C, sms;
};

struct ImagScratch {
  bf16 *xa, *xb, *act_in, *x, *h, *px, *py;
  float *head, *parts;
};

inline ImagScratch carve_imag(Arena& a, const ImagDims& d) {
  const size_t B = d.B;
  ImagScratch s;
  s.xa = a.take<bf16>(B * d.U);
  s.xb = a.take<bf16>(B * d.U);
  s.act_in = a.take<bf16>(B * d.AP);
  s.x = a.take<bf16>(B * (2 * d.H + d.A));
  s.h = a.take<bf16>(B * d.D);
  s.px = a.take<bf16>(B * d.H);
  s.py = a.take<bf16>(B * d.H);
  s.head = a.take<float>(B * d.NH);
  size_t most = imag_parts(d.B, d.D, d.H, d.L, d.A, d.g, d.sms);
  const size_t stages[] = {
      (size_t)most_splits(d.U, d.B, d.D + d.L, d.sms) * B * d.U,
      (size_t)most_splits(d.U, d.B, d.U, d.sms) * B * d.U,
      (size_t)most_splits(d.A, d.B, d.AP, d.sms) * B * d.A};
  for (size_t v : stages) most = v > most ? v : most;
  s.parts = a.take<float>(most);
  return s;
}

}  // namespace seq

using seq::bf16;

extern "C" size_t imagine_seq_workspace(int steps, int B, int D, int H, int L,
                                        int A, int U, int AP, int NH,
                                        int npol, int g, int C, int sms) {
  seq::Arena a{nullptr, 0};
  seq::carve_imag(a, seq::ImagDims{steps, B, D, H, L, A, U, AP, NH, npol, g,
                                   C, sms});
  return a.used + 256;
}

// deter0 (B, D), stoch0 (B, L) bf16; gum (steps, B, L), noise
// (steps, B, AP) f32. params: the 12 core weights, the prior's 8 (wp0, bp0,
// sp0, wp1, bp1, sp1, wpl, bpl), the embedding's 3 (wa (AP, A), ba, sa),
// the policy MLP's 3 per layer (wm, bm, sm), then the head (U, NH) and its
// f32 bias (NH), padded to AP lanes (NH = AP for a categorical head, 2 AP
// for the bounded normal's mean and stddev). Outputs time-major deter_seq,
// stoch_seq (one-hots), logit_seq f32 and act_seq (steps, B, AP) f32.
extern "C" int imagine_seq_fwd(
    const void* deter0, const void* stoch0, const void* gum,
    const void* noise, const void* const* params, void* deter_seq,
    void* stoch_seq, void* logit_seq, void* act_seq, void* workspace,
    int steps, int B, int D, int H, int L, int A, int U, int AP, int NH,
    int npol, int g, int C, int sms, int adim, int disc, float minstd,
    float maxstd, float eps, float unimix, void* stream) {
  using namespace seq;
  cudaStream_t st = (cudaStream_t)stream;
  const ImagDims d{steps, B, D, H, L, A, U, AP, NH, npol, g, C, sms};
  Arena a{(char*)workspace, 0};
  const ImagScratch s = carve_imag(a, d);
  auto b = [&](int i) { return (const bf16*)params[i]; };
  auto f = [&](int i) { return (const float*)params[i]; };
  const Core core = core_weights(params);
  const Prior prior = prior_weights(params + 12);
  const int E = 20, M = 23, HD = 23 + 3 * npol;
  const int lx = 2 * H + A;
  bf16* dseq = (bf16*)deter_seq;
  bf16* sseq = (bf16*)stoch_seq;
  float* lseq = (float*)logit_seq;
  float* aseq = (float*)act_seq;
  const XSeg none{nullptr, 0, 0};
  for (int t = 0; t < steps; ++t) {
    const size_t o = (size_t)t * B, p = o - B;
    const bf16* deter = t ? dseq + p * D : (const bf16*)deter0;
    const bf16* stoch = t ? sseq + p * L : (const bf16*)stoch0;
    // Policy MLP and action.
    int ns = mm_splits<bf16>(B, U, D + L, sms);
    mm(XSeg{deter, D, D}, XSeg{stoch, L, L}, b(M), b(M + 1), s.parts, B, U,
       ns, st);
    finish(s.parts, ns, B, U, U, 1, f(M + 2), f(M + 2), eps, s.xa, U,
           nullptr, nullptr, st);
    bf16* x = s.xa;
    bf16* y = s.xb;
    for (int i = 1; i < npol; ++i) {
      ns = mm_splits<bf16>(B, U, U, sms);
      mm(XSeg{x, U, U}, none, b(M + 3 * i), b(M + 3 * i + 1), s.parts, B, U,
         ns, st);
      finish(s.parts, ns, B, U, U, 1, f(M + 3 * i + 2), f(M + 3 * i + 2),
             eps, y, U, nullptr, nullptr, st);
      bf16* tmp = x;
      x = y;
      y = tmp;
    }
    mm(XSeg{x, U, U}, none, b(HD), f(HD + 1), s.head, B, NH, 1, st);
    act_kernel<<<(B + 255) / 256, 256, 0, st>>>(
        s.head, NH, (const float*)noise + o * AP, B, adim, AP, disc, minstd,
        maxstd, aseq + o * AP, s.act_in);
    // Action embedding, into the core's input row.
    ns = mm_splits<bf16>(B, A, AP, sms);
    mm(XSeg{s.act_in, AP, AP}, none, b(E), b(E + 1), s.parts, B, A, ns, st);
    finish(s.parts, ns, B, A, A, 1, f(E + 2), f(E + 2), eps, s.x + 2 * H, lx,
           nullptr, nullptr, st);
    // Core, prior and the sample (seq_common.cuh).
    imag_step(core, prior, deter, stoch, s.x, s.h, s.px, s.py, s.parts,
              dseq + o * D, lseq + o * L, (const float*)gum + o * L,
              sseq + o * L, B, D, H, L, A, g, C, sms, eps, unimix, st);
  }
  return (int)cudaGetLastError();
}
