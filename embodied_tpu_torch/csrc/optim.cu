// The optimizer's update over the flat gradient: AGC's per-leaf norms, then
// the RMS and momentum moments and the parameters, in two launches.
//
// Replaces no TPU kernel (ops/optim.py has the note): the JAX package's
// update is XLA's. On an H100 it is bound by bytes: 36 a float32 parameter
// (the norms read g and p; the apply reads g, p, nu and mu and writes p, nu
// and mu): 2.00 ms for the 186,495,540 parameters of the 200M DreamerV3
// optimizer and 4.50 ms for the 418,449,972 of the 400M one at 3.35 TB/s. A
// leaf's offset in the flat gradient has no alignment, so each thread loads
// single floats, a warp's loads on neighbouring addresses, and keeps
// UNROLL of them in flight per tensor. Each block takes one CHUNK (two
// rounds) of one leaf, which its threads find in the table. On the H100,
// UNROLL 16 and CHUNK 8,192 took the pair from 2.86 to 2.29 ms at 200M
// (against UNROLL 4, 8 and 32, 128 and 512 threads, chunks of 4,096 to
// 32,768 and streaming cache hints).
//
// Sums have a fixed order: a block sums its chunk (each thread its elements
// in order, then each warp's butterfly, then the warps in order) into one
// partial, and the last block to finish (counted by an atomic on a counter
// that it leaves at 0 for the next call) adds the partials in chunk order.
// So repeated calls give the same bits.
//
// The elementwise arithmetic goes through the _rn intrinsics, which are
// never contracted into an FMA: each operation rounds once, as the plain
// version's PyTorch operations do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace optim {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 16;
constexpr long long CHUNK = 8192;  // ops/optim.py CHUNK
static_assert(CHUNK % (THREADS * UNROLL) == 0, "a chunk is whole rounds");

// A row of the segment table (ops/optim.py FIELDS, 8 int64).
struct Leaf {
  float* p;
  float* nu;
  float* mu;  // null without momentum
  long long off, n, chunk0, wd, pad;
};
static_assert(sizeof(Leaf) == 64, "ops/optim.py packs 8 int64 a row");

struct Settings {
  int leaves, chunks, momentum, nesterov, scaling, agc_on;
  long long count;
  float agc, pmin, beta1, beta2, omb1, omb2, eps, wd;
};

// Indices into the float32 outputs (ops/optim.py OUTS) and the scalars the
// norms hand the apply.
enum { GRAD_NORM, GRAD_RMS, UPDATE_RMS, PARAM_RMS, UPDATES, PARAM_COUNT,
       GRAD_SCALE, GRAD_OVERFLOW };
enum { FINITE, SCALE, BC1, BC2, NSCAL };

struct Work {
  float2* part;      // [chunks]: a chunk's sums of g^2 and p^2
  float* upart;      // [chunks]: a chunk's sum of the update's squares
  float2* lsum;      // [leaves]: a leaf's sums of g^2 and p^2
  float* factor;     // [leaves]: AGC's factor
  float* scal;       // [NSCAL]
  unsigned* done;    // [2]: blocks finished, one counter a kernel
};

static size_t up(size_t x) { return (x + 255) & ~size_t(255); }

// The workspace's regions from `base` (nullptr: sizes only); returns bytes.
static size_t carve(char* base, int leaves, int chunks, Work* w) {
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + at : nullptr;
    at += up(bytes);
    return p;
  };
  Work x;
  x.part = (float2*)take(sizeof(float2) * chunks);
  x.upart = (float*)take(sizeof(float) * chunks);
  x.lsum = (float2*)take(sizeof(float2) * leaves);
  x.factor = (float*)take(sizeof(float) * leaves);
  x.scal = (float*)take(sizeof(float) * NSCAL);
  x.done = (unsigned*)take(sizeof(unsigned) * 2);
  if (w) *w = x;
  return at;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// The block's sum of v in a fixed order, valid in thread 0.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red's last use is over
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < WARPS; ++i) t = __fadd_rn(t, red[i]);
  return t;
}

// Whether this block finished last of the grid, after publishing its
// partial (written by thread 0 before the call).
__device__ bool finished_last(unsigned* done) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

struct Span {
  Leaf leaf;
  int l;
  long long start, end;
};

// The block's chunk: its leaf is the one whose chunks hold blockIdx.x,
// which the block's threads look for a row each.
__device__ __forceinline__ Span span_of(const Leaf* leaves, int count) {
  __shared__ int found;
  const long long b = blockIdx.x;
  for (int l = threadIdx.x; l < count; l += THREADS) {
    const long long c0 = leaves[l].chunk0;
    if (b >= c0 && b < c0 + (leaves[l].n + CHUNK - 1) / CHUNK) found = l;
  }
  __syncthreads();
  Span s;
  s.l = found;
  s.leaf = leaves[s.l];
  s.start = (blockIdx.x - s.leaf.chunk0) * CHUNK;
  s.end = min(s.leaf.n, s.start + CHUNK);
  return s;
}

// Per chunk, the sums of g^2 (g over the loss scale) and p^2; the last block
// adds them per leaf, then forms the totals, the finite flag, the new loss
// scale, the bias corrections at step + 1, the step and AGC's factors.
__global__ void __launch_bounds__(THREADS)
norms_kernel(const Leaf* leaves, const float* g, int* step,
             float* grad_scale, int* good_steps, Work w, float* out,
             Settings s) {
  __shared__ float red[WARPS];
  const Span sp = span_of(leaves, s.leaves);
  const float* gl = g + sp.leaf.off;
  const float* pl = sp.leaf.p;
  const float scale = s.scaling ? *grad_scale : 1.f;
  float sg = 0.f, sq = 0.f;
  for (long long base = sp.start + threadIdx.x; base < sp.end;
       base += THREADS * UNROLL) {
    float x[UNROLL], q[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = base + k * THREADS;
      x[k] = i < sp.end ? gl[i] : 0.f;
      q[k] = i < sp.end ? pl[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const float y = s.scaling ? __fdiv_rn(x[k], scale) : x[k];
      sg = __fadd_rn(sg, __fmul_rn(y, y));
      sq = __fadd_rn(sq, __fmul_rn(q[k], q[k]));
    }
  }
  const float tg = block_sum(sg, red), tq = block_sum(sq, red);
  if (threadIdx.x == 0) w.part[blockIdx.x] = make_float2(tg, tq);
  if (!finished_last(&w.done[0])) return;

  // Each leaf's sums: a warp a leaf, its lanes over the partials in order.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < s.leaves; l += WARPS) {
    const Leaf leaf = leaves[l];
    const long long n = (leaf.n + CHUNK - 1) / CHUNK;
    float a = 0.f, b = 0.f;
    for (long long i = lane; i < n; i += 32) {
      const float2 v = __ldcg(&w.part[leaf.chunk0 + i]);
      a = __fadd_rn(a, v.x);
      b = __fadd_rn(b, v.y);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) w.lsum[l] = make_float2(a, b);
  }
  __syncthreads();
  __shared__ bool finite;
  if (threadIdx.x == 0) {
    float gsq = 0.f, psq = 0.f;
    for (int l = 0; l < s.leaves; ++l) {
      gsq = __fadd_rn(gsq, w.lsum[l].x);
      psq = __fadd_rn(psq, w.lsum[l].y);
    }
    // The plain version zeroes an overflowing gradient before its sums.
    finite = !s.scaling || isfinite(gsq);
    if (!finite) gsq = 0.f;
    const float count = (float)s.count;
    out[GRAD_NORM] = __fsqrt_rn(gsq);
    out[GRAD_RMS] = __fsqrt_rn(__fdiv_rn(gsq, count));
    out[PARAM_RMS] = __fsqrt_rn(__fdiv_rn(psq, count));
    out[PARAM_COUNT] = count;
    const int now = *step;
    const float next = __fadd_rn((float)now, 1.f);
    out[UPDATES] = next;
    w.scal[FINITE] = finite ? 1.f : 0.f;
    w.scal[BC1] = __fsub_rn(1.f, powf(s.beta1, next));
    w.scal[BC2] = __fsub_rn(1.f, powf(s.beta2, next));
    *step = now + (finite ? 1 : 0);
    w.scal[SCALE] = scale;
    if (s.scaling) {
      out[GRAD_SCALE] = scale;
      out[GRAD_OVERFLOW] = finite ? 0.f : 1.f;
      const int good = *good_steps;
      const bool keep = finite && good < 1000, incr = finite && good >= 1000;
      *good_steps = finite ? good + 1 : 0;
      float grown = incr ? __fmul_rn(scale, 2.f)
                         : keep ? scale : __fdiv_rn(scale, 2.f);
      grown = grown < 1e-4f ? 1e-4f : grown;
      *grad_scale = grown > 1e5f ? 1e5f : grown;
    }
    w.done[0] = 0;
  }
  __syncthreads();
  // AGC: 1 / max(|g| / (agc max(|p|, pmin)), 1) per leaf; 1 where the
  // gradient overflowed (the plain version's zeroed gradient gives 1).
  for (int l = threadIdx.x; l < s.leaves; l += THREADS) {
    float f = 1.f;
    if (s.agc_on && finite) {
      const float un = __fsqrt_rn(w.lsum[l].x), pn = __fsqrt_rn(w.lsum[l].y);
      const float upper = __fmul_rn(s.agc, pn < s.pmin ? s.pmin : pn);
      const float r = __fdiv_rn(un, upper);
      f = __fdiv_rn(1.f, r < 1.f ? 1.f : r);
    }
    w.factor[l] = f;
  }
}

// One pass over the elements: the clipped gradient, the moments, weight
// decay, -lr and the parameter (only where finite); the update's squares
// in chunk partials, which the last block adds in order.
__global__ void __launch_bounds__(THREADS)
apply_kernel(const Leaf* leaves, const float* g, const float* lr, Work w,
             float* out, Settings s) {
  __shared__ float red[WARPS];
  const Span sp = span_of(leaves, s.leaves);
  const float* gl = g + sp.leaf.off;
  float* pl = sp.leaf.p;
  float* nul = sp.leaf.nu;
  float* mul = sp.leaf.mu;
  const bool finite = w.scal[FINITE] != 0.f;
  const float scale = w.scal[SCALE], bc1 = w.scal[BC1], bc2 = w.scal[BC2];
  const float factor = w.factor[sp.l];
  const float nlr = -*lr;
  const bool decay = sp.leaf.wd != 0;
  float su = 0.f;
  for (long long base = sp.start + threadIdx.x; base < sp.end;
       base += THREADS * UNROLL) {
    float x[UNROLL], p[UNROLL], v[UNROLL], m[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = base + k * THREADS;
      const bool in = i < sp.end;
      x[k] = in ? gl[i] : 0.f;
      p[k] = in ? pl[i] : 0.f;
      v[k] = in ? nul[i] : 0.f;
      m[k] = in && s.momentum ? mul[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long i = base + k * THREADS;
      float y = s.scaling ? __fdiv_rn(x[k], scale) : x[k];
      y = finite ? __fmul_rn(y, factor) : 0.f;
      const float nv = __fadd_rn(__fmul_rn(s.beta2, v[k]),
                                 __fmul_rn(s.omb2, __fmul_rn(y, y)));
      float u = __fdiv_rn(
          y, __fadd_rn(__fsqrt_rn(__fdiv_rn(nv, bc2)), s.eps));
      float nm = 0.f;
      if (s.momentum) {
        nm = __fadd_rn(__fmul_rn(s.beta1, m[k]), __fmul_rn(s.omb1, u));
        const float mm = s.nesterov ? __fadd_rn(__fmul_rn(s.beta1, nm),
                                                __fmul_rn(s.omb1, u))
                                    : nm;
        u = __fdiv_rn(mm, bc1);
      }
      if (decay) u = __fadd_rn(u, __fmul_rn(s.wd, p[k]));
      const float d = __fmul_rn(nlr, u);
      if (i < sp.end) {
        nul[i] = nv;
        if (s.momentum) mul[i] = nm;
        if (finite) pl[i] = __fadd_rn(p[k], d);
        su = __fadd_rn(su, __fmul_rn(d, d));
      }
    }
  }
  const float t = block_sum(su, red);
  if (threadIdx.x == 0) w.upart[blockIdx.x] = t;
  if (!finished_last(&w.done[1])) return;
  float a = 0.f;
  for (int c = threadIdx.x; c < s.chunks; c += THREADS)
    a = __fadd_rn(a, __ldcg(&w.upart[c]));
  const float usq = block_sum(a, red);
  if (threadIdx.x == 0) {
    out[UPDATE_RMS] = __fsqrt_rn(__fdiv_rn(usq, (float)s.count));
    w.done[1] = 0;
  }
}

}  // namespace optim

extern "C" size_t optim_workspace(int leaves, int chunks) {
  return optim::carve(nullptr, leaves, chunks, nullptr);
}

// table: `leaves` rows of 8 int64 (ops/optim.py FIELDS), whose chunks
// number `chunks`; g: the flat float32 gradient; lr: float32
// scalar; step: int32 scalar; grad_scale (float32) and good_steps (int32):
// the loss scale's state, null without scaling; workspace: optim_workspace
// bytes, zeroed before the first call; out: float32 [8] (ops/optim.py
// OUTS).
extern "C" int optim_update(
    const void* table, const void* g, const void* lr,
    void* step, void* grad_scale, void* good_steps, void* workspace,
    void* out, int leaves, int chunks, int momentum, int nesterov,
    int scaling, int agc_on, long long count, float agc, float pmin,
    float beta1, float beta2, float omb1, float omb2, float eps, float wd,
    void* stream) {
  using namespace optim;
  cudaStream_t st = (cudaStream_t)stream;
  const Settings s{leaves, chunks, momentum, nesterov, scaling, agc_on,
                   count, agc, pmin, beta1, beta2, omb1, omb2, eps, wd};
  Work w;
  carve((char*)workspace, leaves, chunks, &w);
  const Leaf* rows = (const Leaf*)table;
  norms_kernel<<<chunks, THREADS, 0, st>>>(
      rows, (const float*)g, (int*)step, (float*)grad_scale,
      (int*)good_steps, w, (float*)out, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_kernel<<<chunks, THREADS, 0, st>>>(
      rows, (const float*)g, (const float*)lr, w, (float*)out, s);
  return (int)cudaGetLastError();
}
