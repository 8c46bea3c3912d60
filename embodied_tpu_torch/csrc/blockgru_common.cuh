// Stage kernels of the block-GRU core step and the posterior head, shared
// by every kernel of the port: blockgru.cu and observe.cu (one step), and
// through seq_common.cuh observe_seq.cu and imagine_seq.cu (whole windows).
//
// Replaces the core of the Pallas TPU kernels embodied_tpu/ops/blockgru.py
// (_kernel) and embodied_tpu/ops/observe.py (_obs_kernel). It computes the
// same function, not the same blocks: the TPU kernel keeps all weights in
// VMEM and runs one unrolled matmul per GRU block; here the step is a short
// chain of launches, one per matmul stage, with a `finish` launch after
// each stage whose output goes through an RMS norm:
//
//   in_proj  pre = [deter @ w0 + b0, stoch @ w1 + b1]          (B, 2H) f32
//   finish   x[:, :2H] = bf16(silu(rms(pre half) * s0 | s1))
//   hidden   hpre = blockdiag(deter, wblk) + bblk + x @ win     (B, D) f32
//            (x = [xd, x0, act], the action in its last A columns)
//   finish   h = bf16(silu(rms(hpre) * sh))                      (B, D) bf16
//   gru      gates = blockdiag(h, wg) + bg, then
//            deter' = u * tanh(r * c) + (1 - u) * deter          (B, D) bf16
//
// and for the posterior head (post_head):
//
//   post     preo = new @ wo[:D] + tok @ wo[D:] + bo                (B, H)
//   finish   xo = bf16(silu(rms(preo) * so))
//   logits   logit = xo @ wl + bl                   (B, L) bf16 or f32
//
// Bound on an H100: at acting batch (B = 16) a step reads each weight byte
// once and does 2 B = 32 flops per bf16 weight (16 per byte), far below the
// ~295 per byte the card needs to be bound by operations, so the bound is
// bytes (weights over 3.35 TB/s). What the design does about it: below
// MMA_ROWS rows every bf16 product runs on the 16-row tensor-core stage
// (tc16_kernel: mma.sync m16n8k16, whose 16 rows are the batch, one
// 16 x 64 output tile per block, the weight tile streamed through a ring
// of cp.async stages and read once per row tile). A stage with few output
// tiles (the input projection has 32 at the default dims, the posterior
// head 16) would leave most of the 132 SMs idle while a few blocks walk K
// thousands deep, so the contraction is split (split-K, grid z): every
// split writes its own f32 partial sums and the consumer adds them in a
// fixed order, so the result does not depend on scheduling. The split
// count follows the batch and the SM count (`tc_splits`).
//
// From MMA_ROWS (128) rows on, operations bind (B = 1024: about 9 GFLOP per
// size12m core step against 18 MB; the default rollout step 191 GFLOP
// against 190 MB). Every bf16 product there runs on the 128-row stage
// (tc128_kernel): Hopper's wgmma, two warpgroups per 128 x 256 output
// tile, both operands fed by TMA into a ring of swizzled shared-memory
// stages, split-K only where the tiles are fewer than the SMs. Its notes
// below give the design and what is left for later. The action head's 16
// or 32 columns stay on the FMA stages (tile_mm: one output per thread,
// 16 x 16 tiles).
//
// The FMA stages take their weight matrices in bf16 or in int8 (the
// template parameter W): int8 weights (qcore.cu) carry per-output-column
// f32 scales, which each stage applies to its (B, cols) sums, split by
// split, before split 0 adds the bias. The scale is linear, so the splits'
// sum is the scaled product, up to f32 rounding. The tensor cores take
// bf16 weights only; int8 weights run the FMA stages at every batch.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace blockgru {

typedef __nv_bfloat16 bf16;

constexpr int TM = 16;            // rows per block
constexpr int TN = 16;            // output columns per block
constexpr int KC = 128;           // contraction chunk staged in shared memory
constexpr int THREADS = TM * TN;  // one output (row, column) per thread
constexpr int FIN_THREADS = 256;  // threads of a finish block (one row)

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// v times the column scale scale[col], or v where there is no scale (bf16
// weights).
__device__ __forceinline__ float scaled(float v, const float* scale,
                                        size_t col) {
  return scale ? v * scale[col] : v;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

// Sum of `v` over the block (FIN_THREADS threads); every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < FIN_THREADS / 32; ++i) total += red[i];
  return total;
}

// Bump allocator over one device workspace. With base == nullptr it only
// counts, so the size query and the launch carve the same layout.
struct Arena {
  char* base;
  size_t used;
  template <class T>
  T* take(size_t n) {
    const size_t at = (used + 255) & ~size_t(255);
    used = at + n * sizeof(T);
    return base ? reinterpret_cast<T*>(base + at) : nullptr;
  }
};

// `want` parts, at least 1 and at most one per chunk of a K-deep
// contraction.
inline int clamp_splits(int want, int K, int chunk) {
  const int most = (K + chunk - 1) / chunk;
  return want < most ? (want > 1 ? want : 1) : (most > 1 ? most : 1);
}

// The FMA stages: enough 16 x 16 tiles times parts for two blocks per SM,
// and at least one 128-deep chunk per part; 1 when the batch alone gives
// enough tiles.
inline int fma_splits(int cols, int B, int K, int sms) {
  const int tiles = (cols / TN) * ((B + TM - 1) / TM);
  return clamp_splits((2 * sms + tiles - 1) / tiles, K, KC);
}

// The 16-row tensor-core stage (tc16_kernel below): enough 16 x TC_BN
// tiles times parts for two blocks per SM, and at least one TC_BK-deep
// chunk per part. N columns in groups of gN; a tile never straddles a
// group.
constexpr int TC_BN = 64, TC_BK = 64;
inline int tc_splits(int N, int gN, int B, int K, int sms) {
  const int tiles = (N / gN) * ((gN + TC_BN - 1) / TC_BN) * ((B + 15) / 16);
  return clamp_splits((2 * sms + tiles - 1) / tiles, K, TC_BK);
}

// The 128-row tensor-core stage (tc128_kernel below): a block of
// T128_BM / 64 warpgroups owns a T128_BM x T128_BN output tile.
constexpr int T128_BM = 128, T128_BN = 256, T128_BK = 64, T128_STAGES = 4;
constexpr int T128_THREADS = T128_BM / 64 * 128;  // a warpgroup per 64 rows
constexpr int T128_XBYTES = T128_BM * T128_BK * 2;  // 16 KB of X a chunk
constexpr int T128_WBYTES = T128_BK * T128_BN * 2;  // 32 KB of W a chunk
constexpr int T128_STAGE = T128_XBYTES + T128_WBYTES;
// The ring, its barriers and the slack to align it to 1 KB.
constexpr int T128_SMEM = T128_STAGES * (T128_STAGE + 8) + 1024;

// With fewer tiles than SMs, as many parts as fill the SMs once, each at
// least four 64-deep chunks deep; 1 from one tile per SM on. The count
// never grows with the tiles, so a grouped product (at least as many tiles
// as the dense one of its width) takes no more parts than most_splits
// gives.
inline int tc128_splits(int N, int gN, int B, int K, int sms) {
  const int tiles = (N / gN) * ((gN + T128_BN - 1) / T128_BN) *
                    ((B + T128_BM - 1) / T128_BM);
  return clamp_splits(sms / tiles, K, 4 * 64);
}

// The most parts any rule gives a dense product: what a buffer of split
// partials is sized for (a grouped product has at least as many tiles, so
// no more parts).
inline int most_splits(int N, int B, int K, int sms) {
  const int a = fma_splits(N, B, K, sms), b = tc_splits(N, N, B, K, sms);
  const int c = tc128_splits(N, N, B, K, sms);
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

inline dim3 grid_for(int cols, int B, int ns = 1) {
  return dim3(cols / TN, (B + TM - 1) / TM, ns);
}

// X(row, k) = x[row * ld + k] for a bf16 matrix.
struct LoadBf16 {
  const bf16* x;
  int ld;
  __device__ float operator()(int row, int k) const {
    return to_f(x[(size_t)row * ld + k]);
  }
};

// The 16 / sizeof(W) weights at p (16-byte aligned) as floats, from one
// 16-byte load: 8 bf16 or 16 int8 values. An int8 value is exact in float
// (|q| <= 127), so the product's sum sees the stored integers.
template <class W>
__device__ __forceinline__ void load16(const W* p, float* dst) {
  constexpr int V = 16 / sizeof(W);
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const W* e = reinterpret_cast<const W*>(&v);
#pragma unroll
  for (int q = 0; q < V; ++q) dst[q] = to_f(e[q]);
}

// Split z of a contraction of depth K cut into ns nearly equal parts.
__device__ __forceinline__ void split_range(int K, int ns, int z, int* lo,
                                            int* hi) {
  *lo = (int)((long long)K * z / ns);
  *hi = (int)((long long)K * (z + 1) / ns);
}

// --- FMA products (int8 weights; narrow stages from MMA_ROWS rows on) -------

// acc[j] += sum_k X(row, k) * W_j[k, c] over k in [lo, hi), for the
// thread's (row, c) of the tile. W_j = w + j * wstep points at column 0 of
// the tile in a row-major bf16 or int8 matrix with row stride ldw. The NW
// weight tiles share the staged input chunk. Requires ldw and the tile's
// column offset to be multiples of 16 / sizeof(W) and w 16-byte aligned
// (16-byte loads); the wrapper checks the shapes. All threads of the
// block must call it alike.
template <int NW, class Loader, class W>
__device__ void tile_mm(float (&acc)[NW], const Loader& load, int lo, int hi,
                        const W* w, int wstep, int ldw, int row0, int B,
                        float* xs, float* ws) {
  // V weights per 16-byte load, P loads per staged row of the tile.
  constexpr int V = 16 / sizeof(W), P = TN / V;
  const int t = threadIdx.x, r = t / TN, c = t % TN;
  for (int k0 = lo; k0 < hi; k0 += KC) {
    for (int i = t; i < TM * KC; i += THREADS) {
      const int rr = i / KC, kk = i % KC;
      const int row = row0 + rr, k = k0 + kk;
      xs[i] = (row < B && k < hi) ? load(row, k) : 0.f;
    }
    for (int i = t; i < NW * KC * P; i += THREADS) {
      const int j = i / (KC * P), rem = i % (KC * P);
      const int kk = rem / P, part = rem % P, k = k0 + kk;
      float* dst = ws + (j * KC + kk) * TN + part * V;
      if (k < hi) {
        load16(w + (size_t)j * wstep + (size_t)k * ldw + part * V, dst);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) dst[q] = 0.f;
      }
    }
    __syncthreads();
    const float* xr = xs + r * KC;
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float x = xr[kk];
#pragma unroll
      for (int j = 0; j < NW; ++j) acc[j] += x * ws[(j * KC + kk) * TN + c];
    }
    __syncthreads();
  }
}

// The part of segment [seg, seg + len) of a concatenated contraction that
// falls in this split's [lo, hi): X and W are indexed from the segment's
// start. The condition is the same for every thread of the block.
template <class Loader, class W>
__device__ void segment_mm(float (&acc)[1], const Loader& load, int seg,
                           int len, int lo, int hi, const W* w, int ldw,
                           int row0, int B, float* xs, float* ws) {
  const int a = max(lo - seg, 0), b = min(hi - seg, len);
  if (a < b) tile_mm<1>(acc, load, a, b, w, 0, ldw, row0, B, xs, ws);
}

// --- Tensor-core helpers ----------------------------------------------------

// From MMA_ROWS rows on, the forward products take the 128-row tensor-core
// stage (tc128_kernel); below, the 16-row stage (tc16_kernel).
constexpr int MMA_ROWS = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8 i .. 8 i + 7 giving
// the row addresses of matrix i; with `trans`, each matrix transposed.
template <bool trans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (trans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem(p)));
  }
}

// 16 bytes from global to shared memory, asynchronously; the first
// `bytes` come from src and the rest are zeros (bytes = 0: all zeros, src
// unread but valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Eight f32 values at p (16-byte aligned) rounded to bf16, as one 16-byte
// store to shared memory at dst; zeros where !ok.
__device__ __forceinline__ void store8_bf16(bf16* dst, const float* p,
                                            bool ok) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (ok) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __align__(16) __nv_bfloat162 v[4] = {__floats2bfloat162_rn(a.x, a.y),
                         __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y),
                         __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// --- Tensor-core products at 16 rows (below MMA_ROWS) -----------------------
//
// mma.sync m16n8k16 takes 16 rows, the acting and window batch exactly.
// A block computes one 16 x TC_BN output tile over its split's part of the
// contraction: the four warps own 16 columns each (two n8 tiles), and all
// of them read the tile's 16 staged rows. Weight tiles (TC_BK x TC_BN bf16,
// 8 KB) stream through a ring of TC_STAGES shared-memory stages filled by
// 16-byte cp.async loads, so three chunks are in flight while one is
// multiplied; fragments come from ldmatrix. The products are bound by the
// weight bytes, so the split count (tc_splits) keeps about two blocks per
// SM streaming, and every split writes its own f32 partials (`parts` in the
// FMA stages' layout), which the consumer adds in split order.
//
// The forward product (trans = false) reads X (bf16) against W (K x N,
// row-major: its tile is staged [k][n] and read by ldmatrix.trans); the
// transposed product of the backward (trans = true) reads Y (f32, staged
// as it lies and rounded to bf16 as its fragments are formed: the dY
// operand in the compute dtype) against the rows of W, contiguous along k
// (staged [n][k], plain ldmatrix). The ring takes 46 KB of shared memory,
// 55 KB with f32 rows, so four blocks fit an SM.

constexpr int TC_STAGES = 4, TC_THREADS = 128, TC_PAD = TC_BK + 8;

// One operand pair of a 16-row product. Output column n lies in group
// q = n / gN at offset j = n - q gN; the segment adds, over k < len,
//   X(row, k) = x[row * ldx + q * xgs + k]      (bf16; f32 if trans)
// times
//   w[q * wgs + k * ldw + j]                    (forward)
//   w[q * wgs + j * ldw + k]                    (trans)
// len, ldx, xgs, ldw and wgs are multiples of 8 and gN of 16 (16-byte
// loads); the wrappers check the widths.
struct Opnd {
  const void* x;
  int ldx;
  int xgs;
  const bf16* w;
  int ldw;
  size_t wgs;
  int len;
};

inline Opnd no_opnd() { return Opnd{nullptr, 0, 0, nullptr, 0, 0, 0}; }

template <bool trans>
struct TcStage {
  // The rows, [row][k]: bf16, or f32 for trans, staged as they lie and
  // rounded to bf16 as the fragments are formed.
  typename std::conditional<trans, float, bf16>::type x[16][TC_PAD];
  bf16 w[TC_BK][TC_PAD];  // [k][n] forward, [n][k] trans
};

// Stage chunk [k0, k0 + TC_BK) of segment o for the tile at column j0 of
// group q (`valid` columns of it inside the group), rows row0.. < B;
// zeros outside, all by 16-byte cp.async. Rows padded by 8 values (144
// bytes of bf16, 288 of f32) keep the 16-byte stores aligned, an
// ldmatrix's eight rows on distinct banks, and the f32 fragment loads of
// each half-warp on distinct banks.
template <bool trans>
__device__ __forceinline__ void tc_stage(TcStage<trans>& s, const Opnd& o,
                                         int k0, int q, int j0, int valid,
                                         int row0, int B) {
  const int t = threadIdx.x;
  const bf16* W = o.w + (size_t)q * o.wgs;
#pragma unroll
  for (int j = 0; j < TC_BK * TC_BN / 8 / TC_THREADS; ++j) {
    const int i = t + j * TC_THREADS;
    const int r = i / (TC_BN / 8), c = (i % (TC_BN / 8)) * 8;
    const bool ok = trans ? (r < valid && k0 + c < o.len)
                          : (k0 + r < o.len && c < valid);
    const bf16* src = trans ? W + (size_t)(j0 + r) * o.ldw + k0 + c
                            : W + (size_t)(k0 + r) * o.ldw + j0 + c;
    cp_async16(&s.w[r][c], ok ? src : o.w, ok ? 16 : 0);
  }
  // 16 rows of TC_BK, 16 bytes a load: 8 bf16 or 4 f32 values.
  constexpr int V = 16 / sizeof(s.x[0][0]);
#pragma unroll
  for (int j = 0; j < 16 * TC_BK / V / TC_THREADS; ++j) {
    const int i = t + j * TC_THREADS;
    const int r = i / (TC_BK / V), c = (i % (TC_BK / V)) * V;
    const bool ok = row0 + r < B && k0 + c < o.len;
    const size_t at =
        (size_t)(row0 + r) * o.ldx + (size_t)q * o.xgs + k0 + c;
    const void* src = trans ? (const void*)((const float*)o.x + at)
                            : (const void*)((const bf16*)o.x + at);
    cp_async16(&s.x[r][c], ok ? src : o.w, ok ? 16 : 0);
  }
}

// The A fragment of rows (g, g + 8) and columns (k + 2 tq, + 8) from f32
// rows, rounded to bf16 (the dY operand in the compute dtype).
__device__ __forceinline__ uint32_t bf16x2(const float* p) {
  __nv_bfloat162 h = __float22bfloat162_rn(*reinterpret_cast<const float2*>(p));
  return *reinterpret_cast<uint32_t*>(&h);
}

// out[z][row, n] (row stride ldo, split stride B ldo): split z of the
// products of segments a and b (b.len may be 0) for n < N, plus bias[n]
// (bf16 or f32, optional) in split 0. Every split writes, an empty one
// zeros. Grid ((N / gN) ceil(gN / TC_BN), ceil(B / 16), ns); the
// contraction is cut into TC_BK chunks, a's then b's, and split z takes
// its share of them in order. Fragment layouts: PTX's mma.m16n8k16.
template <bool trans, class Bias, class Out>
__global__ void __launch_bounds__(TC_THREADS)
tc16_kernel(Opnd a, Opnd b, int gN, const Bias* bias, Out* out, int ldo,
            int B, int ns) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  TcStage<trans>* s = reinterpret_cast<TcStage<trans>*>(tc_smem);
  const int tpg = (gN + TC_BN - 1) / TC_BN;
  const int q = blockIdx.x / tpg, j0 = (blockIdx.x % tpg) * TC_BN;
  const int valid = min(TC_BN, gN - j0);
  const int row0 = blockIdx.y * 16, z = blockIdx.z;
  const int ca = (a.len + TC_BK - 1) / TC_BK, cb = (b.len + TC_BK - 1) / TC_BK;
  int lo, hi;
  split_range(ca + cb, ns, z, &lo, &hi);
  const int n = hi - lo;
  auto stage = [&](int i) {
    const int c = lo + i;
    if (c < ca)
      tc_stage<trans>(s[i % TC_STAGES], a, c * TC_BK, q, j0, valid, row0, B);
    else
      tc_stage<trans>(s[i % TC_STAGES], b, (c - ca) * TC_BK, q, j0, valid,
                      row0, B);
  };
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < n) stage(i);
    cp_commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = lane / 8, l8 = lane % 8, nb = warp * 16;
  const int g = lane / 4, tq = lane % 4;
  float acc[2][4] = {};
  for (int i = 0; i < n; ++i) {
    cp_wait<TC_STAGES - 2>();  // chunk i has landed
    __syncthreads();           // and every warp is done with chunk i - 1
    if (i + TC_STAGES - 1 < n) stage(i + TC_STAGES - 1);
    cp_commit();
    const TcStage<trans>& c = s[i % TC_STAGES];
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t af[4], bfr[4];
      if constexpr (trans) {
        const float* x0 = &c.x[g][kk + 2 * tq];
        const float* x1 = &c.x[g + 8][kk + 2 * tq];
        af[0] = bf16x2(x0);
        af[1] = bf16x2(x1);
        af[2] = bf16x2(x0 + 8);
        af[3] = bf16x2(x1 + 8);
        ldsm4<false>(bfr, &c.w[nb + (m >> 1) * 8 + l8][kk + (m & 1) * 8]);
      } else {
        ldsm4<false>(af, &c.x[(m & 1) * 8 + l8][kk + (m >> 1) * 8]);
        ldsm4<true>(bfr, &c.w[kk + (m & 1) * 8 + l8][nb + (m >> 1) * 8]);
      }
      mma_bf16(acc[0], af[0], af[1], af[2], af[3], bfr[0], bfr[1]);
      mma_bf16(acc[1], af[0], af[1], af[2], af[3], bfr[2], bfr[3]);
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + h * 8;
      if (row >= B) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = nb + nt * 8 + tq * 2 + e;
        if (cl >= valid) continue;
        const int col = q * gN + j0 + cl;
        const float add = (z == 0 && bias) ? to_f(bias[col]) : 0.f;
        store(out + ((size_t)z * B + row) * ldo + col,
              acc[nt][h * 2 + e] + add);
      }
    }
  }
}


// --- Tensor-core products from MMA_ROWS rows on (wgmma) ---------------------
//
// Replaces, with the stages around it, the products of the Pallas TPU
// kernel embodied_tpu/ops/imagine_seq.py:fused_imagine_seq (and of
// fused_core_step and fused_imag_step at 1,024 rows). At 128 rows and more
// the products are bound by operations: a rollout step at the default dims
// does 191 GFLOP against some 190 MB of weights, a thousand flops per
// byte, above the ~295 per byte where the H100 stops being bound by
// memory. So the stage is built for the tensor cores' rate: Hopper's
// warpgroup products (wgmma.mma_async m64n256k16, bf16 operands, f32 sums
// in registers), which read both operands from shared memory.
//
// A block of two warpgroups owns one 128 x 256 output tile (64 rows each)
// over its split's part of the contraction, cut into 64-deep chunks. Each
// chunk stages the X tile (128 rows x 64 k, K contiguous) and the W tile
// (64 k x 256 columns, as W lies: N contiguous, four 64-column atoms) in
// the 128-byte swizzled layout that wgmma reads through its descriptors:
// rows of 128 bytes, the 16-byte piece c of row r stored at c ^ (r % 8),
// atoms of 8 rows aligned to 1,024 bytes. X is K-major; W is read through
// wgmma's transpose bit (MN-major), so it needs no copy. One thread fills a
// ring of T128_STAGES chunks (48 KB each) by TMA, whose tensor maps zero
// what lies outside the operands (ragged rows, columns and depths) and
// complete on one mbarrier per slot; T128_STAGES - 2 chunks are in flight
// while one is multiplied and the one before it drains, and a block
// barrier per chunk frees the slot the next load refills.
//
// Tiles run row tile fastest, so the blocks that share a W tile run
// together and read it from device memory about once. A product with fewer
// tiles than SMs (1,024 columns at 1,024 rows make 32) splits its
// contraction (tc128_splits) into parts that each write f32 partial sums,
// which the consumer (finish, gru_update) adds in split order; no atomics,
// so two calls give the same bits.
//
// Later work: one persistent launch per product whose blocks walk the
// tiles (the next tile's loads under this one's epilogue), a producer warp
// instead of the block barrier, and the GRU update fused into the gates'
// epilogue (their f32 pre-activations, 100 MB per default step, now go
// through device memory).

// A wgmma shared-memory descriptor of the 128-byte swizzle: the start
// address, the leading and stride byte offsets (16-byte units) and the
// layout (1 = 128-byte swizzle, bits 62-63).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d += A (64 x 16, K-major) B (16 x N, MN-major) for the warpgroup:
// wgmma.mma_async m64nNk16, N / 2 f32 sums per thread (N = T128_BN).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db);

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One operand pair of the 128-row stage, as TMA sees it: `x` and `w` are
// 3-D tensor maps (built by t128_seg on the host) whose boxes are one
// chunk of the X tile (64 k x 1 x T128_BM rows) and one 64-column atom of
// the W tile (64 columns x 64 k, or 64 x 1 x 64 for a w with its groups
// side by side in the rows). The coordinates of chunk k0 of group q at
// column j and rows row0..:
//   X (k0, xq ? q : 0, row0)
//   W (j, k0, q), or with wcol (j, q, k0).
struct T128Seg {
  CUtensorMap x, w;
  int len, xq, wcol;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(bar)));
}

// Waits until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A TMA load of one box of `map` at (c0, c1, c2) into shared memory at
// dst, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem(dst)),
      "l"((uint64_t)map), "r"(smem(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One thread: stage chunk [k0, k0 + T128_BK) of segment o for the tile at
// column j0 of group q, rows row0.., into the ring slot s (X at s, W's
// 64-column atoms from s + T128_XBYTES, 8 KB apart), and arm the slot's
// barrier for its bytes. TMA writes the 128-byte swizzle and zeros outside
// the operands (ragged rows, columns and depths).
__device__ __forceinline__ void t128_stage(unsigned char* s, uint64_t* bar,
                                           const T128Seg& o, int k0, int q,
                                           int j0, int row0) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem(bar)),
      "r"(T128_STAGE)
      : "memory");
  tma_load(s, &o.x, bar, k0, o.xq ? q : 0, row0);
#pragma unroll
  for (int h = 0; h < T128_BN / 64; ++h) {
    unsigned char* d = s + T128_XBYTES + h * (T128_BK * 128);
    if (o.wcol)
      tma_load(d, &o.w, bar, j0 + h * 64, q, k0);
    else
      tma_load(d, &o.w, bar, j0 + h * 64, k0, q);
  }
}

// out[z][row, n] (row stride ldo, split stride B ldo): split z of the
// products of segments a and b (b.len may be 0) for n < N, plus bias[n]
// (bf16 or f32, optional) in split 0. Every split writes, an empty one
// zeros. Grid (ceil(B / T128_BM), (N / gN) ceil(gN / T128_BN), ns); the
// contraction is cut into T128_BK chunks, a's then b's, and split z takes
// its share of them in order. Accumulator layout: PTX's wgmma m64nNk16 D
// fragments (warp w of the warpgroup holds its rows 16 w .. 16 w + 15).
template <class Bias, class Out>
__global__ void __launch_bounds__(T128_THREADS)
tc128_kernel(const __grid_constant__ T128Seg a,
             const __grid_constant__ T128Seg b, int gN, const Bias* bias,
             Out* out, int ldo, int B, int ns) {
  extern __shared__ __align__(128) unsigned char t128_smem[];
  unsigned char* ring = t128_smem + ((1024 - (smem(t128_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T128_STAGES * T128_STAGE);
  const int tpg = (gN + T128_BN - 1) / T128_BN;
  const int q = blockIdx.y / tpg, j0 = (blockIdx.y % tpg) * T128_BN;
  const int valid = min(T128_BN, gN - j0);
  const int row0 = blockIdx.x * T128_BM, z = blockIdx.z;
  const int ca = (a.len + T128_BK - 1) / T128_BK;
  const int cb = (b.len + T128_BK - 1) / T128_BK;
  int lo, hi;
  split_range(ca + cb, ns, z, &lo, &hi);
  const int n = hi - lo;
  const bool producer = threadIdx.x == 0;
  // Chunk i of the split into its slot, by the producer thread.
  auto stage = [&](int i) {
    const int c = lo + i, slot = i % T128_STAGES;
    unsigned char* s = ring + slot * T128_STAGE;
    if (c < ca)
      t128_stage(s, full + slot, a, c * T128_BK, q, j0, row0);
    else
      t128_stage(s, full + slot, b, (c - ca) * T128_BK, q, j0, row0);
  };
  if (producer) {
#pragma unroll
    for (int i = 0; i < T128_STAGES; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
#pragma unroll
    for (int i = 0; i < T128_STAGES - 2; ++i)
      if (i < n) stage(i);
  }
  const int wg = threadIdx.x / 128;
  float acc[T128_BN / 2];
#pragma unroll
  for (int i = 0; i < T128_BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    // Both warpgroups are done with chunk i - 2, whose slot the producer
    // refills.
    __syncthreads();
    if (producer && i + T128_STAGES - 2 < n) stage(i + T128_STAGES - 2);
    mbar_wait(full + i % T128_STAGES, (i / T128_STAGES) & 1);  // chunk i in
    const uint32_t sx = smem(ring + (i % T128_STAGES) * T128_STAGE);
    const uint32_t sa = sx + wg * (64 * 128), sb = sx + T128_XBYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < T128_BK / 16; ++kk) {
      // A: 16 k = 32 bytes along its swizzled rows, atoms of 8 rows 1 KB
      // apart. B: 16 k rows = 2 KB down, 8-row atoms 1 KB apart, the
      // 64-column atoms 8 KB apart.
      wgmma<T128_BN>(acc, gmma_desc(sa + kk * 32, 16, 1024),
                     gmma_desc(sb + kk * 2048, T128_BK * 128, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = row0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < T128_BN / 8; ++j) {
    const int cl = j * 8 + (lane % 4) * 2;
    if (cl >= valid) continue;  // valid is a multiple of 8
    const int col = q * gN + j0 + cl;
    float b0 = 0.f, b1 = 0.f;
    if (z == 0 && bias) {
      b0 = to_f(bias[col]);
      b1 = to_f(bias[col + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + h * 8;
      if (row < B)
        store2(out + ((size_t)z * B + row) * ldo + col,
               acc[j * 4 + h * 2] + b0, acc[j * 4 + h * 2 + 1] + b1);
    }
  }
}

}  // namespace blockgru

namespace {
// Whether this library has allowed an instantiation of tc16_kernel its
// dynamic shared memory. Internal linkage: each library (each .cu) sets
// the attribute of its own copy of the kernel. A function-local static of
// an inline function would be one object for the whole process (GCC makes
// it a unique symbol across shared libraries), and the second library's
// kernel would launch without the attribute.
template <bool trans, class Bias, class Out>
bool tc16_allowed = false;
// The same for tc128_kernel.
template <class Bias, class Out>
bool tc128_allowed = false;

// The driver's cuTensorMapEncodeTiled, reached through the runtime (the
// libraries do not link the driver library), once per library.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;
}  // namespace

namespace blockgru {

template <bool trans, class Bias, class Out>
inline void tc16(Opnd a, Opnd b, int gN, const Bias* bias, Out* out, int ldo,
                 int B, int N, int ns, cudaStream_t st) {
  // The ring exceeds the 48 KB of static shared memory with f32 rows: the
  // kernel takes it dynamically, allowed once per instantiation (the port
  // runs on one card; a repeated call is harmless).
  constexpr int bytes = TC_STAGES * sizeof(TcStage<trans>);
  if (!tc16_allowed<trans, Bias, Out>) {
    cudaFuncSetAttribute(tc16_kernel<trans, Bias, Out>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    tc16_allowed<trans, Bias, Out> = true;
  }
  const dim3 grid((N / gN) * ((gN + TC_BN - 1) / TC_BN), (B + 15) / 16, ns);
  tc16_kernel<trans, Bias, Out><<<grid, TC_THREADS, bytes, st>>>(
      a, b, gN, bias, out, ldo, B, ns);
}

// A 3-D bf16 tensor map of dims d0, d1, d2 (innermost first, d0
// contiguous) with byte strides s1, s2 and boxes b0 x b1 x b2, in the
// 128-byte swizzle, zeros out of bounds. False where the driver refuses.
inline bool tmap3(CUtensorMap* m, const void* base, uint64_t d0, uint64_t d1,
                  uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b0,
                  uint32_t b1, uint32_t b2) {
  if (!encode_tiled) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
#endif
    if (!fn || found != cudaDriverEntryPointSuccess) return false;
    encode_tiled = (EncodeTiled)fn;
  }
  const cuuint64_t dims[3] = {d0, d1, d2}, strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2}, unit[3] = {1, 1, 1};
  return encode_tiled(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(base), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of segment o of a product of B rows in G groups of gN
// columns. X: (k < len, group, row < B), the group dim 1 deep where the
// groups share X (xgs = 0). W: groups stacked one after another (wgs at
// least a whole group, or one group) as (column < gN, k < len, group), or
// side by side in W's rows (wgs < ldw: win's blocks of columns) as
// (column < gN, group, k < len). Out-of-bounds boxes read zeros, so a
// group's ragged tile and depth read no other group's values.
inline bool t128_seg(T128Seg* s, const Opnd& o, int B, int G, int gN) {
  s->len = o.len;
  s->xq = o.xgs != 0;
  s->wcol = G > 1 && o.wgs < (size_t)o.ldw;
  const uint64_t ldx = 2ull * o.ldx, ldw = 2ull * o.ldw, wgs = 2ull * o.wgs;
  const bool x = tmap3(&s->x, o.x, o.len, s->xq ? G : 1, B,
                       s->xq ? 2ull * o.xgs : ldx, ldx, 64, 1, T128_BM);
  const bool w =
      s->wcol ? tmap3(&s->w, o.w, gN, G, o.len, wgs, ldw, 64, 1, T128_BK)
              : tmap3(&s->w, o.w, gN, o.len, G, ldw,
                      G > 1 ? wgs : ldw * o.len, 64, T128_BK, 1);
  return x && w;
}

template <class Bias, class Out>
inline void tc128(Opnd a, Opnd b, int gN, const Bias* bias, Out* out,
                  int ldo, int B, int N, int ns, cudaStream_t st) {
  if (!tc128_allowed<Bias, Out>) {
    cudaFuncSetAttribute(tc128_kernel<Bias, Out>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         T128_SMEM);
    tc128_allowed<Bias, Out> = true;
  }
  T128Seg sa{}, sb{};
  const int G = N / gN;
  const bool ok = t128_seg(&sa, a, B, G, gN) &&
                  (b.len == 0 || t128_seg(&sb, b, B, G, gN));
  // A map the driver refuses leaves the grid empty: the launch is refused
  // (invalid configuration) and the entry point's cudaGetLastError
  // reports it.
  const dim3 grid(ok ? (B + T128_BM - 1) / T128_BM : 0,
                  G * ((gN + T128_BN - 1) / T128_BN), ns);
  tc128_kernel<Bias, Out><<<grid, T128_THREADS, T128_SMEM, st>>>(
      sa, sb, gN, bias, out, ldo, B, ns);
}

// A forward product on the tensor cores: the 16-row stage below MMA_ROWS
// rows, the 128-row stage from there on. Its split count comes from
// tc_fwd_splits.
template <class Bias, class Out>
inline void tc_fwd(Opnd a, Opnd b, int gN, const Bias* bias, Out* out,
                   int ldo, int B, int N, int ns, cudaStream_t st) {
  if (B < MMA_ROWS)
    tc16<false>(a, b, gN, bias, out, ldo, B, N, ns, st);
  else
    tc128(a, b, gN, bias, out, ldo, B, N, ns, st);
}

// --- Stages -----------------------------------------------------------------

// One operand of a concatenated contraction: X(row, k) = x[row * ld + k]
// for k < len.
struct XSeg {
  const bf16* x;
  int ld;
  int len;
};

// out[z][row, col] (row stride N): split z of [a | b](row, :) @ w, where
// w (a.len + b.len, N) stacks the rows for a over those for b, times the
// column scale (int8 w; one scale for both parts); split 0 adds the bias
// (bf16 or f32). Grid (N / TN, ceil(B / TM), ns).
template <class Bias, class Out, class W>
__global__ void __launch_bounds__(THREADS)
mm_kernel(XSeg a, XSeg b, const W* w, const Bias* bias, const float* scale,
          Out* out, int B, int N, int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM, z = blockIdx.z;
  int lo, hi;
  split_range(a.len + b.len, ns, z, &lo, &hi);
  float acc[1] = {0.f};
  segment_mm(acc, LoadBf16{a.x, a.ld}, 0, a.len, lo, hi, w + col0, N, row0, B,
             xs, ws);
  segment_mm(acc, LoadBf16{b.x, b.ld}, a.len, b.len, lo, hi,
             w + (size_t)a.len * N + col0, N, row0, B, xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    const float add = (z == 0 && bias) ? to_f(bias[col]) : 0.f;
    store(out + ((size_t)z * B + row) * N + col,
          scaled(acc[0], scale, col) + add);
  }
}

// Whether mm of B rows into N columns on weights W takes the tensor cores:
// bf16 weights, and from MMA_ROWS rows on at least 64 columns (the action
// head's 16 or 32 stay on the FMA stage: a 128-column tile would be mostly
// empty).
template <class W>
constexpr bool use_tc(int B, int N) {
  return std::is_same<W, bf16>::value && (B < MMA_ROWS || N >= 64);
}

// The split count of a forward product on the tensor cores.
inline int tc_fwd_splits(int N, int gN, int B, int K, int sms) {
  return B < MMA_ROWS ? tc_splits(N, gN, B, K, sms)
                      : tc128_splits(N, gN, B, K, sms);
}

// The split count of mm for B rows into N columns over a K-deep
// contraction on weights W.
template <class W>
inline int mm_splits(int B, int N, int K, int sms) {
  return use_tc<W>(B, N) ? tc_fwd_splits(N, N, B, K, sms)
                         : fma_splits(N, B, K, sms);
}

// [a | b] @ w (times the column scales of an int8 w) + bias into `out`:
// f32 split partials (ns of them, from mm_splits), or with ns == 1 the
// finished product in f32 or bf16.
template <class Bias, class Out, class W>
inline void mm(XSeg a, XSeg b, const W* w, const Bias* bias, Out* out,
               int B, int N, int ns, cudaStream_t st,
               const float* scale = nullptr) {
  if constexpr (std::is_same<W, bf16>::value) {
    if (use_tc<W>(B, N)) {
      tc_fwd(Opnd{a.x, a.ld, 0, w, N, 0, a.len},
             b.len ? Opnd{b.x, b.ld, 0, w + (size_t)a.len * N, N, 0, b.len}
                   : no_opnd(),
             N, bias, out, N, B, N, ns, st);
      return;
    }
  }
  mm_kernel<Bias, Out, W><<<grid_for(N, B, ns), THREADS, 0, st>>>(
      a, b, w, bias, scale, out, B, N, ns);
}

// out[row, g W + c] (row stride ldo) = bf16(silu(x * rstd * scale_g[c])),
// x = the sum of the ns partials parts[s][row, g W + c] (row stride ld)
// over group g = blockIdx.y (scale0 or scale1). With `pre`, also saves x
// (row stride ld) and rstd[row * gridDim.y + g] for the backward. One
// block per (row, group); the sum runs in split order.
__global__ void __launch_bounds__(FIN_THREADS)
finish_kernel(const float* parts, int ns, int B, int ld, int W,
              const float* scale0, const float* scale1, float eps, bf16* out,
              int ldo, float* pre, float* rstd_out) {
  __shared__ float red[FIN_THREADS / 32];
  const int row = blockIdx.x, g = blockIdx.y;
  const float* scale = g ? scale1 : scale0;
  const size_t base = (size_t)row * ld + (size_t)g * W;
  const size_t step = (size_t)B * ld;
  float ss = 0.f;
  for (int c = threadIdx.x; c < W; c += FIN_THREADS) {
    float v = 0.f;
    for (int s = 0; s < ns; ++s) v += parts[s * step + base + c];
    ss += v * v;
  }
  const float rstd = rsqrtf(block_sum(ss, red) / W + eps);
  for (int c = threadIdx.x; c < W; c += FIN_THREADS) {
    float v = 0.f;
    for (int s = 0; s < ns; ++s) v += parts[s * step + base + c];
    out[(size_t)row * ldo + (size_t)g * W + c] =
        __float2bfloat16(silu(v * rstd * scale[c]));
    if (pre) pre[base + c] = v;
  }
  if (rstd_out && threadIdx.x == 0) rstd_out[row * gridDim.y + g] = rstd;
}

inline void finish(const float* parts, int ns, int B, int ld, int W,
                   int groups, const float* s0, const float* s1, float eps,
                   bf16* out, int ldo, float* pre, float* rstd,
                   cudaStream_t st) {
  finish_kernel<<<dim3(B, groups), FIN_THREADS, 0, st>>>(
      parts, ns, B, ld, W, s0, s1, eps, out, ldo, pre, rstd);
}

// out[row, c] = x[row, c] * keep[row] (bf16; a copy without keep).
__global__ void mask_kernel(const bf16* x, int ldx, int W, const float* keep,
                            bf16* out, int ldo) {
  const int row = blockIdx.x;
  const float m = keep ? keep[row] : 1.f;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    out[(size_t)row * ldo + c] =
        __float2bfloat16(to_f(x[(size_t)row * ldx + c]) * m);
  }
}

inline void mask(const bf16* x, int ldx, int W, const float* keep, bf16* out,
                 int ldo, int B, cudaStream_t st) {
  mask_kernel<<<B, 256, 0, st>>>(x, ldx, W, keep, out, ldo);
}

// The input projections, split z = blockIdx.z: pre[z][:, :H] and
// pre[z][:, H:], the split's partial sums of deter @ w0 and stoch @ w1
// (times q0, q1 for int8 weights); split 0 adds b0, b1. Grid
// (2 * H / TN, ceil(B / TM), ns).
template <class W>
__global__ void __launch_bounds__(THREADS)
in_proj_kernel(const bf16* deter, const bf16* stoch, const W* w0,
               const bf16* b0, const W* w1, const bf16* b1, const float* q0,
               const float* q1, float* pre, int B, int D, int S, int H,
               int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int tiles = H / TN, z = blockIdx.z;
  const bool second = blockIdx.x >= tiles;
  const int col0 = (blockIdx.x % tiles) * TN, row0 = blockIdx.y * TM;
  int lo, hi;
  split_range(second ? S : D, ns, z, &lo, &hi);
  float acc[1] = {0.f};
  const LoadBf16 load = second ? LoadBf16{stoch, S} : LoadBf16{deter, D};
  tile_mm<1>(acc, load, lo, hi, (second ? w1 : w0) + col0, 0, H, row0, B,
             xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    const float bias = z ? 0.f : to_f((second ? b1 : b0)[col]);
    pre[((size_t)z * B + row) * 2 * H + (second ? H : 0) + col] =
        scaled(acc[0], second ? q1 : q0, col) + bias;
  }
}

// Split z of [deter block (dg) | x (lx)] @ [wblk[blk]; win] for the GRU
// hidden layer, where x = [xd, x0, act] (row stride ldx) and blk is the GRU
// block of the tile's columns; split 0 adds bblk. Int8 weights keep the two
// products' sums apart, each times its own column scales (qblk (g, dg)
// flat, qin (D)). Grid (D / TN, ceil(B / TM), ns); a column tile lies
// inside one GRU block.
template <class W>
__global__ void __launch_bounds__(THREADS)
hidden_kernel(const bf16* x, int ldx, int lx, const bf16* deter,
              const W* wblk, const bf16* bblk, const W* win,
              const float* qblk, const float* qin, float* hpre, int B, int D,
              int g, int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM, z = blockIdx.z;
  const int dg = D / g, blk = col0 / dg;
  int lo, hi;
  split_range(dg + lx, ns, z, &lo, &hi);
  float acc[1] = {0.f}, accin[1] = {0.f};
  segment_mm(acc, LoadBf16{deter + (size_t)blk * dg, D}, 0, dg, lo, hi,
             wblk + (size_t)blk * dg * dg + (col0 - blk * dg), dg, row0, B,
             xs, ws);
  segment_mm(qin ? accin : acc, LoadBf16{x, ldx}, dg, lx, lo, hi,
             win + col0, D, row0, B, xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    const float bias = z ? 0.f : to_f(bblk[col]);
    const float v =
        qin ? scaled(acc[0], qblk, col) + scaled(accin[0], qin, col) : acc[0];
    hpre[((size_t)z * B + row) * D + col] = v + bias;
  }
}

// The gate products of block blk for the tile's columns i (reset i,
// candidate dg + i, update 2 dg + i of wg[blk]) and the GRU update; with
// `gates`, also saves the gate pre-activations (bias included, f32, in
// wg's column layout [blk][reset | cand | update], row stride 3D). Int8
// weights scale each gate product by qg (g, 3 dg) flat, in wg's column
// layout. Grid (D / TN, ceil(B / TM)).
template <class W>
__global__ void __launch_bounds__(THREADS)
gru_kernel(const bf16* h, const W* wg, const bf16* bg, const float* qg,
           const bf16* deter, bf16* out, float* gates, int B, int D, int g) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[3 * KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM;
  const int dg = D / g, blk = col0 / dg, i0 = col0 - blk * dg;
  float acc[3] = {0.f, 0.f, 0.f};
  tile_mm<3>(acc, LoadBf16{h + (size_t)blk * dg, D}, 0, dg,
             wg + (size_t)blk * dg * 3 * dg + i0, dg, 3 * dg, row0, B, xs,
             ws);
  const int row = row0 + threadIdx.x / TN, c = threadIdx.x % TN;
  if (row < B) {
    const size_t gb = (size_t)blk * 3 * dg + i0 + c;
    const float gr = scaled(acc[0], qg, gb) + to_f(bg[gb]);
    const float gc = scaled(acc[1], qg, gb + dg) + to_f(bg[gb + dg]);
    const float gu = scaled(acc[2], qg, gb + 2 * dg) + to_f(bg[gb + 2 * dg]);
    const float r = sigmoid(gr);
    const float cand = tanhf(r * gc);
    const float u = sigmoid(gu - 1.f);
    const size_t at = (size_t)row * D + col0 + c;
    out[at] = __float2bfloat16(u * cand + (1.f - u) * to_f(deter[at]));
    if (gates) {
      float* gp = gates + (size_t)row * 3 * D + gb;
      gp[0] = gr;
      gp[dg] = gc;
      gp[2 * dg] = gu;
    }
  }
}

// The GRU update from the gate pre-activations, the sum of ns split
// partials parts[s] (bias included, f32, in wg's column layout, row stride
// 3D): the tensor-core paths' last stage. With `save`, also keeps the
// summed pre-activations there (same layout) for the backward.
__global__ void gru_update_kernel(const float* parts, int ns, float* save,
                                  const bf16* deter, bf16* out, int B, int D,
                                  int g) {
  const int row = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  const int dg = D / g, blk = j / dg, i = j - blk * dg;
  const size_t gb = (size_t)row * 3 * D + (size_t)blk * 3 * dg + i;
  const size_t step = (size_t)B * 3 * D;
  float gr = 0.f, gc = 0.f, gu = 0.f;
  for (int s = 0; s < ns; ++s) {
    gr += parts[s * step + gb];
    gc += parts[s * step + gb + dg];
    gu += parts[s * step + gb + 2 * dg];
  }
  if (save) {
    save[gb] = gr;
    save[gb + dg] = gc;
    save[gb + 2 * dg] = gu;
  }
  const float r = sigmoid(gr);
  const float cand = tanhf(r * gc);
  const float u = sigmoid(gu - 1.f);
  const size_t at = (size_t)row * D + j;
  out[at] = __float2bfloat16(u * cand + (1.f - u) * to_f(deter[at]));
}

inline void gru_update(const float* parts, int ns, float* save,
                       const bf16* deter, bf16* out, int B, int D, int g,
                       cudaStream_t st) {
  gru_update_kernel<<<dim3((D + 255) / 256, B), 256, 0, st>>>(
      parts, ns, save, deter, out, B, D, g);
}

// --- The core step and the posterior head -----------------------------------

// The core's weights in ops/blockgru.py FIELDS order: the matrices in W
// (bf16, or int8 with the column scales q0..qg of ops/qcore.py; null for
// bf16), biases bf16, norm scales f32.
template <class W>
struct CoreT {
  const W* w0;
  const bf16* b0;
  const float* s0;
  const W* w1;
  const bf16* b1;
  const float* s1;
  const W* wblk;
  const bf16* bblk;
  const W* win;
  const float* sh;
  const W* wg;
  const bf16* bg;
  const float *q0, *q1, *qblk, *qin, *qg;
};
typedef CoreT<bf16> Core;

inline Core core_weights(const void* const* p) {
  auto b = [&](int i) { return (const bf16*)p[i]; };
  auto f = [&](int i) { return (const float*)p[i]; };
  return Core{b(0), b(1), f(2), b(3), b(4), f(5),
              b(6), b(7), b(8), f(9), b(10), b(11)};
}

// What a backward keeps of a core step; all null in a forward.
struct CoreSave {
  float* pre01;   // (B, 2H) input-projection pre-activations
  float* rstd01;  // (B, 2)
  float* hpre;    // (B, D) hidden pre-activation
  float* rstdh;   // (B)
  float* gates;   // (B, 3D) gate pre-activations
};

// The core stages of one step. x (B, 2H + A) holds the action embedding in
// its last A columns; the stages write [xd, x0] into its first 2H, the
// hidden activation into h (B, D) and the new deter into out (B, D).
// `parts` holds core_parts floats. With bf16 weights every product runs on
// the tensor cores (core_tc), at any batch; int8 weights take the FMA
// stages.
//
// core_tc is the first case: each product on the tensor-core stage of its
// batch (tc_fwd), into split partials, the gates too (then the update adds
// their splits).
inline void core_tc(const CoreT<bf16>& w, const bf16* deter,
                    const bf16* stoch, bf16* x, bf16* h, bf16* out,
                    float* parts, const CoreSave& save, int B, int D, int H,
                    int S, int A, int g, int sms, float eps,
                    cudaStream_t st) {
  const int dg = D / g, lx = 2 * H + A;
  const Opnd none = no_opnd();
  // Both input projections take one split count, as finish adds them. The
  // 16-row stage counts the tiles of both; the 128-row stage's parts fill
  // the card in each launch.
  const int n1 = B < MMA_ROWS ? 2 * H : H;
  const int ns1 = tc_fwd_splits(n1, n1, B, D > S ? D : S, sms);
  tc_fwd(Opnd{deter, D, 0, w.w0, H, 0, D}, none, H, w.b0, parts, 2 * H, B, H,
         ns1, st);
  tc_fwd(Opnd{stoch, S, 0, w.w1, H, 0, S}, none, H, w.b1, parts + H, 2 * H, B,
         H, ns1, st);
  finish(parts, ns1, B, 2 * H, H, 2, w.s0, w.s1, eps, x, lx, save.pre01,
         save.rstd01, st);
  // The hidden layer: GRU block q of the deter against wblk[q], then x
  // against win's columns of block q.
  const int ns2 = tc_fwd_splits(D, dg, B, dg + lx, sms);
  tc_fwd(Opnd{deter, D, dg, w.wblk, dg, (size_t)dg * dg, dg},
         Opnd{x, lx, 0, w.win, D, (size_t)dg, lx}, dg, w.bblk, parts, D, B, D,
         ns2, st);
  finish(parts, ns2, B, D, D, 1, w.sh, w.sh, eps, h, D, save.hpre,
         save.rstdh, st);
  const int ns3 = tc_fwd_splits(3 * D, 3 * dg, B, dg, sms);
  tc_fwd(Opnd{h, D, dg, w.wg, 3 * dg, (size_t)dg * 3 * dg, dg}, none, 3 * dg,
         w.bg, parts, 3 * D, B, 3 * D, ns3, st);
  gru_update(parts, ns3, save.gates, deter, out, B, D, g, st);
}

template <class W>
inline void core_stages(const CoreT<W>& w, const bf16* deter,
                        const bf16* stoch, bf16* x, bf16* h, bf16* out,
                        float* parts, const CoreSave& save, int B, int D,
                        int H, int S, int A, int g, int sms, float eps,
                        cudaStream_t st) {
  if constexpr (std::is_same<W, bf16>::value) {
    core_tc(w, deter, stoch, x, h, out, parts, save, B, D, H, S, A, g, sms,
            eps, st);
  } else {
    const int dg = D / g, lx = 2 * H + A;
    const int ns1 = fma_splits(2 * H, B, D > S ? D : S, sms);
    in_proj_kernel<W><<<grid_for(2 * H, B, ns1), THREADS, 0, st>>>(
        deter, stoch, w.w0, w.b0, w.w1, w.b1, w.q0, w.q1, parts, B, D, S, H,
        ns1);
    finish(parts, ns1, B, 2 * H, H, 2, w.s0, w.s1, eps, x, lx, save.pre01,
           save.rstd01, st);
    const int ns2 = fma_splits(D, B, dg + lx, sms);
    hidden_kernel<W><<<grid_for(D, B, ns2), THREADS, 0, st>>>(
        x, lx, lx, deter, w.wblk, w.bblk, w.win, w.qblk, w.qin, parts, B, D,
        g, ns2);
    finish(parts, ns2, B, D, D, 1, w.sh, w.sh, eps, h, D, save.hpre,
           save.rstdh, st);
    gru_kernel<W><<<grid_for(D, B), THREADS, 0, st>>>(
        h, w.wg, w.bg, w.qg, deter, out, save.gates, B, D, g);
  }
}

// Floats of split partials the core stages need at most (the gates' too).
// The input projections' count is sized for one projection's tiles, the
// most either stage's rule gives the pair.
inline size_t core_parts(int B, int D, int H, int S, int A, int g, int sms) {
  const int dg = D / g;
  const size_t a = (size_t)most_splits(H, B, D > S ? D : S, sms) * B * 2 * H;
  const size_t b = (size_t)most_splits(D, B, dg + 2 * H + A, sms) * B * D;
  const size_t c = (size_t)most_splits(3 * D, B, dg, sms) * B * 3 * D;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// The posterior head's weights in ops/observe.py FIELDS order (after the
// core's 12); int8 matrices carry the column scales qo (one for both parts
// of wo) and ql.
template <class W>
struct HeadT {
  const W* wo;
  const bf16* bo;
  const float* so;
  const W* wl;
  const bf16* bl;
  const float *qo, *ql;
};
typedef HeadT<bf16> Head;

inline Head head_weights(const void* const* p) {
  return Head{(const bf16*)p[0], (const bf16*)p[1], (const float*)p[2],
              (const bf16*)p[3], (const bf16*)p[4]};
}

// Floats of split partials the posterior head needs at most.
inline size_t head_parts(int B, int D, int H, int K, int sms) {
  return (size_t)most_splits(H, B, D + K, sms) * B * H;
}

// The posterior head on the new deter `out` (B, D) and the tokens (B, K):
// xo (B, H) bf16 and the logits (B, L), f32 or bf16 (not computed where
// `logit` is null). With `preo`, also saves the hidden pre-activation and
// its rstd for the backward.
template <class W, class Logit>
inline void post_head(const HeadT<W>& w, const bf16* out, const bf16* tok,
                      bf16* xo, Logit* logit, float* parts, float* preo,
                      float* rstdo, int B, int D, int H, int K, int L,
                      int sms, float eps, cudaStream_t st) {
  const int ns = mm_splits<W>(B, H, D + K, sms);
  mm(XSeg{out, D, D}, XSeg{tok, K, K}, w.wo, w.bo, parts, B, H, ns, st,
     w.qo);
  finish(parts, ns, B, H, H, 1, w.so, w.so, eps, xo, H, preo, rstdo, st);
  if (logit)
    mm(XSeg{xo, H, H}, XSeg{nullptr, 0, 0}, w.wl, w.bl, logit, B, L, 1, st,
       w.ql);
}

}  // namespace blockgru
