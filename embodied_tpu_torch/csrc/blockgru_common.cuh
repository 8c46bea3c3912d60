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
// or 32 columns stay on the FMA stage (tile_mm: one output per thread,
// 16 x 16 tiles).
//
// The weight matrices come in bf16 or in int8 (the template parameter W):
// int8 weights (qcore.cu) halve the bytes a step streams, and carry
// per-output-column f32 scales. They take the 16-row stage at every
// batch: its ring streams the int8 tiles as they lie, the fragments are
// formed from them in registers, exact in bf16 (|q| <= 127), and each
// segment's scales multiply its f32 sums in the epilogue, split by split,
// before split 0 adds the bias. The scale is linear, so the splits' sum
// is the scaled product, up to f32 rounding. The window runs int8 at 16
// rows; at 128 rows or more int8 is correct but not tuned (16-row tiles,
// never the 128-row stage, which takes bf16 only).

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

// The 16-row tensor-core stage (tc16_kernel below) takes its weights in
// chunks of 8 KB: TC_BN columns, tc_bk<W> deep (64 in bf16, 128 in int8).
// tc_splits: enough 16 x TC_BN tiles times parts for two blocks per SM,
// and at least one chunk per part. N columns in groups of gN; a tile never
// straddles a group.
constexpr int TC_BN = 64;
template <class W>
constexpr int tc_bk = 8192 / (TC_BN * (int)sizeof(W));

template <class W = bf16>
inline int tc_splits(int N, int gN, int B, int K, int sms) {
  const int tiles = (N / gN) * ((gN + TC_BN - 1) / TC_BN) * ((B + 15) / 16);
  return clamp_splits((2 * sms + tiles - 1) / tiles, K, tc_bk<W>);
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
// partials is sized for (a grouped product has at least as many tiles, and
// an int8 one deeper chunks, so no more parts).
inline int most_splits(int N, int B, int K, int sms) {
  const int a = fma_splits(N, B, K, sms), b = tc_splits(N, N, B, K, sms);
  const int c = tc128_splits(N, N, B, K, sms);
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

inline dim3 grid_for(int cols, int B, int ns = 1) {
  return dim3(cols / TN, (B + TM - 1) / TM, ns);
}

// The 8 bf16 weights at p (16-byte aligned) as floats, from one 16-byte
// load.
__device__ __forceinline__ void load16(const bf16* p, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q] = to_f(e[q]);
}

// Split z of a contraction of depth K cut into ns nearly equal parts.
__device__ __forceinline__ void split_range(int K, int ns, int z, int* lo,
                                            int* hi) {
  *lo = (int)((long long)K * z / ns);
  *hi = (int)((long long)K * (z + 1) / ns);
}

// --- FMA products (the action head's narrow stages from MMA_ROWS rows on) ---

// acc += sum_k x[row * ldx + k] * w[k * ldw + c] over k in [lo, hi), for
// the thread's (row, c) of the tile; w points at column 0 of the tile in a
// row-major bf16 matrix with row stride ldw. Requires ldw and the tile's
// column offset to be multiples of 8 and w 16-byte aligned (16-byte
// loads); the wrapper checks the shapes. All threads of the block must
// call it alike.
__device__ inline void tile_mm(float& acc, const bf16* x, int ldx, int lo,
                               int hi, const bf16* w, int ldw, int row0,
                               int B, float* xs, float* ws) {
  constexpr int P = TN / 8;  // 16-byte loads per staged row of the tile
  const int t = threadIdx.x, r = t / TN, c = t % TN;
  for (int k0 = lo; k0 < hi; k0 += KC) {
    for (int i = t; i < TM * KC; i += THREADS) {
      const int rr = i / KC, kk = i % KC;
      const int row = row0 + rr, k = k0 + kk;
      xs[i] = (row < B && k < hi) ? to_f(x[(size_t)row * ldx + k]) : 0.f;
    }
    for (int i = t; i < KC * P; i += THREADS) {
      const int kk = i / P, part = i % P, k = k0 + kk;
      float* dst = ws + kk * TN + part * 8;
      if (k < hi) {
        load16(w + (size_t)k * ldw + part * 8, dst);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[q] = 0.f;
      }
    }
    __syncthreads();
    const float* xr = xs + r * KC;
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) acc += xr[kk] * ws[kk * TN + c];
    __syncthreads();
  }
}

// The part of segment [seg, seg + len) of a concatenated contraction that
// falls in this split's [lo, hi): x and w are indexed from the segment's
// start. The condition is the same for every thread of the block.
__device__ inline void segment_mm(float& acc, const bf16* x, int ldx,
                                  int seg, int len, int lo, int hi,
                                  const bf16* w, int ldw, int row0, int B,
                                  float* xs, float* ws) {
  const int a = max(lo - seg, 0), b = min(hi - seg, len);
  if (a < b) tile_mm(acc, x, ldx, a, b, w, ldw, row0, B, xs, ws);
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

// Four 8 x 8 matrices of 16-bit elements from shared memory, lanes
// 8 i .. 8 i + 7 giving the row addresses of matrix i; with `trans`, each
// matrix transposed.
template <bool trans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
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

// --- Tensor-core products at 16 rows (below MMA_ROWS; int8 at any batch) ----
//
// mma.sync m16n8k16 takes 16 rows, the acting and window batch exactly.
// A block computes one 16 x TC_BN output tile over its split's part of the
// contraction: the four warps own 16 columns each (two n8 tiles), and all
// of them read the tile's 16 staged rows. Weight tiles (8 KB: 64 k x TC_BN
// in bf16, 128 k in int8) stream through a ring of TC_STAGES shared-memory
// stages filled by 16-byte cp.async loads, so three chunks are in flight
// while one is multiplied; fragments come from ldmatrix. The products are
// bound by the weight bytes, so the split count (tc_splits) keeps about
// two blocks per SM streaming, and every split writes its own f32 partials
// (`parts` in the FMA stages' layout), which the consumer adds in split
// order.
//
// The forward product (trans = false) reads X (bf16) against W (K x N,
// row-major: its tile is staged [k][n] and read by ldmatrix.trans); the
// transposed product of the backward (trans = true) reads Y (f32, staged
// as it lies and rounded to bf16 as its fragments are formed: the dY
// operand in the compute dtype) against the rows of W, contiguous along k
// (staged [n][k], plain ldmatrix). The ring takes 46 KB of shared memory,
// 55 KB with f32 rows, so four blocks fit an SM.
//
// Int8 weights (forward only) stay int8 up to the registers: 16 columns a
// cp.async load, 128-deep chunks, so a stage carries the 8 KB a bf16
// stage does (57 KB a ring with its 4 KB of rows, three blocks an SM) and
// a product takes the bf16 split count. ldmatrix.trans reads a pair of
// int8 columns as one 16-bit element, so each register holds two columns
// at two consecutive k: bytes (c, k), (c + 1, k), (c, k + 1), (c + 1,
// k + 1). Its even and its odd bytes are each a bf16 pair of the B
// fragment (i8x2_bf16: two bit operations and a bf16x2 fma, exact), so a
// warp's two n8 tiles take its even and its odd columns, and the epilogue
// writes each sum to its own column. Converting in registers costs no
// shared-memory pass and no barrier more than bf16 (converting the landed
// tile into a bf16 [k][n] tile for the bf16 fragments would cost both).
// The epilogue multiplies the sums by the segment's column scales (flat
// column q gN + j, loaded while the first chunks are in flight); a split
// that runs from segment a into b scales a's sums where it crosses, as
// the hidden layer's two segments (wblk, win) have scales of their own.
// On an H100 the int8 window ran slower with int8 tiles 128 columns wide
// (whole 128-byte rows), whether 64 deep with twice the splits (their
// partials cost the row stages that add them more than the products
// gained) or 128 deep with one block of four or eight warps an SM.

constexpr int TC_STAGES = 4, TC_THREADS = 128;

// One operand pair of a 16-row product. Output column n lies in group
// q = n / gN at offset j = n - q gN; the segment adds, over k < len,
//   X(row, k) = x[row * ldx + q * xgs + k]      (bf16; f32 if trans)
// times
//   w[q * wgs + k * ldw + j]                    (forward)
//   w[q * wgs + j * ldw + k]                    (trans, bf16 w only)
// and for int8 w multiplies the sums by scale[n]. len, ldx and xgs are
// multiples of 8, ldw, wgs and gN multiples of 16 / sizeof(W) (16-byte
// loads) and gN of 16; the wrappers check the widths.
template <class W>
struct OpndT {
  const void* x;
  int ldx;
  int xgs;
  const W* w;
  int ldw;
  size_t wgs;
  int len;
  const float* scale = nullptr;  // int8 w: f32 column scales
};
typedef OpndT<bf16> Opnd;

template <class W = bf16>
inline OpndT<W> no_opnd() {
  return OpndT<W>{nullptr, 0, 0, nullptr, 0, 0, 0};
}

template <bool trans, class W>
struct TcStage {
  // The rows, [row][k]: bf16, or f32 for trans, staged as they lie and
  // rounded to bf16 as the fragments are formed.
  typename std::conditional<trans, float, bf16>::type x[16][tc_bk<W> + 8];
  // [k][n] forward, [n][k] trans (bf16: TC_BN = tc_bk).
  W w[tc_bk<W>][TC_BN + 16 / sizeof(W)];
};

// Stage chunk [k0, k0 + tc_bk<W>) of segment o for the tile at column j0
// of group q (`valid` columns of it inside the group), rows row0.. < B;
// zeros outside, all by 16-byte cp.async. Rows padded by 16 bytes (X by 8
// values) keep the 16-byte stores aligned, an ldmatrix's eight rows on
// distinct banks, and the f32 fragment loads of each half-warp on
// distinct banks.
template <bool trans, class W>
__device__ __forceinline__ void tc_stage(TcStage<trans, W>& s,
                                         const OpndT<W>& o, int k0, int q,
                                         int j0, int valid, int row0, int B) {
  constexpr int BK = tc_bk<W>, V = 16 / sizeof(W);  // weights a load
  constexpr int P = (trans ? BK : TC_BN) / V;       // loads a staged row
  const int t = threadIdx.x;
  const W* Wq = o.w + (size_t)q * o.wgs;
#pragma unroll
  for (int j = 0; j < BK * TC_BN / V / TC_THREADS; ++j) {
    const int i = t + j * TC_THREADS;
    const int r = i / P, c = (i % P) * V;
    const bool ok = trans ? (r < valid && k0 + c < o.len)
                          : (k0 + r < o.len && c < valid);
    const W* src = trans ? Wq + (size_t)(j0 + r) * o.ldw + k0 + c
                         : Wq + (size_t)(k0 + r) * o.ldw + j0 + c;
    cp_async16(&s.w[r][c], ok ? src : o.w, ok ? 16 : 0);
  }
  // 16 rows of BK, 16 bytes a load: 8 bf16 or 4 f32 values.
  constexpr int VX = 16 / sizeof(s.x[0][0]);
#pragma unroll
  for (int j = 0; j < 16 * BK / VX / TC_THREADS; ++j) {
    const int i = t + j * TC_THREADS;
    const int r = i / (BK / VX), c = (i % (BK / VX)) * VX;
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

// The int8 values in bytes 0 and 2 of r as a bf16 pair (byte 0 low).
// Each byte b is q = (b & 127) - 128 [b < 0], the difference of two bf16
// values that its bits give: 128 + (b & 127) (0x4300 | b & 0x7f) and
// 128 or 256 (0x4300 | b & 0x80, negated: 0xc300 | ...). Their sum is an
// integer of magnitude <= 128, so the bf16x2 fma is exact.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t r) {
  const uint32_t hi = (r & 0x007f007fu) | 0x43004300u;
  const uint32_t lo = (r & 0x00800080u) | 0xc300c300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(hi), "r"(0x3f803f80u), "r"(lo));
  return d;
}

// out[z][row, n] (row stride ldo, split stride B ldo): split z of the
// products of segments a and b (b.len may be 0) for n < N, plus bias[n]
// (bf16 or f32, optional) in split 0. Every split writes, an empty one
// zeros. Grid ((N / gN) ceil(gN / TC_BN), ceil(B / 16), ns); the
// contraction is cut into tc_bk<W> chunks, a's then b's, and split z takes
// its share of them in order. Fragment layouts: PTX's mma.m16n8k16.
template <bool trans, class W, class Bias, class Out>
__global__ void __launch_bounds__(TC_THREADS)
tc16_kernel(OpndT<W> a, OpndT<W> b, int gN, const Bias* bias, Out* out,
            int ldo, int B, int ns) {
  constexpr bool i8 = std::is_same<W, int8_t>::value;
  static_assert(!trans || !i8, "the transposed product takes bf16 weights");
  constexpr int BK = tc_bk<W>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  TcStage<trans, W>* s = reinterpret_cast<TcStage<trans, W>*>(tc_smem);
  const int tpg = (gN + TC_BN - 1) / TC_BN;
  const int q = blockIdx.x / tpg, j0 = (blockIdx.x % tpg) * TC_BN;
  const int valid = min(TC_BN, gN - j0);
  const int row0 = blockIdx.y * 16, z = blockIdx.z;
  const int ca = (a.len + BK - 1) / BK, cb = (b.len + BK - 1) / BK;
  int lo, hi;
  split_range(ca + cb, ns, z, &lo, &hi);
  const int n = hi - lo;
  auto stage = [&](int i) {
    const int c = lo + i;
    if (c < ca)
      tc_stage<trans, W>(s[i % TC_STAGES], a, c * BK, q, j0, valid, row0, B);
    else
      tc_stage<trans, W>(s[i % TC_STAGES], b, (c - ca) * BK, q, j0, valid,
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
  // The tile column of sum e of n8 tile nt: int8 tiles take the warp's
  // even (nt 0) and odd (nt 1) columns.
  auto column = [&](int nt, int e) {
    return i8 ? nb + 4 * tq + 2 * e + nt : nb + nt * 8 + tq * 2 + e;
  };
  // acc[nt][h * 2 + e]: row g + 8 h, column column(nt, e). Int8: `done`
  // holds segment a's scaled sums once the split has crossed into b, and
  // sa, sb the two segments' scales of the thread's columns, loaded while
  // the first chunks are in flight (zeros outside the tile).
  float acc[2][4] = {}, done[2][4] = {}, sa[2][4] = {}, sb[2][4] = {};
  if constexpr (i8) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = column(nt, e), col = q * gN + j0 + cl;
        if (cl >= valid) continue;
        sa[nt][e] = sa[nt][e + 2] = a.scale[col];
        if (b.len) sb[nt][e] = sb[nt][e + 2] = b.scale[col];
      }
  }
  auto scale_into = [&](float (&dst)[2][4], const float (&sc)[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        dst[nt][v] += acc[nt][v] * sc[nt][v];
        acc[nt][v] = 0.f;
      }
  };
  for (int i = 0; i < n; ++i) {
    cp_wait<TC_STAGES - 2>();  // chunk i has landed
    __syncthreads();           // and every warp is done with chunk i - 1
    if (i + TC_STAGES - 1 < n) stage(i + TC_STAGES - 1);
    cp_commit();
    const TcStage<trans, W>& c = s[i % TC_STAGES];
    if constexpr (i8) {
      if (i > 0 && lo + i == ca) scale_into(done, sa);
      // One k step of 16: rows af against the int8 registers of its k
      // rows 0..7 (w0) and 8..15 (w1); the even bytes feed tile 0, the
      // odd ones tile 1.
      auto step = [&](const uint32_t (&af)[4], uint32_t w0, uint32_t w1) {
        mma_bf16(acc[0], af[0], af[1], af[2], af[3], i8x2_bf16(w0),
                 i8x2_bf16(w1));
        mma_bf16(acc[1], af[0], af[1], af[2], af[3], i8x2_bf16(w0 >> 8),
                 i8x2_bf16(w1 >> 8));
      };
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        // Rows for k steps kk and kk + 16; wq[j]: k rows kk + 8 j .. + 7
        // of the warp's 16 columns.
        uint32_t a0[4], a1[4], wq[4];
        ldsm4<false>(a0, &c.x[(m & 1) * 8 + l8][kk + (m >> 1) * 8]);
        ldsm4<false>(a1, &c.x[(m & 1) * 8 + l8][kk + 16 + (m >> 1) * 8]);
        ldsm4<true>(wq, &c.w[kk + m * 8 + l8][nb]);
        step(a0, wq[0], wq[1]);
        step(a1, wq[2], wq[3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
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
  }
  cp_wait<0>();
  if constexpr (i8) {
    // The sums of the segment the split ends in, times its scales (a's in
    // an empty split, whose sums are zeros).
    if (hi > ca)
      scale_into(done, sb);
    else
      scale_into(done, sa);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + h * 8;
      if (row >= B) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = column(nt, e);
        if (cl >= valid) continue;
        const int col = q * gN + j0 + cl;
        const float add = (z == 0 && bias) ? to_f(bias[col]) : 0.f;
        const float v = i8 ? done[nt][h * 2 + e] : acc[nt][h * 2 + e];
        store(out + ((size_t)z * B + row) * ldo + col, v + add);
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
template <bool trans, class W, class Bias, class Out>
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

template <bool trans, class W, class Bias, class Out>
inline void tc16(OpndT<W> a, OpndT<W> b, int gN, const Bias* bias, Out* out,
                 int ldo, int B, int N, int ns, cudaStream_t st) {
  // The ring exceeds the 48 KB of static shared memory with f32 rows or
  // int8 weights: the kernel takes it dynamically, allowed once per
  // instantiation (the port runs on one card; a repeated call is
  // harmless).
  constexpr int bytes = TC_STAGES * sizeof(TcStage<trans, W>);
  if (!tc16_allowed<trans, W, Bias, Out>) {
    cudaFuncSetAttribute(tc16_kernel<trans, W, Bias, Out>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    tc16_allowed<trans, W, Bias, Out> = true;
  }
  const dim3 grid((N / gN) * ((gN + TC_BN - 1) / TC_BN), (B + 15) / 16, ns);
  tc16_kernel<trans, W, Bias, Out><<<grid, TC_THREADS, bytes, st>>>(
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

// Whether a forward product of B rows on weights W takes the 16-row
// stage: below MMA_ROWS rows, and int8 weights at every batch (the 128-row
// stage takes bf16 only).
template <class W>
inline bool rows16(int B) {
  return !std::is_same<W, bf16>::value || B < MMA_ROWS;
}

// A forward product on the tensor cores: the 16-row stage where rows16,
// else the 128-row stage. Its split count comes from tc_fwd_splits.
template <class W, class Bias, class Out>
inline void tc_fwd(OpndT<W> a, OpndT<W> b, int gN, const Bias* bias,
                   Out* out, int ldo, int B, int N, int ns, cudaStream_t st) {
  if (rows16<W>(B))
    tc16<false>(a, b, gN, bias, out, ldo, B, N, ns, st);
  else if constexpr (std::is_same<W, bf16>::value)
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
// w (a.len + b.len, N) bf16 stacks the rows for a over those for b; split
// 0 adds the bias (bf16 or f32). Grid (N / TN, ceil(B / TM), ns).
template <class Bias, class Out>
__global__ void __launch_bounds__(THREADS)
mm_kernel(XSeg a, XSeg b, const bf16* w, const Bias* bias, Out* out, int B,
          int N, int ns) {
  __shared__ float xs[TM * KC];
  __shared__ float ws[KC * TN];
  const int col0 = blockIdx.x * TN, row0 = blockIdx.y * TM, z = blockIdx.z;
  int lo, hi;
  split_range(a.len + b.len, ns, z, &lo, &hi);
  float acc = 0.f;
  segment_mm(acc, a.x, a.ld, 0, a.len, lo, hi, w + col0, N, row0, B, xs, ws);
  segment_mm(acc, b.x, b.ld, a.len, b.len, lo, hi,
             w + (size_t)a.len * N + col0, N, row0, B, xs, ws);
  const int row = row0 + threadIdx.x / TN, col = col0 + threadIdx.x % TN;
  if (row < B) {
    const float add = (z == 0 && bias) ? to_f(bias[col]) : 0.f;
    store(out + ((size_t)z * B + row) * N + col, acc + add);
  }
}

// Whether mm of B rows into N columns on weights W takes the tensor cores:
// every product on the 16-row stage, and from MMA_ROWS rows on bf16
// products of at least 64 columns (the action head's 16 or 32 stay on the
// FMA stage: a 128-column tile would be mostly empty).
template <class W>
inline bool use_tc(int B, int N) {
  return rows16<W>(B) || N >= 64;
}

// The split count of a forward product on the tensor cores.
template <class W>
inline int tc_fwd_splits(int N, int gN, int B, int K, int sms) {
  return rows16<W>(B) ? tc_splits<W>(N, gN, B, K, sms)
                      : tc128_splits(N, gN, B, K, sms);
}

// The split count of mm for B rows into N columns over a K-deep
// contraction on weights W.
template <class W>
inline int mm_splits(int B, int N, int K, int sms) {
  return use_tc<W>(B, N) ? tc_fwd_splits<W>(N, N, B, K, sms)
                         : fma_splits(N, B, K, sms);
}

// [a | b] @ w (times the column scales of an int8 w, one for both parts)
// + bias into `out`: f32 split partials (ns of them, from mm_splits), or
// with ns == 1 the finished product in f32 or bf16.
template <class Bias, class Out, class W>
inline void mm(XSeg a, XSeg b, const W* w, const Bias* bias, Out* out,
               int B, int N, int ns, cudaStream_t st,
               const float* scale = nullptr) {
  if (use_tc<W>(B, N)) {
    tc_fwd(OpndT<W>{a.x, a.ld, 0, w, N, 0, a.len, scale},
           b.len ? OpndT<W>{b.x, b.ld, 0, w + (size_t)a.len * N, N, 0, b.len,
                            scale}
                 : no_opnd<W>(),
           N, bias, out, N, B, N, ns, st);
  } else if constexpr (std::is_same<W, bf16>::value) {
    mm_kernel<Bias, Out><<<grid_for(N, B, ns), THREADS, 0, st>>>(
        a, b, w, bias, out, B, N, ns);
  }
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
// `parts` holds core_parts floats. Every product runs on the tensor-core
// stage of its batch and weights (tc_fwd) into split partials, the gates
// too (then the update adds their splits); int8 weights with their column
// scales.
template <class W>
inline void core_stages(const CoreT<W>& w, const bf16* deter,
                        const bf16* stoch, bf16* x, bf16* h, bf16* out,
                        float* parts, const CoreSave& save, int B, int D,
                        int H, int S, int A, int g, int sms, float eps,
                        cudaStream_t st) {
  const int dg = D / g, lx = 2 * H + A;
  const OpndT<W> none = no_opnd<W>();
  // Both input projections take one split count, as finish adds them. The
  // 16-row stage counts the tiles of both; the 128-row stage's parts fill
  // the card in each launch.
  const int n1 = rows16<W>(B) ? 2 * H : H;
  const int ns1 = tc_fwd_splits<W>(n1, n1, B, D > S ? D : S, sms);
  tc_fwd(OpndT<W>{deter, D, 0, w.w0, H, 0, D, w.q0}, none, H, w.b0, parts,
         2 * H, B, H, ns1, st);
  tc_fwd(OpndT<W>{stoch, S, 0, w.w1, H, 0, S, w.q1}, none, H, w.b1,
         parts + H, 2 * H, B, H, ns1, st);
  finish(parts, ns1, B, 2 * H, H, 2, w.s0, w.s1, eps, x, lx, save.pre01,
         save.rstd01, st);
  // The hidden layer: GRU block q of the deter against wblk[q], then x
  // against win's columns of block q, each segment with its own scales.
  const int ns2 = tc_fwd_splits<W>(D, dg, B, dg + lx, sms);
  tc_fwd(OpndT<W>{deter, D, dg, w.wblk, dg, (size_t)dg * dg, dg, w.qblk},
         OpndT<W>{x, lx, 0, w.win, D, (size_t)dg, lx, w.qin}, dg, w.bblk,
         parts, D, B, D, ns2, st);
  finish(parts, ns2, B, D, D, 1, w.sh, w.sh, eps, h, D, save.hpre,
         save.rstdh, st);
  const int ns3 = tc_fwd_splits<W>(3 * D, 3 * dg, B, dg, sms);
  tc_fwd(OpndT<W>{h, D, dg, w.wg, 3 * dg, (size_t)dg * 3 * dg, dg, w.qg},
         none, 3 * dg, w.bg, parts, 3 * D, B, 3 * D, ns3, st);
  gru_update(parts, ns3, save.gates, deter, out, B, D, g, st);
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
