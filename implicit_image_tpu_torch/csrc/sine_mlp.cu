// Fused SIREN chain, forward and rematerializing backward, on the tensor
// cores of Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of implicit_image_tpu/ops/sine_mlp.py:
//   sine_mlp_fwd  <- _fwd_kernel / _fwd_call   (ops/sine_mlp.py:81-122)
//   sine_mlp_bwd  <- _bwd_kernel / _bwd_call   (ops/sine_mlp.py:128-242)
//   sum_partials  <- the TPU's sequential accumulation of dW/db across grid
//                    steps, which has no counterpart between parallel blocks
//
// The chain, for one tile of T pixel rows:
//   z_0 = x W_0 + b_0,           a_0 = sin(w0 * z_0)
//   z_l = a_{l-1} W_l + b_l,     a_l = sin(wh * z_l)     l = 1 .. L = D-2
//   out = a_L W_{D-1} + b_{D-1}
// with the polynomial sine of fast_math.cuh.
//
// Bound on an H100 SXM at 512^2 pixels, width 128, depth 8: the hidden
// products are 2*N*H*H*L = 51.5 GFLOP per forward and 3x that per backward
// (recompute a.W, then dW = a^T gz and ga = gz W^T), against a few MB of
// coordinates, cotangents and outputs: arithmetic, not memory. The fp32
// mode's bound counts 3xTF32 (three tensor-core passes at 495 TFLOP/s):
// 0.31 ms forward, 0.94 ms backward at the least.
//
// Forward at width 128 (sine_mlp_fwd_kernel, "the width-128 forward"
// below): the width-128 backward's forward phase (item 1 of the next note),
// product by product the same device functions, so the forward K2
// rematerializes is K1's own: two warpgroups of 64 rows per 128-row tile,
// each product wgmma m64n128k16 bf16 with A (the previous accumulator's
// planes) from registers and W's planes from a ring of bulk copies (the
// forward image of ops/sine_mlp.weight_planes, packed once per K1/K2 pair
// and handed to the backward). Without the z stash and the backward,
// nothing joins the two warpgroups but the ring: no barrier of the block
// in the tile loop, so each warpgroup's sine epilogue runs while the
// other's products are in flight, and an 8-slot ring lets one run up to
// half a layer ahead. The first layer (K = in) and the last (N = out) stay
// on FMA; the last sums each row from the accumulator's registers (a
// thread's 32 columns, then its quad by shuffles) with no shared memory.
//
// Forward at width 192 (sine_mlp_fwd_wg192_kernel, "the width-192 forward"
// below): the same scheme on the width-192 backward's forward phase
// (first_layer_wg, b2_sine, b2_store_planes, and ring_ss_product's passes
// in its order, each wgmma m64n96k16 issued for both column halves), so
// every element sums as K2's recompute does. A 64 x 192 accumulator (96
// registers) leaves no room for three planes of A in registers, so A's
// planes go to shared memory, as in that backward; without the backward's
// z stash, a_s and dW staging the budget holds a 128-row tile whose
// warpgroups each own 64 rows, all 192 columns and their own act_s (64 x
// 192 x 3 planes, 72 KB), beside 4 ring slots of one k-step (18 KB) in
// fp32 (16 slots of 6 KB where W is one bf16 plane). A warp rewrites only
// its own rows of act_s, which its part of the last product alone read, so
// a warpgroup needs only its own named barrier and a proxy fence before its
// next product: no barrier of the block in the tile loop. Each slice of W
// read from L2 serves 128 rows (2.72 GB per fp32 forward at 512^2, d8; 64-
// row tiles would read 5.44 GB). At 512^2, d8 on an H100 it takes 1.16 ms
// of device time in fp32 against its 0.71 ms bound at 192 (PERF.md): the
// products and each warpgroup's own epilogue, which cannot overlap its
// products, hold it; streaming W costs ~2% (kernel_breakdown's knock-outs).

// Backward at width 128 (sine_mlp_bwd_kernel, "the width-128 backward"
// below), one block of 2 warpgroups per SM, persistent over 128-row tiles:
// 1. Products on wgmma, bf16 (hopper.cuh): m64n128k16, A from registers,
//    B from shared memory. A warpgroup holds 64 rows of a tile, and a
//    product's accumulator is the next product's A (a.W down the forward,
//    gz.W^T up the backward), so activations stay in registers. fp32 is
//    three bf16 planes per operand (h, m, l; split_planes), and a product
//    takes the six passes whose planes' orders add up to at most 2 (hh, hm,
//    mh, hl, lh, mm: ~1e-6 relative like 3xTF32, the same tensor time at
//    989 TFLOP/s; tests/test_torch_sine_mlp.py's "6xbf16"). An operand that
//    is a bf16 value already (W, a, x under "+mixed"; all in the bf16 mode,
//    where the one plane is the mode's rounding) has one plane, so the
//    bf16 mode and "+mixed" a.W take one pass. The split is made once per
//    staged operand: W's planes by the wrapper, once a launch
//    (ops/sine_mlp.weight_planes), an activation's once per product.
// 2. Operand layouts. bf16 wgmma reads B N-major or K-major, so one image
//    of W's core matrices serves a.W and gz.W^T; the wrapper cuts it into
//    16-row slices for a.W and 16-column slices for gz.W^T. dW = a^T gz
//    takes A = a^T from a_s (fp32, split per k-step) and B = gz's planes,
//    stored N-major in gz_s by the epilogue that makes gz.
// 3. Copies. W streams through a ring of 4 slots of one 16-row (or column)
//    slice, bulk copies completing on an mbarrier; the last warp done with
//    a slot issues its next fill, so three fills are in flight while a
//    slice computes and no thread waits for a slot to empty. The z stash
//    is stored from registers in the forward and comes back whole into a_s
//    by one bulk copy (thread 0, once every warp is done with a_s). dW_l
//    accumulates from zero per tile, is staged in gz_s with its rows'
//    16-byte chunks turned by row % 8 (no bank conflicts; the wrapper turns
//    them back) and added into the block's partial by one bulk reduce-add
//    (cp.reduce.async.bulk .add.f32); thread 0 waits for the previous one
//    to finish first, so the adds into a slice happen in tile order. The
//    small gradients (dW_0, dW_{D-1}, db) are added with red.global from
//    the thread that owns them, tile after tile. No thread waits on a
//    synchronous load of a partial.
// 4. Overlap. The re-sine of z_{l-1} (sin into a_s, the derivative into
//    registers) runs while the second half of gz_l W_l^T's slices compute.
//    Everything else runs between products: the block has no producer
//    warp, because a 9th warp caps every thread at 168 registers (three
//    warps share an SMSP's 16K), where the two warpgroups' accumulators
//    and operand planes spill; with 8 warps ptxas gives them 255.
// 5. Tails. Bias sums are warp reductions (shuffles over a warp's 16 rows,
//    then the 8 warps in order). The first layer (K = in), the last (N =
//    out) and dx stay on FMA, over all threads.
// tools/kernel_breakdown.py knocks out the parts; PERF.md has the times.
//
// Widths: the designs above are the width-128 kernels' (every model of
// width <= 128 runs on them, zero-padded). Widths 129-192 run on the
// kernels of width 192, on wgmma, which stream each W in slices and whose
// backward sums its dW (sections "the width-192 kernels", "the width-192
// backward" and "the width-192 forward" below); every width above 192 on
// the layer-wise kernels, a launch a layer ("the layer-wise kernels").
//
// Backward: blocks run in parallel with no carry between them, so a fixed
// grid of one block per SM loops over its share of tiles, adding into its
// own slice of a partial-gradient buffer; sum_partials adds the slices in a
// fixed order. No block adds into another's slice, and the adds into an
// address of a slice come in tile order: a run repeats bit for bit.
//
// sum_partials, the column sum of that (B, P) buffer (B = 132 slices of
// P = 99,844 floats at the shapes above), moves 53 MB and computes next to
// nothing: 0.016 ms at 3.35 TB/s. Its order: the rows split into G =
// min(kSumGroups, B) groups, group g holding rows [g B / G, (g + 1) B / G);
// each group's sum starts at 0 and adds its rows in index order, and the
// group sums are added in group order (sum_partials_reference in
// ops/sine_mlp.py adds in the same order). The design is at the kernel.
//
// Over a member axis (sine_mlp_fwd_batched): the forward of M models of one
// shape in one launch, the counterpart of the jax.vmap over the render that
// decode_runs compiles. The grid's y dimension indexes the member; member
// m's packed weights sit m member-strides after member 0's, its x at m
// x-strides (0: one x for all) and its out at m * n * out floats. Each
// block runs the single launch's code on its member's operands, so every
// row takes the single launch's k-step order: M single launches' bits. It is
// a template instantiation of each forward (MB), so the single launch's
// code is the one it was; every mode has one, mixed precision (MX) too (the
// batched fit's "+mixed" steps). An MB block reads its member's pointers
// from shared memory (MemberFwd), as the batched backward does.
// The backward over a member axis (sine_mlp_bwd_batched, the jax.vmap of
// K2 in the batched fit and the density ladder) is the same: an MB
// instantiation of sine_mlp_bwd_kernel and sine_mlp_bwd_wg192_kernel, grid
// y = member (sum_partials_kernel's MB instantiation too, or the members'
// columns as one flat range: its note). Member m's g and dx sit m * n * out
// and m * n * in floats on, its z stash and partial slices m * gridDim.x
// slices on;
// sum_partials adds each member's slices in the single launch's order. Each
// member gets its single launch's bits, in every mode, as the forward.
//
// Rows: the kernels index rows with int (tile * T, row0 + r), so a launch
// takes at most kMaxRows = INT_MAX - 127 rows (n + T - 1 must not wrap);
// the launchers refuse more, and ops/sine_mlp.py raises before them.
//
// Every launcher returns the cudaError_t of its launch (0 on success).
//
// The library is this file compiled in parts, all at once, and linked
// (ops/cuda_build.py): with -DSINE_MLP_WIDE=192 (the width of
// SINE_MLP_WIDE_GEOS) and -DSINE_MLP_PART=0 or 1, the forward or backward
// kernels of width 192 and their C launcher; with -DSINE_MLP_LAYER=0, 1 or
// 2, a layer-wise kernel and its launcher; without, the width-128 kernels,
// sum_partials and the C interface, which calls the width-192 launchers.

#include <cuda.h>  // the tensor-map types (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "fast_math.cuh"
#include "hopper.cuh"

namespace {

constexpr int H = 128;          // hidden width the kernels are built for
constexpr int T = 128;          // pixel rows per tile
constexpr int BUF = T * H;      // floats in one shared matrix buffer
constexpr int THREADS = 256;    // 8 warps: 4 row groups x 2 column halves
constexpr int MAX_IO = 8;       // largest input / output width
constexpr int kMaxRows = INT_MAX - 127;  // rows a forward launch takes (see the top)
constexpr size_t kMaxSmem = 232448;      // a block's shared memory on sm_90
static_assert(T == H, "one buffer size serves activations and weights");

// The geometry of a kernel width: HW hidden units, TR pixel rows per tile,
// KSL rows of W per ring slice, NBR slices in the ring. The warps cover a
// TR x HW tile in 32 x 64 pieces, so every thread holds 2 x 8 mma tiles at
// every width.
template <int HW, int TR, int KSL, int NBR = 2>
struct Geo {
  static constexpr int H = HW, T = TR, KS = KSL, NB = NBR;
  static constexpr int CG = H / 64;              // warps across a tile's columns
  static constexpr int WARPS = (T / 32) * CG;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BUF = T * H;              // floats in an activation tile
  static constexpr int SLICE = KS * H;           // floats in a ring slice
  static constexpr int NS = H / KS;              // slices per W
  static_assert(H % 64 == 0 && T % 32 == 0 && H % KS == 0 && KS % 16 == 0,
                "tiles of whole warps and k-steps");
};
using G128 = Geo<H, T, H>;  // the width-128 kernels: a ring slice is a whole W
static_assert(G128::THREADS == THREADS && G128::BUF == BUF && G128::SLICE == BUF, "");
// The fused kernels above width 128 ("the width-192 kernels" below).
// X(width, backward tile rows, ring slice rows and ring slices) for each: the
// one list of the wider fused widths (ops/sine_mlp.KERNEL_TILE_ROWS mirrors
// width and backward tile rows); every width above the last runs on the
// layer-wise kernels (LW_MIN).
#define SINE_MLP_WIDE_GEOS(X) X(192, 64, 64, 2)
template <int W>
struct WideGeo;  // the backward's geometry of each listed width; no other width has one
#define SINE_MLP_GEO(W, TR, KS, NB) \
  template <>                       \
  struct WideGeo<W> {               \
    using bwd = Geo<W, TR, KS, NB>; \
  };
SINE_MLP_WIDE_GEOS(SINE_MLP_GEO)
#undef SINE_MLP_GEO

struct Chain {
  const float* w0;   // (in, H)
  const float* wm;   // (D-2, H, H)
  const float* wmt;  // W's bf16 planes (ops/sine_mlp.weight_planes): the wgmma kernels' B
  const float* wl;   // (H, out)
  const float* bs;   // (D-1, H)
  const float* bl;   // (out,)
  int n, in_size, out_size, depth;
  float omega0, omega_h;
};

// A batched forward's member (MB), in shared memory: its chain (weights
// packed at the kernel width HW, as a single launch takes them), x at
// x_stride floats per member and out at n * out_size. The kernels read
// these pointers where they use them, as the batched backward reads
// MemberBwd's: held in registers for the whole kernel they made ptxas spill
// the mixed-precision forward.
struct MemberFwd {
  Chain c;
  const float* x;
  float* out;
};

// Thread 0 fills mf for member blockIdx.y. Call before anything reads mf,
// then __syncthreads.
template <int HW>
__device__ __forceinline__ void member_fwd(MemberFwd& mf, const Chain& c, const float* x,
                                           float* out, long long x_stride) {
  if (threadIdx.x == 0) {
    const long long m = blockIdx.y;
    mf.c = c;
    mf.c.w0 += m * c.in_size * HW;
    mf.c.wm += m * (c.depth > 2 ? c.depth - 2 : 1) * (long long)HW * HW;
    mf.c.wl += m * HW * c.out_size;
    mf.c.bs += m * (c.depth - 1) * HW;
    mf.c.bl += m * c.out_size;
    mf.x = x + m * x_stride;
    mf.out = out + m * c.n * (long long)c.out_size;
  }
}

// A batched backward's member (MB), in shared memory: its chain (weights
// packed at the kernel width HW; the kernels find their member's W planes
// from the launch's own pointer), x at x_stride floats per member, g and dx at n * out_size and n * in_size. The kernels read these
// pointers where they use them: held in registers for the whole kernel, as
// the batched forward holds its own, they made ptxas spill the batched
// backward (up to 364 B a thread at width 512, in an earlier kernel) where
// the single launch reads them from its parameters.
struct MemberBwd {
  Chain c;
  const float* x;
  const float* g;
  float* dx;
};

// Thread 0 fills mb for member blockIdx.y; every thread moves its z stash and
// partial slices to its member's gridDim.x slices (TR x HW rows per stashed
// layer). Call before anything reads mb or these, then __syncthreads.
template <int HW, int TR, class PZ, class PP>
__device__ __forceinline__ void member_bwd(MemberBwd& mb, const Chain& c, const float* x,
                                           const float* g, float* dx, PZ& z_all, PP& partials,
                                           int n_part, long long x_stride) {
  const long long m = blockIdx.y;
  const int L = c.depth - 2;
  if (threadIdx.x == 0) {
    const long long wm = m * (L > 0 ? L : 1) * (long long)HW * HW;
    mb.c = c;
    mb.c.w0 += m * c.in_size * HW;
    mb.c.wm += wm;
    mb.c.wl += m * HW * c.out_size;
    mb.c.bs += m * (c.depth - 1) * HW;
    mb.x = x + m * x_stride;
    mb.g = g + m * c.n * (long long)c.out_size;
    mb.dx = dx + m * c.n * (long long)c.in_size;
  }
  z_all += m * gridDim.x * (L > 1 ? L - 1 : 1) * (long long)TR * HW;
  partials += m * gridDim.x * (long long)n_part;
}

// The chain a block reads: its parameter, or (MB) its member's.
template <bool MB, class Member>
__device__ __forceinline__ const Chain& chain_of(const Member& mb, const Chain& c) {
  if constexpr (MB) return mb.c;
  else return c;
}

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// An activation as the chain keeps it: rounded to bf16 in the bf16 mode and
// under mixed precision (MX, the JAX package's compute_dtype=bfloat16),
// which casts every activation to bf16, and so the cotangent of each in the
// backward, in either mode; the wrappers round x, W, b on the way
// in and dW, db on the way out. MX is a template flag, not a runtime one:
// the kernels without it keep their registers (a runtime flag made the fp32
// backward spill and run 13-26% slower on an H100) and their bits.
template <bool BF16, bool MX>
__device__ __forceinline__ float rnd_act(float v) {
  return rnd<BF16 || MX>(v);
}

// ------------------------------------------------------------------ PTX

// Element (r, c) of a T x H matrix in shared memory. Rows are not padded;
// 8-float pieces of a row are permuted by an XOR of column bits 3-4 with
// h(r & 7) = 2 b1 + (b0 ^ b2), which takes 4 distinct values on rows
// {0-3}, {4-7}, {0,2,4,6} and {1,3,5,7}: so a warp's loads of rows from
// the lane's group g and column pairs from its index t, or rows from t and
// columns from g, hit 32 different banks. Row strides S other than H are
// multiples of 32 floats, so every row starts on bank 0 and the pattern
// holds.
__device__ __forceinline__ int swz(int r) { return ((r & 2) << 3) | (((r ^ (r >> 2)) & 1) << 3); }
template <int S = H>
__device__ __forceinline__ int sw(int r, int c) { return r * S + (c ^ swz(r)); }

// Stage T rows of a (n, width) input into dst (T x MAX_IO), zero beyond n
// rows and width columns.
template <bool BF16, class G = G128>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, const float* __restrict__ src,
                                           int row0, int n, int width, int tid) {
  for (int e = tid; e < G::T * MAX_IO; e += G::THREADS) {
    const int r = e / MAX_IO, k = e % MAX_IO;
    const int row = row0 + r;
    dst[e] = (row < n && k < width) ? rnd<BF16>(src[(size_t)row * width + k]) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[r][o] = sum_k src_s[r][k] * rnd(w(k, o)) (+ bias[o]) for the tile's
// rows below n, w(k, o) = w[k * sk + o * so] and o < no <= MAX_IO. Warp w
// takes rows 16 w .. 16 w + 15; lane i sums columns i + 32 j and the warp
// adds the lanes (a fixed order).
template <bool BF16>
__device__ __forceinline__ void rows_times_narrow(const float* __restrict__ src_s,
                                                  const float* __restrict__ wg, int sk, int so,
                                                  int no, const float* __restrict__ bias,
                                                  float* __restrict__ dst, int row0, int n,
                                                  int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  float wv[4][MAX_IO];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < MAX_IO; ++o)
      wv[j][o] = o < no ? rnd<BF16>(__ldg(&wg[(lane + 32 * j) * sk + o * so])) : 0.f;
  const float b = (bias != nullptr && lane < no) ? __ldg(&bias[lane]) : 0.f;
  for (int i = 0; i < T / 8; ++i) {
    const int r = warp * (T / 8) + i;
    float sv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sv[j] = src_s[sw(r, lane + 32 * j)];
    float mine = 0.f;
#pragma unroll
    for (int o = 0; o < MAX_IO; ++o) {
      if (o < no) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) p += sv[j] * wv[j][o];
        p = warp_sum(p);
        if (lane == o) mine = p;
      }
    }
    if (lane < no && row0 + r < n) dst[(size_t)(row0 + r) * no + lane] = mine + b;
  }
}

// ------------------------------------------- the width-128 backward (wgmma)
//
// Its design is the header note's "Backward at width 128". A consumer
// thread's share of a 128-row tile is that of a wgmma accumulator: warpgroup
// wg (0, 1) holds rows 64 wg .. 64 wg + 63, its warp wi rows 16 wi .. of
// those, and d[4 ni + q] is the element at
//   row 64 wg + 16 wi + g + 8 (q >> 1),  column 8 ni + 2 t + (q & 1)
// (g = lane / 4, t = lane % 4; hopper.cuh's wg_bf16_n128).

constexpr int BW_KS = 16;             // W rows (the products' K) of a ring slice: one k-step
constexpr int BW_NS = H / BW_KS;      // slices of one W
constexpr int BW_NB = 4;              // ring slots
constexpr int BW_PLANE = BW_KS * H;   // bf16 values in one plane of a slice (8 KB)
constexpr int BW_THREADS = 256;       // two warpgroups
constexpr int BW_WARPS = BW_THREADS / 32;
constexpr int BW_RED = BW_WARPS;      // bias-sum row groups: one per warp

// Byte offsets of the backward's shared memory: the ring (BW_NB slots of up
// to 3 planes), gz_s (gz's 3 planes for dW; then dW staged for its
// reduce-add; at the tile's end rnd(gz_0) in fp32, sw() layout), a_s (z
// copied back from the stash, then a, fp32: two 64-column halves in the
// sw<64>() layout), the input and cotangent tiles, the bias sums and the
// mbarriers.
constexpr size_t kBwRing = 0;
constexpr size_t kBwGz = kBwRing + (size_t)BW_NB * 3 * BW_PLANE * 2;
constexpr size_t kBwA = kBwGz + (size_t)3 * T * H * 2;
constexpr size_t kBwX = kBwA + (size_t)T * H * 4;
constexpr size_t kBwGo = kBwX + (size_t)T * MAX_IO * 4;
constexpr size_t kBwRed = kBwGo + (size_t)T * MAX_IO * 4;
constexpr size_t kBwBar = kBwRed + (size_t)BW_RED * H * 4;
enum BwBar { kFull = 0, kZFull = BW_NB, kGzFree, kBwBars };
// after the mbarriers: per ring slot, the warps done with its current fill
constexpr size_t kBwCount = kBwBar + kBwBars * sizeof(uint64_t);
constexpr size_t kBwdSmem = kBwCount + BW_NB * sizeof(int);

// Planes of each operand (hopper.cuh's split_planes): three where the value
// is fp32, one where it is a bf16 value already (W, a and x under MX; every
// operand in the bf16 mode, where the one plane is the rounding the mode
// makes). The wrapper packs W's (ops/sine_mlp._weight_planes).
template <bool BF16, bool MX>
struct BwPlanes {
  static constexpr int W = (BF16 || MX) ? 1 : 3, A = W, G = BF16 ? 1 : 3;
};

struct WgPos {
  int wg, wi, g, t;
  __device__ __forceinline__ explicit WgPos(int tid)
      : wg(tid >> 7), wi((tid >> 5) & 3), g((tid & 31) >> 2), t(tid & 3) {}
  __device__ __forceinline__ int row(int h) const { return 64 * wg + 16 * wi + g + 8 * h; }
  __device__ __forceinline__ int col(int ni) const { return 8 * ni + 2 * t; }
};

// a_s element (r, c): column half c / 64, sw<64>() inside it. The z stash
// holds each z tile in this layout, so a bulk copy brings it back whole.
__device__ __forceinline__ int as_idx(int r, int c) { return (c >> 6) * (T * 64) + sw<64>(r, c & 63); }

__device__ __forceinline__ void cons_sync() { iit::named_barrier(1, BW_THREADS); }

// dw's staging row i, column j (floats): the 16-byte chunks of a row turned
// by i % 8, so a warp's stores of 8 rows hit every bank; the reduce-add
// carries the turn into the partial (the wrapper turns it back,
// ops/sine_mlp._unturn_dw).
__device__ __forceinline__ int dw_stage_idx(int i, int j) {
  return i * H + ((((j >> 2) + (i & 7)) & 31) << 2) + (j & 3);
}

// a[p][kk] = plane p of the A fragment of k-step kk, from an accumulator
// (its columns are the next product's K).
template <int NP>
__device__ __forceinline__ void planes_of(const float (&d)[64], uint32_t (&a)[NP][8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t p[NP];
      iit::split_planes<NP>(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1], p);
#pragma unroll
      for (int i = 0; i < NP; ++i) a[i][kk][j] = p[i];
    }
}

template <int NP, int KS>
__device__ __forceinline__ void fence_planes(uint32_t (&a)[NP][KS][4]) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int k = 0; k < KS; ++k) iit::fence_regs(a[i][k]);
}

// One k-step: d (+)= the sum over passes (i, j), i + j <= 2, of A_i B_j,
// small terms first; A_i = a[i][kk], B_j the 16 x 128 block at shared
// address b0 + j * bstride. FIRST: the step's first pass ignores d.
template <int PA, int PB, int TB, int KS>
__device__ __forceinline__ void wg_passes(float (&d)[64], const uint32_t (&a)[PA][KS][4], int kk,
                                          uint32_t b0, uint32_t bstride, bool first) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i <= s; ++i)
      if (i < PA && s - i < PB) {
        iit::wg_bf16_n128<TB>(d, a[i][kk], iit::wg_desc(b0 + (s - i) * bstride), first ? 0 : 1);
        first = false;
      }
}

// The layout of a wgmma kernel's ring of W slices in the block's shared
// memory: NB slots of SLOT bytes (one k-step, BW_KS rows or columns of W, of
// up to SLOT_PLANES planes) from byte RING, the slots' mbarriers from byte
// BAR and, per slot, the count of warps done with its fill from byte COUNT.
// Per tile the kernel walks W_1 .. W_L in the forward image and, with IMAGES
// = 2, then W_L .. W_1 in the backward image, NS slices each.
template <int HW_, int NB_, size_t RING_, size_t BAR_, size_t COUNT_, int IMAGES_,
          int SLOT_PLANES = 3>
struct RingLayout {
  static constexpr int HW = HW_, NB = NB_, IMAGES = IMAGES_;
  static constexpr int NS = HW / BW_KS;     // slices of one W
  static constexpr int PLANE = BW_KS * HW;  // bf16 values in one plane of a slice
  static constexpr size_t SLOT = SLOT_PLANES * (size_t)PLANE * 2, RING = RING_, BAR = BAR_,
                          COUNT = COUNT_;
};
using BwRingLayout = RingLayout<H, BW_NB, kBwRing, kBwBar + kFull * sizeof(uint64_t), kBwCount, 2>;

// The ring: use q of the block reads slot q % NB, the (q / NB)-th fill of
// that slot. The last warp to finish with a fill issues the slot's next
// one, a bulk copy completing on the slot's mbarrier; no thread waits for a
// slot to empty.
template <int NP, class R>  // planes of W, the ring's layout
struct WgRing {
  uint8_t* smem;                 // the block's shared memory
  const __nv_bfloat16* planes;   // the block's images (ops/sine_mlp.weight_planes)
  int L, total;                  // hidden layers, uses in the launch
  int use = 0;

  __device__ __forceinline__ uint8_t* slot(int b) const { return smem + R::RING + b * R::SLOT; }
  __device__ __forceinline__ uint64_t* bar(int b) const {
    return reinterpret_cast<uint64_t*>(smem + R::BAR) + b;
  }

  // Thread 0: the slots' mbarriers and counts (then a barrier of the block).
  __device__ __forceinline__ void init() const {
    for (int b = 0; b < R::NB; ++b) {
      iit::mbar_init(bar(b), 1);
      reinterpret_cast<int*>(smem + R::COUNT)[b] = 0;
    }
  }

  // Fill slot q % NB with use q's slice (one thread).
  __device__ __forceinline__ void fill(int q) const {
    const int per_tile = R::IMAGES * L * R::NS, j = q % per_tile;
    const bool fwd = j < L * R::NS;
    const int layer = fwd ? j / R::NS : 2 * L - 1 - j / R::NS;  // l - 1
    const int b = q % R::NB;
    constexpr uint32_t bytes = NP * R::PLANE * 2;
    iit::mbar_expect_tx(bar(b), bytes);
    iit::bulk_g2s(slot(b),
                  planes + ((size_t)((fwd ? 0 : L) + layer) * R::NS + j % R::NS) * NP * R::PLANE,
                  bytes, bar(b));
  }

  // The warp is done with use q's slot (its products have completed).
  __device__ __forceinline__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const int b = q % R::NB;
      int* done = reinterpret_cast<int*>(smem + R::COUNT);
      if (atomicAdd(done + b, 1) == BW_WARPS - 1) {
        done[b] = 0;
        if (q + R::NB < total) fill(q + R::NB);
      }
    }
  }
};

// d = A W over K = 128: A's planes in registers, W's NS slices from the
// ring (TB = 1: the forward image, B N-major, a.W; TB = 0: the backward
// image, K-major, gz.W^T). A slice's slot is released once its products are
// done; the next slice's products are issued before that.
template <int PA, int PB, int TB, class R>
__device__ __forceinline__ void ring_wg_product(float (&d)[64], uint32_t (&a)[PA][8][4],
                                                WgRing<PB, R>& ring) {
  static_assert(R::HW == H && BW_KS == 16, "a slice is one k-step of a 128-wide product");
  iit::wg_fence();
#pragma unroll
  for (int u = 0; u < R::NS; ++u, ++ring.use) {
    const int b = ring.use % R::NB;
    iit::mbar_wait(ring.bar(b), (ring.use / R::NB) & 1);
    const uint32_t slot = iit::smem_u32(ring.slot(b));
    wg_passes<PA, PB, TB, 8>(d, a, u, slot, R::PLANE * 2, u == 0);
    iit::wg_commit();
    if (u > 0) {
      iit::wg_wait<1>();
      ring.release(ring.use - 1);
    }
  }
  iit::wg_wait<0>();
  ring.release(ring.use - 1);
  iit::fence_regs(d);
  fence_planes(a);
}

// dw = a^T gz over the tile's 128 rows for the warpgroup's 64 columns of a
// (rows of dW): A from a_s (columns of the warpgroup's half, split into
// planes per k-step), B = gz's planes in gz_s (N-major: k = row, n = column).
// The next k-step's A loads while this one's products run.
template <int PA, int PB>
__device__ __forceinline__ void dw_product(float (&dw)[64], const float* __restrict__ a_s,
                                           uint32_t gz_base, const WgPos& p) {
  const float* ah = a_s + p.wg * (T * 64);
  const int c0 = 16 * p.wi + p.g;
  uint32_t ak[2][PA][1][4];
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * kk + 2 * p.t + 8 * (j >> 1), c = c0 + 8 * (j & 1);
      uint32_t pl[PA];
      iit::split_planes<PA>(ah[sw<64>(r, c)], ah[sw<64>(r + 1, c)], pl);
#pragma unroll
      for (int i = 0; i < PA; ++i) ak[kk & 1][i][0][j] = pl[i];
    }
    iit::wg_fence();
    wg_passes<PA, PB, 1, 1>(dw, ak[kk & 1], 0, gz_base + kk * 4096, T * H * 2, kk == 0);
    iit::wg_commit();
    if (kk > 0) {
      iit::wg_wait<1>();
      fence_planes(ak[(kk - 1) & 1]);
    }
  }
  iit::wg_wait<0>();
  fence_planes(ak[1]);
  iit::fence_regs(dw);
}

// d = x W_0 at the thread's positions (FMA, K = in_size, in order of k;
// xv(r, k) gives x at tile row r, rounded as the mode takes it). Pos is a
// kernel's position type (row(h), col(ni)), HW its width.
template <bool BF16, int HW = H, int N4, class XV, class Pos>
__device__ __forceinline__ void first_layer_wg(float (&d)[N4], const Chain& c, XV xv,
                                               const Pos& p) {
#pragma unroll
  for (int i = 0; i < N4; ++i) d[i] = 0.f;
  for (int k = 0; k < c.in_size; ++k) {
    const float x0 = xv(p.row(0), k), x1 = xv(p.row(1), k);
#pragma unroll
    for (int ni = 0; ni < N4 / 4; ++ni) {
      const float2 wv = __ldg(reinterpret_cast<const float2*>(c.w0 + k * HW + p.col(ni)));
      const float w0 = rnd<BF16>(wv.x), w1 = rnd<BF16>(wv.y);
      d[4 * ni] += x0 * w0;
      d[4 * ni + 1] += x0 * w1;
      d[4 * ni + 2] += x1 * w0;
      d[4 * ni + 3] += x1 * w1;
    }
  }
}

// z = d + bias; d = a = rnd(sin(omega z)) (rounded also under MX); STASH
// also stores z at z_g (an image of a_s), past L1 (.cg: the backward ran
// faster on an H100 than with the default store).
template <bool BF16, bool MX, bool STASH>
__device__ __forceinline__ void wg_sine(float (&d)[64], const float* __restrict__ bias,
                                        float omega, float* __restrict__ z_g, const WgPos& p) {
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    const int c = p.col(ni);
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = p.row(h);
      const float z0 = d[4 * ni + 2 * h] + b.x, z1 = d[4 * ni + 2 * h + 1] + b.y;
      if (STASH) __stcg(reinterpret_cast<float2*>(&z_g[as_idx(r, c)]), make_float2(z0, z1));
      d[4 * ni + 2 * h] = rnd_act<BF16, MX>(iit::fast_sin(omega * z0));
      d[4 * ni + 2 * h + 1] = rnd_act<BF16, MX>(iit::fast_sin(omega * z1));
    }
  }
}

// The last sine layer: z = d + bias; a_s = rnd(sin(omega z)); d = omega
// cos(omega z).
template <bool BF16, bool MX>
__device__ __forceinline__ void wg_sine_last(float (&d)[64], const float* __restrict__ bias,
                                             float omega, float* __restrict__ a_s,
                                             const WgPos& p) {
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    const int c = p.col(ni);
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = p.row(h);
      const float z0 = d[4 * ni + 2 * h] + b.x, z1 = d[4 * ni + 2 * h + 1] + b.y;
      *reinterpret_cast<float2*>(&a_s[as_idx(r, c)]) = make_float2(
          rnd_act<BF16, MX>(iit::fast_sin(omega * z0)), rnd_act<BF16, MX>(iit::fast_sin(omega * z1)));
      d[4 * ni + 2 * h] = omega * iit::fast_cos(omega * z0);
      d[4 * ni + 2 * h + 1] = omega * iit::fast_cos(omega * z1);
    }
  }
}

// red[warp][column] = the sum of d over the warp's 16 rows (two fixed-order
// terms, then shuffles across the lanes that share a column).
__device__ __forceinline__ void wg_bias_sums(const float (&d)[64], float* __restrict__ red,
                                             const WgPos& p) {
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    float s[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      float v = d[4 * ni + cc] + d[4 * ni + 2 + cc];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      s[cc] = v;
    }
    if (p.g == 0)
      *reinterpret_cast<float2*>(&red[(4 * p.wg + p.wi) * H + p.col(ni)]) = make_float2(s[0], s[1]);
  }
}

// *p += v in the block's partial slice without waiting for it: a reduction
// done by the memory system (red.global.add.f32). Every add into an address
// comes from the same thread, tile after tile, so they take effect in tile
// order: a run repeats bit for bit.
__device__ __forceinline__ void add_to(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

// db += the BW_RED row groups' sums in red, in order. Call after a barrier.
__device__ __forceinline__ void add_bias_sums(const float* __restrict__ red, float* __restrict__ db,
                                              int tid) {
  if (tid < H) {
    float s = red[tid];
#pragma unroll
    for (int q = 1; q < BW_RED; ++q) s += red[q * H + tid];
    add_to(db + tid, s);
  }
}

// gz_L = rnd(rnd(g) Wl^T) * dc at the thread's positions (dc in d; the
// inner rnd under MX), its bias sums into red.
template <bool BF16, bool MX>
__device__ __forceinline__ void last_gz_wg(float (&d)[64], const Chain& c,
                                           const float* __restrict__ go_s,
                                           float* __restrict__ red, const WgPos& p) {
  const int out_size = c.out_size;
#pragma unroll
  for (int ni = 0; ni < 16; ++ni)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int col = p.col(ni) + cc;
      float wv[MAX_IO];
#pragma unroll
      for (int o = 0; o < MAX_IO; ++o)
        wv[o] = o < out_size ? rnd<BF16>(__ldg(&c.wl[col * out_size + o])) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = p.row(h);
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < MAX_IO; ++o)
          if (o < out_size) s += rnd<BF16>(go_s[r * MAX_IO + o]) * wv[o];
        d[4 * ni + 2 * h + cc] = rnd<MX>(s) * d[4 * ni + 2 * h + cc];
      }
    }
  wg_bias_sums(d, red, p);
}

// The last layer's weight and bias gradients: dWl += a_L^T rnd(g) over the
// tile (a_L in a_s), dbl += sum g, db_L += the bias sums of gz_L in red.
// Call after a barrier.
template <bool BF16>
__device__ __noinline__ void last_layer_sums(const Chain& c, const float* __restrict__ a_s,
                                                const float* __restrict__ go_s,
                                                const float* __restrict__ red,
                                                float* __restrict__ part, int tid) {
  const int out_size = c.out_size, L = c.depth - 2;
  float* dwl = part + c.in_size * H + L * H * H;
  float* dbs = dwl + H * out_size;
  float* dbl = dbs + (c.depth - 1) * H;
  for (int e = tid; e < H * out_size; e += BW_THREADS) {
    const int k = e % H, o = e / H;
    float s = 0.f;
    for (int r = 0; r < T; ++r) s += a_s[as_idx(r, k)] * rnd<BF16>(go_s[r * MAX_IO + o]);
    add_to(dwl + k * out_size + o, s);
  }
  const int lane = tid & 31;
  for (int o = tid >> 5; o < out_size; o += BW_WARPS) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < T / 32; ++j) s += go_s[(lane + 32 * j) * MAX_IO + o];
    s = warp_sum(s);
    if (lane == 0) add_to(dbl + o, s);
  }
  add_bias_sums(red, dbs + L * H, tid);
}

// a_s = rnd(sin(omega z)) and d = rnd(d) * omega cos(omega z) (the inner
// rnd under MX): gz of the layer below from its ga. z is in a_s (copied
// there from the stash), or (FROM_X) z = x W_0 + b_0, recomputed.
template <bool BF16, bool MX, bool FROM_X>
__device__ __forceinline__ void resine_wg(float (&d)[64], const Chain& c,
                                          const float* __restrict__ x_s, float omega,
                                          float* __restrict__ a_s, const WgPos& p) {
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    const int col = p.col(ni);
    float2 b = make_float2(0.f, 0.f);
    if (FROM_X) b = __ldg(reinterpret_cast<const float2*>(c.bs + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = p.row(h);
      float2 z;
      if (FROM_X) {
        z = make_float2(0.f, 0.f);
        for (int k = 0; k < c.in_size; ++k) {
          const float2 wv = __ldg(reinterpret_cast<const float2*>(c.w0 + k * H + col));
          const float xv = x_s[r * MAX_IO + k];
          z.x += xv * rnd<BF16>(wv.x);
          z.y += xv * rnd<BF16>(wv.y);
        }
        z.x += b.x;
        z.y += b.y;
      } else {
        z = *reinterpret_cast<const float2*>(&a_s[as_idx(r, col)]);
      }
      d[4 * ni + 2 * h] = rnd<MX>(d[4 * ni + 2 * h]) * (omega * iit::fast_cos(omega * z.x));
      d[4 * ni + 2 * h + 1] = rnd<MX>(d[4 * ni + 2 * h + 1]) * (omega * iit::fast_cos(omega * z.y));
      *reinterpret_cast<float2*>(&a_s[as_idx(r, col)]) = make_float2(
          rnd_act<BF16, MX>(iit::fast_sin(omega * z.x)), rnd_act<BF16, MX>(iit::fast_sin(omega * z.y)));
    }
  }
}

// gz's planes into gz_s for dW: plane i of element (k = row r, n = column j)
// in the N-major core-matrix layout of hopper.cuh, one bf16 pair a store.
template <int NP>
__device__ __forceinline__ void store_gz_planes(uint8_t* __restrict__ gz_s,
                                                const uint32_t (&a)[NP][8][4], const WgPos& p) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = p.row(j & 1), n = 16 * kk + 8 * (j >> 1) + 2 * p.t;
      const int at = ((r >> 3) * 16 + (n >> 3)) * 128 + (r & 7) * 16 + (n & 7) * 2;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        *reinterpret_cast<uint32_t*>(gz_s + i * (T * H * 2) + at) = a[i][kk][j];
    }
}

// The stash's z tile for the next layer down into a_s (thread 0).
__device__ __forceinline__ void z_copy(float* a_s, const float* z, uint64_t* bar) {
  iit::mbar_expect_tx(bar, T * H * 4);
  iit::bulk_g2s(a_s, z, T * H * 4, bar);
}

// dW_l, staged in gz_s, added into the block's partial (thread 0).
__device__ __forceinline__ void reduce_dw(float* dw, const uint8_t* gz_s) {
  iit::bulk_reduce_add(dw, gz_s, H * H * 4);
}

// The tails run out of line (last_layer_sums too): inlined, they made ptxas
// spill the bf16+mixed backward over the member axis (24 B).
template <bool BF16>
__device__ __noinline__ void dx_tail(const float* g_s, const float* w0, int in_size, float* dx,
                                     int row0, int n, int tid) {
  rows_times_narrow<BF16>(g_s, w0, 1, H, in_size, nullptr, dx, row0, n, tid);
}

template <bool BF16, bool MX, bool MB>
__global__ void __launch_bounds__(BW_THREADS, 1)
sine_mlp_bwd_kernel(Chain c_arg, const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ dx, float* __restrict__ z_all,
                    float* __restrict__ partials, int n_part, long long x_stride) {
  using P = BwPlanes<BF16, MX>;
  __shared__ MemberBwd mb;
  if constexpr (MB) {
    member_bwd<H, T>(mb, c_arg, x, g, dx, z_all, partials, n_part, x_stride);
    __syncthreads();
  }
  const Chain& c = chain_of<MB>(mb, c_arg);
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* gz_s = smem + kBwGz;
  float* a_s = reinterpret_cast<float*>(smem + kBwA);
  float* x_s = reinterpret_cast<float*>(smem + kBwX);
  float* go_s = reinterpret_cast<float*>(smem + kBwGo);
  float* red = reinterpret_cast<float*>(smem + kBwRed);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kBwBar);
  const int tid = threadIdx.x;
  const int L = c.depth - 2;
  const int n_tiles = (c.n + T - 1) / T;

  // this block's slices: partial gradients (zeroed; the reduce-adds below
  // add through the async proxy) and the z stash (z_1 .. z_{L-1})
  float* part = partials + (size_t)blockIdx.x * n_part;
  float* z_g = z_all + (size_t)blockIdx.x * (L > 1 ? L - 1 : 1) * T * H;
  for (int e = tid; e < n_part; e += BW_THREADS) part[e] = 0.f;
  iit::fence_async_global();
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // member m's images m apart
  const __nv_bfloat16* planes = reinterpret_cast<const __nv_bfloat16*>(c_arg.wmt) +
                                (MB ? (size_t)blockIdx.y * 2 * L * BW_NS * P::W * BW_PLANE : 0);
  WgRing<P::W, BwRingLayout> ring{smem, planes, L, my_tiles * 2 * L * BW_NS};
  if (tid == 0) {
    ring.init();
    iit::mbar_init(bar + kZFull, 1);
    iit::mbar_init(bar + kGzFree, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < BW_NB && q < ring.total; ++q) ring.fill(q);

  // Thread 0 issues the block's other copies: z_{l-1} into a_s for layer
  // l's backward once every warp is done with a_s, and dW_l's reduce-add
  // into the partial once staged, one add in flight (so the adds into a
  // slice go in tile order: a run repeats bit for bit).
  const auto X = [&] { if constexpr (MB) return mb.x; else return x; };
  const auto G_ = [&] { if constexpr (MB) return mb.g; else return g; };
  const auto DX = [&] { if constexpr (MB) return mb.dx; else return dx; };
  const WgPos p(tid);
  const uint32_t gz_addr = iit::smem_u32(gz_s);
  float* g_s = reinterpret_cast<float*>(gz_s);  // rnd(gz_0), sw() layout
  uint32_t z_phase = 0, g_phase = 0;
  // the bias gradients' region of the partial slice
  const auto dbs = [&] { return part + c.in_size * H + (c.depth - 2) * H * H + H * c.out_size; };
  float d[64];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T;
    stage_rows<BF16>(x_s, X(), row0, c.n, c.in_size, tid);
    stage_rows<false>(go_s, G_(), row0, c.n, c.out_size, tid);
    cons_sync();

    // forward, stashing z_1 .. z_{L-1}; a_L into a_s, omega cos(omega z_L) in d
    first_layer_wg<BF16>(d, c, [&](int r, int k) { return x_s[r * MAX_IO + k]; }, p);
    for (int l = 0; l < L; ++l) {
      if (l == 0)
        wg_sine<BF16, MX, false>(d, c.bs, c.omega0, nullptr, p);
      else
        wg_sine<BF16, MX, true>(d, c.bs + l * H, c.omega_h, z_g + (size_t)(l - 1) * T * H, p);
      uint32_t ap[P::A][8][4];
      planes_of<P::A>(d, ap);
      ring_wg_product<P::A, P::W, 1>(d, ap, ring);  // z_{l+1} - b_{l+1}
    }
    wg_sine_last<BF16, MX>(d, c.bs + L * H, L == 0 ? c.omega0 : c.omega_h, a_s, p);

    // last layer: gz_L = rnd(g) Wl^T * dc; dWl, dbl, db_L
    last_gz_wg<BF16, MX>(d, c, go_s, red, p);
    cons_sync();  // a_L, gz_L's bias sums
    last_layer_sums<BF16>(c, a_s, go_s, red, part, tid);
    iit::fence_async_global();  // the stash's stores, before the copies back
    cons_sync();                // a_L read
    if (tid == 0 && L >= 2) z_copy(a_s, z_g + (size_t)(L - 2) * T * H, bar + kZFull);

    // hidden layers, last to first; d = gz_l
    for (int l = L; l >= 1; --l) {
      uint32_t gp[P::G][8][4];
      planes_of<P::G>(d, gp);
      ring_wg_product<P::G, P::W, 0>(d, gp, ring);  // ga = gz_l W_l^T
      if (l < L) {  // gz_s's staged dW_{l+1} has been read
        if (tid == 0) {
          iit::bulk_wait_all<true>();
          iit::mbar_arrive(bar + kGzFree);
        }
        iit::mbar_wait(bar + kGzFree, g_phase);
        g_phase ^= 1u;
      }
      store_gz_planes<P::G>(gz_s, gp, p);
      iit::fence_async_shared();  // gz_s's stores, before the products read it
      if (l >= 2) {
        iit::mbar_wait(bar + kZFull, z_phase);  // z_{l-1} is in a_s
        z_phase ^= 1u;
        resine_wg<BF16, MX, false>(d, c, x_s, c.omega_h, a_s, p);
      } else {
        resine_wg<BF16, MX, true>(d, c, x_s, c.omega0, a_s, p);
      }
      wg_bias_sums(d, red, p);  // of gz_{l-1}
      cons_sync();              // a_{l-1} in a_s, gz_l in gz_s, the bias sums
      if (l >= 2) add_bias_sums(red, dbs() + (l - 1) * H, tid);
      float dw[64];
      dw_product<P::A, P::G>(dw, a_s, gz_addr, p);  // dW_l = a_{l-1}^T gz_l
      cons_sync();  // both warpgroups are done with a_s and gz_s
      if (tid == 0 && l >= 3) z_copy(a_s, z_g + (size_t)(l - 3) * T * H, bar + kZFull);
      float* stage = reinterpret_cast<float*>(gz_s) + p.wg * 64 * H;
#pragma unroll
      for (int ni = 0; ni < 16; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * p.wi + p.g + 8 * h;
          *reinterpret_cast<float2*>(&stage[dw_stage_idx(i, p.col(ni))]) =
              make_float2(dw[4 * ni + 2 * h], dw[4 * ni + 2 * h + 1]);
        }
      iit::fence_async_shared();  // the staged dW, before its reduce-add
      cons_sync();
      if (tid == 0) {
        iit::bulk_wait_all();  // the previous add is done
        reduce_dw(part + c.in_size * H + (size_t)(l - 1) * H * H, gz_s);
        iit::bulk_commit();
      }
    }

    // first layer: dW0 += x^T gz_0, db0 += sum gz_0 (added with dWl's
    // when L = 0), dx = rnd(gz_0) W0^T
    if (L >= 1) {
      if (tid == 0) {
        iit::bulk_wait_all<true>();
        iit::mbar_arrive(bar + kGzFree);
      }
      iit::mbar_wait(bar + kGzFree, g_phase);
      g_phase ^= 1u;
    }
#pragma unroll
    for (int ni = 0; ni < 16; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(&g_s[sw(p.row(h), p.col(ni))]) =
            make_float2(rnd<BF16>(d[4 * ni + 2 * h]), rnd<BF16>(d[4 * ni + 2 * h + 1]));
    cons_sync();
    if (L >= 1) add_bias_sums(red, dbs(), tid);
    for (int e = tid; e < c.in_size * H; e += BW_THREADS) {
      const int k = e / H, col = e % H;
      float s = 0.f;
      for (int r = 0; r < T; ++r) s += x_s[r * MAX_IO + k] * g_s[sw(r, col)];
      add_to(part + e, s);
    }
    dx_tail<BF16>(g_s, c.w0, c.in_size, DX(), row0, c.n, tid);
    cons_sync();
  }
  if (tid == 0) iit::bulk_wait_all();
}

// ------------------------------------------- the width-128 forward (wgmma)
//
// Its design is the header note's "Forward at width 128": the width-128
// backward's forward, product by product (first_layer_wg, wg_sine, planes_of
// and ring_wg_product on the forward image of W's planes), without the z
// stash and the backward, so nothing joins the two warpgroups but the ring.

constexpr int FW_NB = 8;  // ring slots: a warpgroup can run half a layer ahead of the other
constexpr size_t kFwRing = 0;
constexpr size_t kFwBar = kFwRing + (size_t)FW_NB * 3 * BW_PLANE * 2;
constexpr size_t kFwCount = kFwBar + FW_NB * sizeof(uint64_t);
constexpr size_t kFwdSmem = kFwCount + FW_NB * sizeof(int);
using FwRingLayout = RingLayout<H, FW_NB, kFwRing, kFwBar, kFwCount, 1>;

// The last layer from the accumulator: out[r][o] = sum_c a_L(r, c) rnd(Wl[c][o])
// + bl[o] for the thread's two rows (a_L in d): the thread's 32 columns in
// order of ni, then the sums of the 4 threads that share the rows (t = 0 ..
// 3) by shuffles, xor 1 then xor 2; thread t = 0 writes the row.
template <bool BF16>
__device__ __forceinline__ void wg_out(const float (&d)[64], const Chain& c,
                                       float* __restrict__ out, int row0, const WgPos& p) {
  const int out_size = c.out_size;
  float s[2][MAX_IO];
#pragma unroll
  for (int o = 0; o < MAX_IO; ++o) s[0][o] = s[1][o] = 0.f;
#pragma unroll
  for (int ni = 0; ni < 16; ++ni)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int col = p.col(ni) + cc;
#pragma unroll
      for (int o = 0; o < MAX_IO; ++o)
        if (o < out_size) {
          const float wv = rnd<BF16>(__ldg(&c.wl[col * out_size + o]));
          s[0][o] += d[4 * ni + cc] * wv;
          s[1][o] += d[4 * ni + 2 + cc] * wv;
        }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < MAX_IO; ++o)
      if (o < out_size) {
        s[h][o] += __shfl_xor_sync(0xffffffffu, s[h][o], 1);
        s[h][o] += __shfl_xor_sync(0xffffffffu, s[h][o], 2);
      }
  if (p.t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + p.row(h);
      if (row < c.n)
#pragma unroll
        for (int o = 0; o < MAX_IO; ++o)
          if (o < out_size) out[(size_t)row * out_size + o] = s[h][o] + __ldg(&c.bl[o]);
    }
}

// W's planes at c.wmt (both images, as the backward takes them; this reads
// the forward image).
template <bool BF16, bool MX, bool MB>
__global__ void __launch_bounds__(BW_THREADS, 1)
sine_mlp_fwd_kernel(Chain c_arg, const float* __restrict__ x, float* __restrict__ out,
                    long long x_stride) {
  using P = BwPlanes<BF16, MX>;
  __shared__ MemberFwd mf;
  if constexpr (MB) {
    member_fwd<H>(mf, c_arg, x, out, x_stride);
    __syncthreads();
  }
  const Chain& c = chain_of<MB>(mf, c_arg);
  const auto X = [&] { if constexpr (MB) return mf.x; else return x; };
  const auto OUT = [&] { if constexpr (MB) return mf.out; else return out; };
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int tid = threadIdx.x;
  const int L = c.depth - 2;
  const int n_tiles = (c.n + T - 1) / T;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // member m's images m apart
  const __nv_bfloat16* planes = reinterpret_cast<const __nv_bfloat16*>(c_arg.wmt) +
                                (MB ? (size_t)blockIdx.y * 2 * L * BW_NS * P::W * BW_PLANE : 0);
  WgRing<P::W, FwRingLayout> ring{smem, planes, L, my_tiles * L * BW_NS};
  if (tid == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < FW_NB && q < ring.total; ++q) ring.fill(q);

  const WgPos p(tid);
  float d[64];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T;
    const float* xt = X();
    first_layer_wg<BF16>(d, c, [&](int r, int k) {
      return row0 + r < c.n ? rnd<BF16>(__ldg(xt + (size_t)(row0 + r) * c.in_size + k)) : 0.f;
    }, p);
    for (int l = 0; l < L; ++l) {
      wg_sine<BF16, MX, false>(d, c.bs + l * H, l == 0 ? c.omega0 : c.omega_h, nullptr, p);
      uint32_t ap[P::A][8][4];
      planes_of<P::A>(d, ap);
      ring_wg_product<P::A, P::W, 1>(d, ap, ring);  // z_{l+1} - b_{l+1}
    }
    wg_sine<BF16, MX, false>(d, c.bs + L * H, L == 0 ? c.omega0 : c.omega_h, nullptr, p);
    wg_out<BF16>(d, c, OUT(), row0, p);
  }
}

// ------------------------------------------------- the width-192 kernels
//
// Widths 129-192 run on the kernels of width 192, the model's width
// zero-padded to it (padded units stay exactly 0, as sin(0) = 0): the
// finals' w182 keeps 90% of its products useful. One fp32 W is 144 KB
// there, too much for a block's 227 KB of shared memory beside the
// activations, so each hidden W streams through a ring of slices of its bf16
// planes. Every width above 192 runs on the layer-wise kernels (LW_MIN;
// "the layer-wise kernels" below). Kernels of width 256 and 512 on mma.sync
// (3xTF32, with the hidden layers' dW in a second kernel) ran those widths
// until the layer-wise kernels overtook them: at 512^2, d8, fp32, under
// autograd, the layer-wise pair took 11.7 / 34.3 ms against their 22.1 /
// 91.6 ms (H100, PERF.md).
// - Forward at 192: "the width-192 forward" below.
// - Backward at 192 (sine_mlp_bwd_wg192_kernel, "the width-192 backward"
//   below): on bf16 wgmma, as at 128, with dW summed in the kernel. The
//   design follows from the registers and the 227 KB of shared memory. A
//   64 x 192 accumulator is 96 registers a thread, and three planes of a
//   192-wide A in registers 144 more, so the width-128 chain of
//   "accumulator -> next A in registers" does not fit; the two warpgroups
//   split N instead (96 columns each, m64n96k16, a 48-register
//   accumulator) over 64-row tiles, and a product's A is read by wgmma from
//   shared memory: act_s holds the activation's (forward) or gz's
//   (backward) bf16 planes, written by their owners between two barriers
//   of the block. A 128-row tile would need 144 KB of planes alone.
//   dW_l = a_{l-1}^T gz_l per tile: a warpgroup's 96 columns of gz
//   (act_s read N-major, the same image) against a^T from a_s (fp32,
//   split into planes per k-step, A from registers), in 3 pieces of 64 x
//   96; each piece is staged in the warpgroup's 24 KB buffer and added into
//   the block's partial by one bulk reduce-add (ops/sine_mlp.
//   dw_position_index gives its order), the add into a region waiting for
//   the one a tile earlier. The layer loop orders a_{l-1}, dW_l, ga, gz_{l-1},
//   so only dW's accumulator and A planes are live while dW is summed (two
//   passes over z_{l-1}: its sine for a_{l-1}, its cosine for gz_{l-1}).
//   W's planes stream through a 3-slot ring of one k-step (18 KB) each.
//   The z stash is each thread's own pair order (coalesced, no shared
//   memory); the reduce-adds go under an evict_first L2 policy, so the
//   stash and W's planes stay in L2. Per tile and layer the dW adds move
//   144 KB (3.6 GB per backward at 512^2 d8; the partials, 114 MB, do not
//   fit L2): an earlier design's 96 KB of dW operands out and back moved
//   less per 64 rows, but needed 2.4 GB of scratch per member and a second
//   kernel.

// ------------------------------------------- the width-192 backward (wgmma)
//
// Its design is the note "Backward at width 192" above. A tile is 64 pixel
// rows; warpgroup wg holds columns 96 wg .. 96 wg + 95 of every product's
// output, its warp wi rows 16 wi .. 16 wi + 15, and d[4 ni + q] is the
// element at
//   row 16 wi + g + 8 (q >> 1),  column 96 wg + 8 ni + 2 t + (q & 1),  ni < 12
// (g = lane / 4, t = lane % 4; hopper.cuh's wg_bf16_n96).

constexpr int B2_H = 192, B2_T = 64;  // kernel width, pixel rows per tile
constexpr int B2_NI = 12;             // 8-column groups of a warpgroup's 96 columns
constexpr int B2_NB = 3;              // ring slots
constexpr int B2_AS = B2_H + 4;       // a_s's row stride in floats (its transposed loads hit 32 banks)
constexpr int B2_PIECE = 64 * 96;     // floats of a dW piece: 64 rows, a warpgroup's 96 columns
constexpr int B2_PIECES = B2_H / 64;  // pieces of a warpgroup's columns of dW
// act_s (an activation's or gz's bf16 planes, as wgmma operands): element
// (r, c) of a plane at byte ((c / 8) * 8 + r / 8) * 128 + (r % 8) * 16 +
// (c % 8) * 2, so core matrices are B2_CG bytes apart along the columns and
// B2_RG along the rows
constexpr uint32_t B2_CG = 1024, B2_RG = 128;
constexpr uint32_t B2_PLANE_BYTES = B2_T * B2_H * 2;
// W's slices (ops/sine_mlp.weight_planes): core matrix (kg, ng) at
// (kg * 24 + ng) * 128 bytes
constexpr uint32_t B2_W_LBO = (B2_H / 8) * 128, B2_W_SBO = 128;
// Byte offsets of the block's shared memory: the ring, act_s (3 planes),
// a_s (a_{l-1} in fp32, rows of B2_AS floats), the two warpgroups' dW
// staging, the bias sums (4 row groups), the ring's mbarriers and counts.
constexpr size_t kB2Ring = 0;
constexpr size_t kB2Act = kB2Ring + (size_t)B2_NB * 3 * BW_KS * B2_H * 2;
constexpr size_t kB2A = kB2Act + 3 * (size_t)B2_PLANE_BYTES;
constexpr size_t kB2Stage = kB2A + (size_t)B2_T * B2_AS * 4;
constexpr size_t kB2Red = kB2Stage + 2 * (size_t)B2_PIECE * 4;
constexpr size_t kB2Bar = kB2Red + 4 * (size_t)B2_H * 4;
constexpr size_t kB2Count = kB2Bar + B2_NB * sizeof(uint64_t);
constexpr size_t kB2Smem = kB2Count + B2_NB * sizeof(int);
using B2RingLayout = RingLayout<B2_H, B2_NB, kB2Ring, kB2Bar, kB2Count, 2>;
static_assert(kB2Smem + sizeof(MemberBwd) <= 232448, "the width-192 backward's shared memory");
static_assert(3 * B2_PLANE_BYTES >= B2_T * B2_AS * 4, "act_s holds rnd(gz_0) as a_s lays it out");
static_assert(kB2Act % 128 == 0 && kB2A % 16 == 0 && kB2Stage % 16 == 0, "aligned regions");

struct B2Pos {
  int wg, wi, g, t;
  __device__ __forceinline__ explicit B2Pos(int tid)
      : wg(tid >> 7), wi((tid >> 5) & 3), g((tid & 31) >> 2), t(tid & 3) {}
  __device__ __forceinline__ int row(int h) const { return 16 * wi + g + 8 * h; }
  __device__ __forceinline__ int col(int ni) const { return 96 * wg + 8 * ni + 2 * t; }
};

// v, as a value the compiler cannot see through: the descriptors and
// addresses made from it are made where they are used, not hoisted out of
// the tile loop into registers held across it (which spilled).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ void b2_sync() { iit::named_barrier(1, BW_THREADS); }
__device__ __forceinline__ void b2_wg_sync(int wg) { iit::named_barrier(2 + wg, 128); }

// The thread's z pair (ni, h) in a stash tile: its own layout, a warp's
// stores of one pair 256 contiguous bytes.
__device__ __forceinline__ float2* b2_stash(float* z, int ni, int h, int tid) {
  return reinterpret_cast<float2*>(z) + (2 * ni + h) * BW_THREADS + tid;
}

// The planes of d (an activation, or gz rounded as the mode takes it) into
// act_s, one bf16 pair a store.
template <int NP>
__device__ __forceinline__ void b2_store_planes(uint8_t* __restrict__ act_s, const float (&d)[48],
                                                const B2Pos& p) {
  // element (r, c) = (16 wi + g + 8 h, 96 wg + 8 ni + 2 t): column group
  // 12 wg + ni, row group 2 wi + h
  uint8_t* base = act_s + (96 * p.wg + 2 * p.wi) * 128 + p.g * 16 + p.t * 4;
#pragma unroll
  for (int ni = 0; ni < B2_NI; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = ni * B2_CG + h * B2_RG;
      uint32_t pl[NP];
      iit::split_planes<NP>(d[4 * ni + 2 * h], d[4 * ni + 2 * h + 1], pl);
#pragma unroll
      for (int i = 0; i < NP; ++i)
        *reinterpret_cast<uint32_t*>(base + i * B2_PLANE_BYTES + at) = pl[i];
    }
}

// d = A W over K = 192 for the warpgroup's 96 columns: A's planes in act_s
// (K-major), W's slices from the ring (TB = 1: the forward image, a.W; TB =
// 0: the backward image, gz.W^T); passes as wg_passes. As ring_wg_product.
template <int PA, int PB, int TB, class R>
__device__ __forceinline__ void ring_ss_product(float (&d)[48], uint32_t act, WgRing<PB, R>& ring,
                                                int wg) {
  iit::wg_fence();
#pragma unroll
  for (int u = 0; u < R::NS; ++u, ++ring.use) {
    const int b = ring.use % R::NB;
    iit::mbar_wait(ring.bar(b), (ring.use / R::NB) & 1);
    const uint32_t slot = iit::smem_u32(ring.slot(b)) + wg * (B2_NI * 128);
    const uint32_t a0 = opaque(act) + u * 2 * B2_CG;
    bool first = u == 0;
#pragma unroll
    for (int s = 2; s >= 0; --s)
#pragma unroll
      for (int i = 0; i <= s; ++i)
        if (i < PA && s - i < PB) {
          iit::wg_bf16_ss_n96<0, TB>(
              d, iit::wg_desc(opaque(a0) + i * B2_PLANE_BYTES, B2_CG, B2_RG),
              iit::wg_desc(opaque(slot) + (s - i) * (R::PLANE * 2), B2_W_LBO, B2_W_SBO),
              first ? 0 : 1);
          first = false;
        }
    iit::wg_commit();
    if (u > 0) {
      iit::wg_wait<1>();
      ring.release(ring.use - 1);
    }
  }
  iit::wg_wait<0>();
  ring.release(ring.use - 1);
  iit::fence_regs(d);
}

// acc = a^T gz over the tile's 64 rows for dW rows 64 mp .. 64 mp + 63
// (columns of a) and the warpgroup's 96 columns (of gz): A = a^T from a_s
// (fp32, split into planes per k-step of 16 rows), B = gz's planes in act_s
// (N-major: k = row, n = column).
template <int PA, int PB>
__device__ __forceinline__ void b2_dw_piece(float (&acc)[48], const float* __restrict__ a_s,
                                            uint32_t act, int mp, const B2Pos& p) {
  const int c0 = 64 * mp + 16 * p.wi + p.g;
  uint32_t ak[PA][4];  // one k-step's planes at a time (register room)
#pragma unroll
  for (int kk = 0; kk < B2_T / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 16 * kk + 2 * p.t + 8 * (j >> 1), c = c0 + 8 * (j & 1);
      uint32_t pl[PA];
      iit::split_planes<PA>(a_s[r * B2_AS + c], a_s[(r + 1) * B2_AS + c], pl);
#pragma unroll
      for (int i = 0; i < PA; ++i) ak[i][j] = pl[i];
    }
    iit::wg_fence();
    const uint32_t b0 = opaque(act) + p.wg * (B2_NI * B2_CG) + kk * 2 * B2_RG;
    bool first = kk == 0;
#pragma unroll
    for (int s = 2; s >= 0; --s)
#pragma unroll
      for (int i = 0; i <= s; ++i)
        if (i < PA && s - i < PB) {
          iit::wg_bf16_n96<1>(acc, ak[i],
                              iit::wg_desc(opaque(b0) + (s - i) * B2_PLANE_BYTES, B2_RG, B2_CG),
                              first ? 0 : 1);
          first = false;
        }
    iit::wg_commit();
    iit::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < PA; ++i) iit::fence_regs(ak[i]);
  }
  iit::fence_regs(acc);
}

// A dW piece's element (i, j) = (16 wi + g + 8 h, 8 ni + 2 t + q), i < 64
// rows of dW, j < 96 columns, is staged (and added into the partial) at
// float ((2 ni + h) * 128 + 32 wi + 4 g + t) * 2 + q: the warpgroup's
// threads' own order, a warp's stores of one (ni, h) 256 contiguous bytes
// (the wrapper puts the pieces back in rows, ops/sine_mlp.dw_position_index).
__device__ __forceinline__ float2* b2_stage_at(float* stage, int ni, int h, int tid) {
  return reinterpret_cast<float2*>(stage) + (2 * ni + h) * 128 + (tid & 127);
}

// z = d + bias; STASH stores z into the stash tile z_g; d = a =
// rnd(sin(omega z)) (rounded also under MX).
template <bool BF16, bool MX, bool STASH>
__device__ __forceinline__ void b2_sine(float (&d)[48], const float* __restrict__ bias,
                                        float omega, float* __restrict__ z_g, const B2Pos& p,
                                        int tid) {
#pragma unroll
  for (int ni = 0; ni < B2_NI; ++ni) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + p.col(ni)));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float z0 = d[4 * ni + 2 * h] + b.x, z1 = d[4 * ni + 2 * h + 1] + b.y;
      if (STASH) __stcg(b2_stash(z_g, ni, h, tid), make_float2(z0, z1));
      d[4 * ni + 2 * h] = rnd_act<BF16, MX>(iit::fast_sin(omega * z0));
      d[4 * ni + 2 * h + 1] = rnd_act<BF16, MX>(iit::fast_sin(omega * z1));
    }
  }
}

// The last sine layer: z = d + bias; a_s = rnd(sin(omega z)); d = omega
// cos(omega z).
template <bool BF16, bool MX>
__device__ __forceinline__ void b2_sine_last(float (&d)[48], const float* __restrict__ bias,
                                             float omega, float* __restrict__ a_s,
                                             const B2Pos& p) {
#pragma unroll
  for (int ni = 0; ni < B2_NI; ++ni) {
    const int c = p.col(ni);
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float z0 = d[4 * ni + 2 * h] + b.x, z1 = d[4 * ni + 2 * h + 1] + b.y;
      *reinterpret_cast<float2*>(&a_s[p.row(h) * B2_AS + c]) = make_float2(
          rnd_act<BF16, MX>(iit::fast_sin(omega * z0)), rnd_act<BF16, MX>(iit::fast_sin(omega * z1)));
      d[4 * ni + 2 * h] = omega * iit::fast_cos(omega * z0);
      d[4 * ni + 2 * h + 1] = omega * iit::fast_cos(omega * z1);
    }
  }
}

// The backward's re-sine of z_{l-1}, in two passes: SINE, a_s =
// rnd(sin(omega z)) (a_{l-1}, dW_l's operand); else d = rnd(d) * omega
// cos(omega z) (the inner rnd under MX): gz_{l-1} from its ga. z from the
// stash tile z_g, or (FROM_X) z = x W_0 + b_0, recomputed in
// first_layer_wg's order.
template <bool BF16, bool MX, bool FROM_X, bool SINE, class XV>
__device__ __forceinline__ void b2_resine(float (&d)[48], const Chain& c, XV xv,
                                          const float* __restrict__ z_g, float omega,
                                          float* __restrict__ a_s, const B2Pos& p, int tid) {
  float xr[2][MAX_IO];
  if (FROM_X)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < MAX_IO; ++k) xr[h][k] = k < c.in_size ? xv(p.row(h), k) : 0.f;
#pragma unroll
  for (int ni = 0; ni < B2_NI; ++ni) {
    const int col = p.col(ni);
    float2 b = make_float2(0.f, 0.f);
    if (FROM_X) b = __ldg(reinterpret_cast<const float2*>(c.bs + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 z;
      if (FROM_X) {
        z = make_float2(0.f, 0.f);
        for (int k = 0; k < c.in_size; ++k) {
          const float2 wv = __ldg(reinterpret_cast<const float2*>(c.w0 + k * B2_H + col));
          z.x += xr[h][k] * rnd<BF16>(wv.x);
          z.y += xr[h][k] * rnd<BF16>(wv.y);
        }
        z.x += b.x;
        z.y += b.y;
      } else {
        z = __ldcg(b2_stash(const_cast<float*>(z_g), ni, h, tid));
      }
      if (SINE) {
        *reinterpret_cast<float2*>(&a_s[p.row(h) * B2_AS + col]) =
            make_float2(rnd_act<BF16, MX>(iit::fast_sin(omega * z.x)),
                        rnd_act<BF16, MX>(iit::fast_sin(omega * z.y)));
      } else {
        d[4 * ni + 2 * h] = rnd<MX>(d[4 * ni + 2 * h]) * (omega * iit::fast_cos(omega * z.x));
        d[4 * ni + 2 * h + 1] =
            rnd<MX>(d[4 * ni + 2 * h + 1]) * (omega * iit::fast_cos(omega * z.y));
      }
    }
  }
}

// red[warp's row group][column] = the sum of d over the warp's 16 rows (two
// fixed-order terms, then shuffles across the lanes that share a column).
__device__ __forceinline__ void b2_bias_sums(const float (&d)[48], float* __restrict__ red,
                                             const B2Pos& p) {
#pragma unroll
  for (int ni = 0; ni < B2_NI; ++ni) {
    float s[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      float v = d[4 * ni + cc] + d[4 * ni + 2 + cc];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      s[cc] = v;
    }
    if (p.g == 0)
      *reinterpret_cast<float2*>(&red[p.wi * B2_H + p.col(ni)]) = make_float2(s[0], s[1]);
  }
}

// db += the 4 row groups' sums in red, in order. Call after a barrier.
__device__ __forceinline__ void b2_add_bias_sums(const float* __restrict__ red,
                                                 float* __restrict__ db, int tid) {
  if (tid < B2_H) add_to(db + tid, ((red[tid] + red[B2_H + tid]) + red[2 * B2_H + tid]) +
                                       red[3 * B2_H + tid]);
}

// gz_L = rnd(rnd(g) Wl^T) * dc at the thread's positions (dc in d; the
// inner rnd under MX; g's rows from n on read as 0), its bias sums into red.
template <bool BF16, bool MX>
__device__ __forceinline__ void b2_last_gz(float (&d)[48], const Chain& c,
                                           const float* __restrict__ g, int row0,
                                           float* __restrict__ red, const B2Pos& p) {
  // a loop over the outputs (not unrolled over MAX_IO: the unrolled loads
  // held registers beside d and spilled)
  const int out_size = c.out_size;
  const bool in0 = row0 + p.row(0) < c.n, in1 = row0 + p.row(1) < c.n;
  const float* g0 = g + (size_t)(row0 + p.row(0)) * out_size;
  const float* g1 = g + (size_t)(row0 + p.row(1)) * out_size;
#pragma unroll
  for (int ni = 0; ni < B2_NI; ++ni)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int col = p.col(ni) + cc;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 1
      for (int o = 0; o < out_size; ++o) {
        const float wv = rnd<BF16>(__ldg(&c.wl[col * out_size + o]));
        s0 += (in0 ? rnd<BF16>(__ldg(g0 + o)) : 0.f) * wv;
        s1 += (in1 ? rnd<BF16>(__ldg(g1 + o)) : 0.f) * wv;
      }
      d[4 * ni + cc] = rnd<MX>(s0) * d[4 * ni + cc];
      d[4 * ni + 2 + cc] = rnd<MX>(s1) * d[4 * ni + 2 + cc];
    }
  b2_bias_sums(d, red, p);
}

// The last layer's weight and bias gradients: dWl += a_L^T rnd(g) over the
// tile (a_L in a_s), dbl += sum g, db_L += the bias sums of gz_L in red.
// Call after a barrier.
template <bool BF16>
__device__ __noinline__ void b2_last_sums(const float* __restrict__ a_s,
                                          const float* __restrict__ g,
                                          const float* __restrict__ red, float* __restrict__ part,
                                          int n, int in_size, int out_size, int depth, int row0,
                                          int tid) {
  const int L = depth - 2;
  const int rows = n - row0 < B2_T ? n - row0 : B2_T;
  float* dwl = part + in_size * B2_H + L * B2_H * B2_H;
  float* dbs = dwl + B2_H * out_size;
  float* dbl = dbs + (depth - 1) * B2_H;
  for (int e = tid; e < B2_H * out_size; e += BW_THREADS) {
    const int k = e % B2_H, o = e / B2_H;
    float s = 0.f;
    for (int r = 0; r < rows; ++r)
      s += a_s[r * B2_AS + k] * rnd<BF16>(__ldg(&g[(size_t)(row0 + r) * out_size + o]));
    add_to(dwl + k * out_size + o, s);
  }
  const int lane = tid & 31;
  for (int o = tid >> 5; o < out_size; o += BW_WARPS) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < B2_T / 32; ++j) {
      const int r = lane + 32 * j;
      s += r < rows ? __ldg(&g[(size_t)(row0 + r) * out_size + o]) : 0.f;
    }
    s = warp_sum(s);
    if (lane == 0) add_to(dbl + o, s);
  }
  b2_add_bias_sums(red, dbs + L * B2_H, tid);
}

// The first layer's weight gradient and dx, from rnd(gz_0) in a_s: dW0 +=
// x^T rnd(gz_0) over the tile, dx = rnd(gz_0) W0^T (a warp a row; lane i
// sums columns i + 32 j in order of j, then the warp adds the lanes).
template <bool BF16>
__device__ __noinline__ void b2_first_tail(const float* __restrict__ x,
                                           const float* __restrict__ gs,
                                           const float* __restrict__ w0, float* __restrict__ part,
                                           float* __restrict__ dx, int n, int in_size, int row0,
                                           int tid) {
  const int rows = n - row0 < B2_T ? n - row0 : B2_T;
  for (int e = tid; e < in_size * B2_H; e += BW_THREADS) {
    const int k = e / B2_H, col = e % B2_H;
    float s = 0.f;
    for (int r = 0; r < rows; ++r)
      s += rnd<BF16>(__ldg(&x[(size_t)(row0 + r) * in_size + k])) * gs[r * B2_AS + col];
    add_to(part + e, s);
  }
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += BW_WARPS) {
    float acc[MAX_IO];
#pragma unroll
    for (int o = 0; o < MAX_IO; ++o) acc[o] = 0.f;
#pragma unroll
    for (int j = 0; j < B2_H / 32; ++j) {
      const int k = lane + 32 * j;
      const float v = gs[r * B2_AS + k];
#pragma unroll
      for (int o = 0; o < MAX_IO; ++o)
        if (o < in_size) acc[o] += v * rnd<BF16>(__ldg(&w0[o * B2_H + k]));
    }
    float mine = 0.f;
#pragma unroll
    for (int o = 0; o < MAX_IO; ++o)
      if (o < in_size) {
        const float q = warp_sum(acc[o]);
        if (lane == o) mine = q;
      }
    if (lane < in_size) dx[(size_t)(row0 + r) * in_size + lane] = mine;
  }
}

// W's planes at c.wmt (ops/sine_mlp.weight_planes at width 192, both
// images); the partial slice's dW_m region in the pieces' order (the
// wrapper puts it back in rows).
template <bool BF16, bool MX, bool MB>
__global__ void __launch_bounds__(BW_THREADS, 1)
sine_mlp_bwd_wg192_kernel(Chain c_arg, const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ dx, float* __restrict__ z_all,
                       float* __restrict__ partials, int n_part, long long x_stride) {
  using P = BwPlanes<BF16, MX>;
  __shared__ MemberBwd mb;
  if constexpr (MB) {
    member_bwd<B2_H, B2_T>(mb, c_arg, x, g, dx, z_all, partials, n_part, x_stride);
    __syncthreads();
  }
  const Chain& c = chain_of<MB>(mb, c_arg);
  const auto X = [&] { if constexpr (MB) return mb.x; else return x; };
  const auto G_ = [&] { if constexpr (MB) return mb.g; else return g; };
  const auto DX = [&] { if constexpr (MB) return mb.dx; else return dx; };
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* act_s = smem + kB2Act;
  const uint32_t act = iit::smem_u32(act_s);
  float* a_s = reinterpret_cast<float*>(smem + kB2A);
  float* red = reinterpret_cast<float*>(smem + kB2Red);
  const int tid0 = threadIdx.x;
  const int L = c.depth - 2;
  const int n_tiles = (c.n + B2_T - 1) / B2_T;

  // this block's slices: partial gradients (zeroed; dW's reduce-adds add
  // through the async proxy) and the z stash (z_1 .. z_{L-1})
  float* part = partials + (size_t)blockIdx.x * n_part;
  float* z_g = z_all + (size_t)blockIdx.x * (L > 1 ? L - 1 : 1) * B2_T * B2_H;
  for (int e = tid0; e < n_part; e += BW_THREADS) part[e] = 0.f;
  iit::fence_async_global();
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // member m's images m apart
  const __nv_bfloat16* planes =
      reinterpret_cast<const __nv_bfloat16*>(c_arg.wmt) +
      (MB ? (size_t)blockIdx.y * 2 * L * B2RingLayout::NS * P::W * B2RingLayout::PLANE : 0);
  WgRing<P::W, B2RingLayout> ring{smem, planes, L, my_tiles * 2 * L * B2RingLayout::NS};
  if (tid0 == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid0 == 0)
    for (int q = 0; q < B2_NB && q < ring.total; ++q) ring.fill(q);

  // Each warpgroup's first thread adds its staged dW pieces into the
  // partial by bulk reduce-adds, a piece once the last add has read the
  // staging buffer; an add into a piece's region waits for the add into it
  // one tile earlier (3 L pieces before) to finish, so they come in tile
  // order: a run repeats bit for bit. A thread's place (tid, p, stage,
  // leader) is made anew from an opaque tid at each tile and layer:
  // addresses made from it are not held in registers across the loops (the
  // member-axis instantiations spilled with them).

  // the bias gradients' region of the partial slice
  const auto dbs = [&] {
    return part + c.in_size * B2_H + (c.depth - 2) * B2_H * B2_H + B2_H * c.out_size;
  };
  float d[48];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tid = opaque(tid0);
    const B2Pos p(tid);
    const int row0 = tile * B2_T;
    const float* xt = X();
    const auto xv = [&](int r, int k) {
      return row0 + r < c.n ? rnd<BF16>(__ldg(xt + (size_t)(row0 + r) * c.in_size + k)) : 0.f;
    };

    // forward, stashing z_1 .. z_{L-1}; a_L into a_s, omega cos(omega z_L) in d
    first_layer_wg<BF16, B2_H>(d, c, xv, p);
    for (int l = 0; l < L; ++l) {
      const int tid = opaque(tid0);
      const B2Pos p(tid);
      if (l == 0)
        b2_sine<BF16, MX, false>(d, c.bs, c.omega0, nullptr, p, tid);
      else
        b2_sine<BF16, MX, true>(d, c.bs + l * B2_H, c.omega_h, z_g + (size_t)(l - 1) * B2_T * B2_H,
                                p, tid);
      b2_sync();  // both warpgroups are done with act_s
      b2_store_planes<P::A>(act_s, d, p);
      iit::fence_async_shared();  // the planes' stores, before the products read them
      b2_sync();
      ring_ss_product<P::A, P::W, 1>(d, act, ring, p.wg);  // z_{l+1} - b_{l+1}
    }
    b2_sine_last<BF16, MX>(d, c.bs + L * B2_H, L == 0 ? c.omega0 : c.omega_h, a_s, p);

    // last layer: gz_L = rnd(g) Wl^T * dc; dWl, dbl, db_L (out of line,
    // with no array live across the call)
    b2_last_gz<BF16, MX>(d, c, G_(), row0, red, p);
    b2_sync();  // a_L, gz_L's bias sums; act_s read
    if (L >= 1) {
      b2_store_planes<P::G>(act_s, d, p);
      iit::fence_async_shared();
    } else {  // gz_0 is the last layer's gz: rnd(gz_0) in fp32 for the first layer's
              // tail, in act_s (unused without hidden layers) as a_s lays it out
      float* gs = reinterpret_cast<float*>(act_s);
#pragma unroll
      for (int ni = 0; ni < B2_NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&gs[p.row(h) * B2_AS + p.col(ni)]) =
              make_float2(rnd<BF16>(d[4 * ni + 2 * h]), rnd<BF16>(d[4 * ni + 2 * h + 1]));
    }
    b2_last_sums<BF16>(a_s, G_(), red, part, c.n, c.in_size, c.out_size, c.depth, row0, tid);
    b2_sync();  // gz_L in act_s; a_s and red read

    // hidden layers, last to first; gz_l's planes in act_s. Per layer:
    // a_{l-1}, dW_l, ga = gz_l W_l^T, then gz_{l-1}: nothing but dW's
    // accumulator is live while dW is summed.
    for (int l = L; l >= 1; --l) {
      const int tid = opaque(tid0);
      const B2Pos p(tid);
      float* stage = reinterpret_cast<float*>(smem + kB2Stage) + p.wg * B2_PIECE;
      const bool leader = (tid & 127) == 0;
      const float* z_l1 = z_g + (size_t)(l >= 2 ? l - 2 : 0) * B2_T * B2_H;  // z_{l-1}
      if (l >= 2)
        b2_resine<BF16, MX, false, true>(d, c, xv, z_l1, c.omega_h, a_s, p, tid);
      else
        b2_resine<BF16, MX, true, true>(d, c, xv, nullptr, c.omega0, a_s, p, tid);
      b2_sync();  // a_{l-1} in a_s (and gz_l's planes in act_s)
      // dW_l = a_{l-1}^T gz_l, piece by piece
      float* dw = part + c.in_size * B2_H + (size_t)(l - 1) * B2_H * B2_H + p.wg * B2_PIECE;
#pragma unroll 1
      for (int mp = 0; mp < B2_PIECES; ++mp) {
        float acc[48];
        b2_dw_piece<P::A, P::G>(acc, a_s, act, mp, p);
        if (leader) iit::bulk_wait_all<true>();  // the staging buffer has been read
        b2_wg_sync(p.wg);
#pragma unroll
        for (int ni = 0; ni < B2_NI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *b2_stage_at(stage, ni, h, tid) =
                make_float2(acc[4 * ni + 2 * h], acc[4 * ni + 2 * h + 1]);
        iit::fence_async_shared();  // the staged piece, before its reduce-add
        b2_wg_sync(p.wg);
        if (leader) {
          // at most the last B2_PIECES - 1 adds pending: the one into this
          // region (B2_PIECES L >= B2_PIECES adds ago) is done
          iit::bulk_wait<B2_PIECES - 1>();
          iit::bulk_reduce_add(dw + mp * 2 * B2_PIECE, stage, B2_PIECE * 4,
                               iit::l2_evict_first());
          iit::bulk_commit();
        }
      }
      // ga = gz_l W_l^T; d set first, so gz_l's fp32 copy (its planes are
      // in act_s) is not held live through dW as the first product's input
#pragma unroll
      for (int i = 0; i < 48; ++i) d[i] = 0.f;
      ring_ss_product<P::G, P::W, 0>(d, act, ring, p.wg);
      if (l >= 2)
        b2_resine<BF16, MX, false, false>(d, c, xv, z_l1, c.omega_h, a_s, p, tid);
      else
        b2_resine<BF16, MX, true, false>(d, c, xv, nullptr, c.omega0, a_s, p, tid);
      b2_bias_sums(d, red, p);  // of gz_{l-1}
      b2_sync();  // both warpgroups are done with act_s and a_s; the bias sums
      b2_add_bias_sums(red, dbs() + (l - 1) * B2_H, tid);
      if (l >= 2) {
        b2_store_planes<P::G>(act_s, d, p);
        iit::fence_async_shared();
      } else {  // rnd(gz_0) in fp32 for the first layer's tail
#pragma unroll
        for (int ni = 0; ni < B2_NI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(&a_s[p.row(h) * B2_AS + p.col(ni)]) =
                make_float2(rnd<BF16>(d[4 * ni + 2 * h]), rnd<BF16>(d[4 * ni + 2 * h + 1]));
        b2_sync();
      }
    }

    // first layer: dW0 += x^T rnd(gz_0), dx = rnd(gz_0) W0^T (db0 is in
    // the sums above; rnd(gz_0) in a_s, or in act_s without hidden layers)
    b2_first_tail<BF16>(X(), L >= 1 ? a_s : reinterpret_cast<float*>(act_s), c.w0, part, DX(),
                        c.n, c.in_size, row0, tid);
    b2_sync();  // a_s read
  }
  if ((tid0 & 127) == 0) iit::bulk_wait_all();
}

// ------------------------------------------- the width-192 forward (wgmma)
//
// Its design is the header note's "Forward at width 192": the width-192
// backward's forward, product by product (first_layer_wg, b2_sine,
// b2_store_planes and the passes of ring_ss_product on the forward image of
// W's planes), in 128-row tiles: warpgroup wg holds rows 64 wg .. 64 wg + 63
// of a tile and all 192 columns, as two halves of the width-192 backward's
// accumulator, d[hf][4 ni + q] the element at
//   row 64 wg + 16 wi + g + 8 (q >> 1),  column 96 hf + 8 ni + 2 t + (q & 1)
// (the backward's B2Pos with wg = hf places a half). Each warpgroup keeps its
// activation's planes in its own act_s (64 x 192, the backward's layout), so
// nothing joins the two warpgroups but the ring.

constexpr int F2_T = 128;  // pixel rows per tile: 64 a warpgroup

// Byte offsets of the block's shared memory for W and the activations in NP
// planes (3 in fp32, 1 where W is a bf16 value): the ring (NB slots of one
// k-step), each warpgroup's act_s (NP planes of 64 x 192), the ring's
// mbarriers and counts. Four slots fit beside fp32's planes; one plane
// leaves room for 16, more than a layer's 12 k-steps.
template <int NP>
struct F2Smem {
  static constexpr int NB = NP == 3 ? 4 : 16;
  static constexpr size_t SLOT = (size_t)NP * BW_KS * B2_H * 2;
  static constexpr size_t WG_ACT = (size_t)NP * B2_PLANE_BYTES;
  static constexpr size_t ACT = NB * SLOT, BAR = ACT + 2 * WG_ACT, COUNT = BAR + NB * 8;
  static constexpr size_t BYTES = COUNT + NB * 4;
  using Ring = RingLayout<B2_H, NB, 0, BAR, COUNT, 1, NP>;
  static_assert(BYTES + sizeof(MemberFwd) <= 232448, "the width-192 forward's shared memory");
  static_assert(ACT % 128 == 0 && WG_ACT % 128 == 0, "aligned planes");
};

// d = A W over K = 192 for the warpgroup's 192 columns (two halves of 96):
// A's planes in the warpgroup's act_s (K-major), W's slices from the ring
// (the forward image). Per k-step the passes of ring_ss_product, each
// issued for both halves, so every element sums as in the width-192
// backward's forward. A slice's slot is released once its products are
// done; the next slice's products are issued before that.
template <int PA, int PB, class R>
__device__ __forceinline__ void f2_product(float (&d)[2][48], uint32_t act, WgRing<PB, R>& ring) {
  iit::wg_fence();
#pragma unroll
  for (int u = 0; u < R::NS; ++u, ++ring.use) {
    const int b = ring.use % R::NB;
    iit::mbar_wait(ring.bar(b), (ring.use / R::NB) & 1);
    const uint32_t slot = iit::smem_u32(ring.slot(b));
    const uint32_t a0 = opaque(act) + u * 2 * B2_CG;
    bool first = u == 0;
#pragma unroll
    for (int s = 2; s >= 0; --s)
#pragma unroll
      for (int i = 0; i <= s; ++i)
        if (i < PA && s - i < PB) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            iit::wg_bf16_ss_n96<0, 1>(
                d[hf], iit::wg_desc(opaque(a0) + i * B2_PLANE_BYTES, B2_CG, B2_RG),
                iit::wg_desc(opaque(slot) + hf * (B2_NI * 128) + (s - i) * (R::PLANE * 2),
                             B2_W_LBO, B2_W_SBO),
                first ? 0 : 1);
          first = false;
        }
    iit::wg_commit();
    if (u > 0) {
      iit::wg_wait<1>();
      ring.release(ring.use - 1);
    }
  }
  iit::wg_wait<0>();
  ring.release(ring.use - 1);
  iit::fence_regs(d[0]);
  iit::fence_regs(d[1]);
}

// The last layer from the accumulator: out[r][o] = sum_c a_L(r, c)
// rnd(Wl[c][o]) + bl[o] for the thread's two rows of the warpgroup's
// (rows0 the first): the thread's 48 columns in order of hf, ni, then the
// sums of the 4 threads that share the rows (t = 0 .. 3) by shuffles, xor 1
// then xor 2 (wg_out's order at 192); thread t = 0 writes the row. A loop
// over the outputs, not unrolled over MAX_IO (as b2_last_gz: the unrolled
// loads held registers beside d).
template <bool BF16>
__device__ __forceinline__ void f2_out(const float (&d)[2][48], const Chain& c,
                                       float* __restrict__ out, int rows0, const B2Pos& p) {
  const int out_size = c.out_size;
  const int r0 = rows0 + p.row(0), r1 = rows0 + p.row(1);
#pragma unroll 1
  for (int o = 0; o < out_size; ++o) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ni = 0; ni < B2_NI; ++ni)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = 96 * hf + 8 * ni + 2 * p.t + cc;
          const float wv = rnd<BF16>(__ldg(&c.wl[col * out_size + o]));
          s0 += d[hf][4 * ni + cc] * wv;
          s1 += d[hf][4 * ni + 2 + cc] * wv;
        }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (p.t == 0) {
      const float b = __ldg(&c.bl[o]);
      if (r0 < c.n) out[(size_t)r0 * out_size + o] = s0 + b;
      if (r1 < c.n) out[(size_t)r1 * out_size + o] = s1 + b;
    }
  }
}

// W's planes at c.wmt (ops/sine_mlp.weight_planes at width 192, both
// images, as the width-192 backward takes them; this reads the forward one).
template <bool BF16, bool MX, bool MB>
__global__ void __launch_bounds__(BW_THREADS, 1)
sine_mlp_fwd_wg192_kernel(Chain c_arg, const float* __restrict__ x, float* __restrict__ out,
                          long long x_stride) {
  using P = BwPlanes<BF16, MX>;
  using S = F2Smem<P::W>;
  using R = typename S::Ring;
  __shared__ MemberFwd mf;
  if constexpr (MB) {
    member_fwd<B2_H>(mf, c_arg, x, out, x_stride);
    __syncthreads();
  }
  const Chain& c = chain_of<MB>(mf, c_arg);
  const auto X = [&] { if constexpr (MB) return mf.x; else return x; };
  const auto OUT = [&] { if constexpr (MB) return mf.out; else return out; };
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int tid0 = threadIdx.x;
  const int L = c.depth - 2;
  const int n_tiles = (c.n + F2_T - 1) / F2_T;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // member m's images m apart
  const __nv_bfloat16* planes = reinterpret_cast<const __nv_bfloat16*>(c_arg.wmt) +
                                (MB ? (size_t)blockIdx.y * 2 * L * R::NS * P::W * R::PLANE : 0);
  WgRing<P::W, R> ring{smem, planes, L, my_tiles * L * R::NS};
  if (tid0 == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid0 == 0)
    for (int q = 0; q < R::NB && q < ring.total; ++q) ring.fill(q);

  // A thread's place is made anew from an opaque tid at each tile and layer,
  // as in the width-192 backward: addresses made from it are not held in
  // registers across the loops.
  float d[2][48];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tid = opaque(tid0);
    const int rows0 = tile * F2_T + 64 * (tid >> 7);  // the warpgroup's first row
    const float* xt = X();
    const auto xv = [&](int r, int k) {
      return rows0 + r < c.n ? rnd<BF16>(__ldg(xt + (size_t)(rows0 + r) * c.in_size + k)) : 0.f;
    };
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      first_layer_wg<BF16, B2_H>(d[hf], c, xv, B2Pos(128 * hf + (tid & 127)));
    for (int l = 0; l < L; ++l) {
      const int tid = opaque(tid0);
      const int wg = tid >> 7;
      uint8_t* act_s = smem + S::ACT + wg * S::WG_ACT;
      // the warp's rows of act_s are read only by its own part of the last
      // product, which has completed: no barrier before the stores
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const B2Pos p(128 * hf + (tid & 127));
        b2_sine<BF16, MX, false>(d[hf], c.bs + l * B2_H, l == 0 ? c.omega0 : c.omega_h, nullptr,
                                 p, tid);
        b2_store_planes<P::A>(act_s, d[hf], p);
      }
      iit::fence_async_shared();  // the planes' stores, before the products read them
      b2_wg_sync(wg);
      f2_product<P::A, P::W>(d, iit::smem_u32(act_s), ring);  // z_{l+1} - b_{l+1}
    }
    const int tid_l = opaque(tid0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      b2_sine<BF16, MX, false>(d[hf], c.bs + L * B2_H, L == 0 ? c.omega0 : c.omega_h, nullptr,
                               B2Pos(128 * hf + (tid_l & 127)), tid_l);
    f2_out<BF16>(d, c, OUT(), rows0, B2Pos(tid_l & 127));
  }
}

// ------------------------------------------------- the layer-wise kernels
//
// Hidden widths above 192 (LW_MIN; any width: the kernel width is the
// model's rounded up to a multiple of LW_N = 128, the block tile's columns;
// padded units stay exactly 0). A fused chain holds less of a tile per
// block as the width grows: the mma.sync kernels that ran 256 and 512 until
// the layer-wise kernels overtook them streamed every W through a ring for
// 32-96 rows a block, and their shared memory at 32-row tiles, the least a
// warp's 32 x 64 piece allows, was 200,728 B at 512 and would be 250,392 B
// at 640, past the 232,448 B a block has. So each layer is a launch of its
// own, with the activations of a layer between launches in device memory
// (L2 and HBM): a layer does 2 h FLOP per float of activation it reads and
// writes (h / 6 per byte: 43 at 256, 107 at 640; the reads of a tile's rows
// are shared in L2 by the h / 128 blocks of its slice), so the traffic
// costs little next to the products. One compiled instance serves every width:
// the width is a run-time argument (LayerArgs::hidden), as are the rows.
// Four kernels, every offset 64-bit (at 512^2, d8, w2048 the z stash alone
// is 3.76e9 floats):
// - sine_mlp_layer_fwd_kernel: kLwFirst z_0 = x W_0 + b_0 (FMA, K = in),
//   kLwHidden z_l = a_{l-1} W_l + b_l (the tensor cores), each with the
//   epilogue a = rnd(sin(omega z)) (fast_sin) and, where a stash is given
//   (K1 under autograd, band by band; K2's recompute without one), z into
//   it; kLwLast out = a_L W_{D-1} + b_{D-1} (FMA, N = out).
// - sine_mlp_layer_bwd_kernel: kLwLast ga_L = rnd(g) W_{D-1}^T (FMA) with
//   dW_{D-1} = a_L^T rnd(g), db_{D-1}; kLwHidden ga_{l-1} = G_l W_l^T (the
//   tensor cores); the epilogue of both gz = rnd(ga) omega cos(omega z) (ga
//   rounded under MX), stores G = rnd(gz) (the next product's A and dW's B),
//   sums db and, where the layer below is the first, dW_0 = x^T G; kLwHidden
//   also writes dW_l's A operand, rnd(a_{l-1}) = rnd(sin(omega z_{l-1})),
//   in place of z_{l-1}, which nothing reads after it. kLwFirst dx = G_0
//   W_0^T (FMA, N = in).
// - sine_mlp_layer_dw_kernel: dW_l = A_l^T G_l over row splits (one launch
//   a layer, after the layer's kLwHidden, so two G buffers serve every
//   layer), each split's sums into its partial slice.
// - sum_partials, unchanged.
// Products: the hidden forward, the hidden backward and dW on bf16 wgmma,
// fp32 as three bf16 planes per operand and six passes, fed by tensor-map
// and bulk copies through mbarrier rings from one feeding thread, the
// consumers' warpgroups apart from it (their design: "the layer-wise
// products on wgmma" below). The first and last layers are passes that
// stream an N x h matrix with a few FMAs an element ("the first and last
// layers: streaming passes" below). Grid: the rows' 128-row tiles split into S
// contiguous slices (ops/sine_mlp.layer_slices: at most the SMs / (h /
// 128), so one wave), block (s, c) taking column tile c of slice s's
// tiles, its stage stream running on across the tiles (the narrow kinds,
// forward kLwLast and backward kLwFirst, stride over groups of rows
// instead); grid y = member (every pointer moves by its member stride:
// each member gets its single launch's bits). No atomics: each address of
// a partial slice belongs to one thread of one block, which sums it in a
// fixed order and stores it once, so a run repeats bit for bit.
// Memory at 512^2, d8 (N = 262,144): the z stash, (D-1) N h floats (1.9 /
// 3.8 / 4.7 / 7.5 / 15.0 GB at 256 / 512 / 640 / 1024 / 2048). Under autograd (a fit or finetune
// step: ops/sine_mlp's Functions) K1 fills it, each band of its rows
// (ops/sine_mlp.layer_band_rows: two activation buffers near 1 GB) writing
// its rows of every z_l, and K2 takes it and starts at the last layer's
// backward; renders and evals under no_grad allocate none, and K2 called
// alone (sine_mlp_bwd) fills its own by the recompute over all rows. K2
// adds two N x h buffers (the recompute's activations, then the G's: 1.3 /
// 2.1 / 4.3 GB) and S partial slices (0.26 / 0.43 / 0.81 GB). The stash is
// live from K1 to the end of K2, one per pixel chunk (two for the
// wavelet-SIREN's two SIRENs, M over a member axis); the user's lever is
// train.pixel_chunks, as in JAX.
// Accuracy: the chain products sum K in groups of 128 from zero (LW_K_GROUP)
// and dW its rows in groups of 1,024 (LW_DW_GROUP), so the fp32 error does
// not drift with the width. The fp32 mode is checked against the plain chain
// at 256, 300 (384), 512, 576, 640, 1024, 2048 and 4096
// (tests/test_torch_kernels.py, chip_smoke.py phase 3, tools/grad_check.py);
// wider widths run unchecked.
// Not taken, for later speed work: the fused chain over a cluster of 2-4
// blocks that split a tile's columns and read each other's activations
// through distributed shared memory (it would keep the activations on chip
// and drop the z stash, but needs a cluster-wide barrier per layer and a
// tile design per cluster size); and multicast of the shared operand to a
// cluster's blocks (W's planes to the blocks of one column tile, A's rows to
// those of one dW row tile), which would cut the L2 re-reads that the 128 x
// 128 tiles leave.
constexpr int LW_T = 128;    // pixel rows of a block tile
constexpr int LW_N = 128;    // columns of a block tile: the kernel width is a multiple
constexpr int LW_KC = 32;    // K of a chunk of the products (a ring stage: two k-steps)
constexpr int LW_MIN = 192;  // the widest fused kernel; the layer-wise kernels run above it
enum LwKind { kLwFirst = 0, kLwHidden = 1, kLwLast = 2 };

}  // namespace

// One launch of a layer kernel (ops/cuda_build.LayerArgs mirrors it). Each
// matrix is row-major with the row stride its width says; *_m: floats from a
// member's matrix to the next (grid y). Outside the anonymous namespace: the
// C launchers take it, and a type of internal linkage would give them
// internal linkage too (nvcc's front end does), so no part would export them.
struct LayerArgs {
  const float* src;  // fwd: the layer's input rows (x, a_{l-1}, a_L); bwd kLwLast: g; dW: A_l
  const float* g;    // bwd kLwHidden: G_l (the product's A); kLwFirst: G_0; dW: G_l
  const float* w;    // W_0 (in, H); kLwHidden: W_l's (fwd) or W_l^T's (bwd) bf16 planes
                     // (ops/sine_mlp.layer_weight_planes); W_{D-1} (H, out)
  const float* b;    // fwd: the layer's bias
  float* dst;        // fwd: a_l (n, H) or out (n, out), null: not stored; bwd: G (n, H) or dx (n, in)
  float* z;          // fwd: z_l's stash (n, H) or null; bwd: the z below (kLwHidden: A_l written over it)
  const float* x;    // bwd: x (n, in) where the layer below is the first (dW_0), else null
  float* part;       // bwd, dW: the partial slices (S, n_part)
  long long src_m, g_m, w_m, b_m, dst_m, z_m, x_m, part_m;
  long long n;       // rows
  long long n_part;  // floats of a partial slice
  long long off_db, off_dw0, off_dwl, off_dbl, off_dw;  // regions of a slice: db of the layer
                                                        // below, dW_0, dW_{D-1}, db_{D-1}, dW_l
  int in_size, hidden, out_size, slices;
  float omega;  // of the layer's sine (fwd) or of the z below (bwd)
  int members;
};

namespace {

// Thread 0 copies the launch's arguments into shared memory with every
// pointer at member blockIdx.y's matrices; call before anything reads p,
// then every thread reads them there (no 200-byte copy in registers).
__device__ __forceinline__ void lw_member(LayerArgs& p, const LayerArgs& a) {
  if (threadIdx.x == 0) {
    const long long m = blockIdx.y;
    p = a;
    if (p.src) p.src += m * a.src_m;
    if (p.g) p.g += m * a.g_m;
    if (p.w) p.w += m * a.w_m;
    if (p.b) p.b += m * a.b_m;
    if (p.dst) p.dst += m * a.dst_m;
    if (p.z) p.z += m * a.z_m;
    if (p.x) p.x += m * a.x_m;
    if (p.part) p.part += m * a.part_m;
  }
  __syncthreads();
}

// A block's column tile (columns n0 ..) and its slice's row tiles [t0, t1):
// block s * (H / LW_N) + c takes column tile c of slice s.
struct LwTiles {
  int n0, slice;
  long long t0, t1;
  __device__ __forceinline__ explicit LwTiles(const LayerArgs& p) {
    const int cols = p.hidden / LW_N;
    slice = blockIdx.x / cols;
    n0 = (blockIdx.x % cols) * LW_N;
    const long long nt = (p.n + LW_T - 1) / LW_T;
    t0 = slice * nt / p.slices;
    t1 = (slice + 1) * nt / p.slices;
  }
};

// The chain products' K in groups of LW_K_GROUP chunks (K = 128), each
// summed from zero by the tensor cores and then added into the product by
// an fp32 add. The tensor cores' accumulator add does not round to nearest,
// so one accumulator over the whole K drifts with K: with it the fp32 mode
// read 3.5e-5 / 4.7e-5 / 9.1e-5 of dx's largest value at K = 640 / 1024 /
// 2048 against the plain chain, with the groups 7.6e-6 / 7.8e-6 / 9.1e-6
// (tools/grad_check.py, H100, 700 W).
constexpr int LW_K_GROUP = 4;
static_assert(LW_N % (LW_K_GROUP * LW_KC) == 0, "a kernel width holds whole K groups");

// The sum of v over the 8 lanes that hold a column (xor 4, 8, 16: fixed).
__device__ __forceinline__ float lw_lanes(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// dW's rows summed from zero in the accumulators before they are added to
// the running total: LW_DW_GROUP x 32 = 1,024 rows. One accumulator over a
// whole split (16,384 rows at 512², w1024) read 1.5e-4 of max |dW| against
// the plain chain in float64, growing with the split's rows; the plain fp32
// chain reads 5e-6 (H100, 700 W).
constexpr int LW_DW_GROUP = 32;

// ------------------------------------ the layer-wise products on wgmma
//
// sine_mlp_layer_fwd's and sine_mlp_layer_bwd's kLwHidden and
// sine_mlp_layer_dw. Feeding warps and
// two consuming warpgroups: one thread stages the operands' fp32 rows by
// tensor copies (the TMA: a box of a tensor map a request, 128-byte
// swizzle) and, in the forward, W's planes by a bulk copy, through an
// mbarrier ring; in dW two feeding warpgroups split each staged chunk of G
// into bf16 planes. The consumers, 64 rows each of the block's 128 x 128
// tile, load their A fragments of a k-step from the staged fp32 rows, split
// them into planes in registers between commits, and issue bf16 wgmma
// m64n128k16 with A from registers, B from shared memory (N-major) and
// fp32 accumulators. fp32 is three bf16 planes per operand and the six
// passes of the header note (wg_passes), an operand that is a bf16 value
// already one plane (BwPlanes: the bf16 mode, and W and the activations
// under MX). The roles split once, at the top, and never rejoin: setmaxnreg
// gives the feeders' registers to the consumers (each holds a group's
// accumulator and the running total, 128 floats), and no barrier of the
// block runs after the split: the warpgroups meet only at the rings'
// mbarriers. Bound at 512², w640 / w1024 (d8, fp32: 6 passes at 989
// TFLOP/s): 1.30 / 3.33 ms a hidden layer, each kernel; their traffic (A
// and W's planes re-read per tile from L2, 8.4 GB a layer at 640 in the
// forward, 6.7 GB in dW) is what their tiles cannot shrink: a block's 128 x
// 128 tile is the most the consumers' registers hold, and a wider tile
// would not divide every multiple of 128.

// The warp is done with a stage or slot: its lane 0 arrives on `bar`, an
// mbarrier of the consumers' 8 warps.
__device__ __forceinline__ void lwg_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) iit::mbar_arrive(bar);
}

// A consumer warpgroup's product over one staged chunk of K = 32 (two
// k-steps): d (+)= A B, A's fragments of k-step kk from frag(kk, a), B's
// planes at shared address b0 + kk 4096 (planes `plane` bytes apart;
// core matrix (kg, ng) of a plane at (kg 16 + ng) 128 bytes, so kLbo and
// kSbo). FIRST: d starts from zero. One group of wgmma stays in flight
// behind the next issue: before k-step 0's operands are used, the previous
// chunk's k-step 1 (`held`, its slot's empty barrier, or null) is waited for
// and its slot released; on return k-step 0 is done and k-step 1 in flight
// (held = this chunk's slot), or, END, both done, the slot released and
// done(d) called (the group's sum into the total: d is read only there,
// behind the wait, or ptxas serializes the products with waits of its own).
template <int PA, int PB, class Frag, class Done>
__device__ __forceinline__ void lwg_chunk(float (&d)[64], uint32_t (&a0)[PA][1][4],
                                          uint32_t (&a1)[PA][1][4], Frag frag, Done done,
                                          uint32_t b0, uint32_t plane, bool first, bool end,
                                          uint64_t*& held, uint64_t* empty) {
  frag(0, a0);
  iit::wg_fence();
  wg_passes<PA, PB, 1, 1>(d, a0, 0, b0, plane, first);
  iit::wg_commit();
  iit::wg_wait<1>();
  fence_planes(a1);
  if (held != nullptr) lwg_release(held);
  frag(1, a1);
  iit::wg_fence();
  wg_passes<PA, PB, 1, 1>(d, a1, 0, b0 + 4096, plane, false);
  iit::wg_commit();
  if (end) {
    iit::wg_wait<0>();
    iit::fence_regs(d);
    fence_planes(a0);
    fence_planes(a1);
    lwg_release(empty);
    held = nullptr;
    done(d);
  } else {
    iit::wg_wait<1>();
    fence_planes(a0);
    held = empty;
  }
}

// -------- sine_mlp_layer_fwd, kLwHidden: z_l = a_{l-1} W_l + b_l on wgmma
//
// Block (s, c) of tile_grid walks slice s's row tiles and, for each, K = H
// of the activations a_{l-1} (n, H) against W's column tile c, in stages of
// LF_KC: the activations' 128 rows x 32 fp32, one tensor copy of a box (a
// tensor map of a_{l-1}, 128-byte swizzle, rows from n on zeros) and W's
// chunk, its planes of 32 x 128 bf16 as ops/sine_mlp.layer_weight_planes
// packs them once per launch (one bulk copy), both issued by one thread
// (a bulk copy a row, or cp.async from the feeding warpgroup, held the
// layer to its copies: PERF.md §6). A consumer loads its 64 rows'
// fragments of a k-step from the stage, splits them into planes in
// registers and issues the k-step's passes. K is
// summed in groups of 128 (LW_K_GROUP, LF_GROUP stages) from zero in `grp`,
// each added into `tot` by fp32 adds in order. The epilogue (z = tot + b,
// the stash, a = rnd(sin(omega z))) of one warpgroup runs while the other's
// products are in flight: only the ring joins them, and its LF_NS stages
// (one K group) let one run a group ahead.
constexpr int LF_KC = 32;                             // K of a stage: two k-steps
constexpr int LF_NS = 5;                              // stages
constexpr int LF_GROUP = LW_K_GROUP * LW_KC / LF_KC;  // stages of a K group of 128
constexpr uint32_t LF_PLANE = LF_KC * LW_N * 2;  // bytes of one plane of W's chunk
constexpr size_t kLfW = (size_t)LW_T * LF_KC * 4;  // W's planes in a stage, after the activations
constexpr size_t kLfStage = kLfW + 3 * (size_t)LF_PLANE;
constexpr size_t kLfBar = LF_NS * kLfStage;  // full[LF_NS], then empty[LF_NS]
// + 1 KB: the stages start at the first 1024-byte boundary (the swizzled box)
constexpr size_t kLfSmem = kLfBar + 2 * LF_NS * sizeof(uint64_t) + 1024;
static_assert(kLfW % 1024 == 0 && kLfStage % 1024 == 0 && kLfSmem + sizeof(LayerArgs) <= 232448,
              "the hidden forward's shared memory");
static_assert(LW_N % LF_KC == 0 && LF_KC == 32, "a stage is two k-steps; a width holds whole stages");
constexpr int LF_THREADS = 384;  // a feeding warpgroup, two consuming
constexpr int LF_FEED_REGS = 40, LF_CONS_REGS = 232;  // 128 x 40 + 256 x 232 <= 65,536

// The A fragments of k-step kk of a stage's activations (the swizzled box)
// for the thread's tile rows r, r + 8, split into NP planes: a[j] = A(r + 8
// (j & 1), 16 kk + 2 t + 8 (j >> 1) + {0, 1}).
template <int NP>
__device__ __forceinline__ void lf_frags(const uint8_t* __restrict__ a_s, int r, int kk, int t,
                                         uint32_t (&a)[NP][1][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(
        a_s + iit::swz128(r + 8 * (j & 1), 16 * kk + 2 * t + 8 * (j >> 1)));
    uint32_t pl[NP];
    iit::split_planes<NP>(v.x, v.y, pl);
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i][0][j] = pl[i];
  }
}

// z = tot + b at the warpgroup's rows row0 .. (below n) and the block's
// columns n0 ..: z into the stash (p.z), a = rnd(sin(omega z)) into p.dst,
// where they are given.
template <bool BF16, bool MX>
__device__ __forceinline__ void lf_epilogue(const float (&tot)[64], const LayerArgs& p, int n0,
                                            long long row0, const WgPos& pos) {
  const long long h = p.hidden;
  const float omega = p.omega;
  float* z_out = p.z;
  float* a_out = p.dst;
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    const int c = n0 + pos.col(ni);
    const float2 b = __ldg(reinterpret_cast<const float2*>(p.b + c));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = row0 + pos.row(hh);
      if (row >= p.n) continue;
      const float z0 = tot[4 * ni + 2 * hh] + b.x, z1 = tot[4 * ni + 2 * hh + 1] + b.y;
      const long long o = row * h + c;
      if (z_out != nullptr) __stcs(reinterpret_cast<float2*>(z_out + o), make_float2(z0, z1));
      if (a_out != nullptr)
        *reinterpret_cast<float2*>(a_out + o) =
            make_float2(rnd_act<BF16, MX>(iit::fast_sin(omega * z0)),
                        rnd_act<BF16, MX>(iit::fast_sin(omega * z1)));
    }
  }
}

template <bool BF16, bool MX>
__device__ __forceinline__ void lf_hidden(const LayerArgs& p, const CUtensorMap* tm, uint8_t* smem,
                                          int tid) {
  using P = BwPlanes<BF16, MX>;
  smem += (1024 - iit::smem_u32(smem) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kLfBar);
  uint64_t* empty = full + LF_NS;
  if (tid == 0) {
    for (int i = 0; i < LF_NS; ++i) {
      iit::mbar_init(full + i, 1);
      iit::mbar_init(empty + i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const LwTiles tl(p);
  const int kcs = p.hidden / LF_KC;
  if (tid < 128) {  // the feeding warpgroup: its thread 0 streams the stages
    iit::reg_dealloc<LF_FEED_REGS>();
    if (tid != 0) return;
    const __nv_bfloat16* wp = reinterpret_cast<const __nv_bfloat16*>(p.w) +
                              (size_t)(tl.n0 / LW_N) * kcs * P::W * (LF_KC * LW_N);
    const int member = p.src_m != 0 ? (int)blockIdx.y : 0;
    uint32_t q = 0;
    for (long long tile = tl.t0; tile < tl.t1; ++tile) {
      for (int kc = 0; kc < kcs; ++kc, ++q) {
        const int s = q % LF_NS;
        if (q >= LF_NS) iit::mbar_wait(empty + s, (q / LF_NS - 1) & 1);
        uint8_t* st = smem + s * kLfStage;
        iit::mbar_expect_tx(full + s, kLfW + P::W * LF_PLANE);
        iit::tensor_g2s(st, tm, kc * LF_KC, (int)(tile * LW_T), member, full + s);
        iit::bulk_g2s(st + kLfW, wp + (size_t)kc * P::W * (LF_KC * LW_N), P::W * LF_PLANE,
                      full + s);
      }
    }
    return;
  }
  iit::reg_alloc<LF_CONS_REGS>();
  const int w = (tid >> 7) - 1;
  const WgPos pos(tid & 127);
  const int r_a = 64 * w + 16 * pos.wi + pos.g;  // the thread's first fragment row
  float tot[64], grp[64];
  uint32_t a0[P::A][1][4], a1[P::A][1][4];
  uint64_t* held = nullptr;
  uint32_t q = 0;
  for (long long tile = tl.t0; tile < tl.t1; ++tile) {
    for (int kc = 0; kc < kcs; ++kc, ++q) {
      const int s = q % LF_NS;
      iit::mbar_wait(full + s, (q / LF_NS) & 1);
      const uint8_t* a_s = smem + s * kLfStage;
      const bool end = kc % LF_GROUP == LF_GROUP - 1;  // a tile ends a group
      lwg_chunk<P::A, P::W>(
          grp, a0, a1,
          [&](int kk, uint32_t(&a)[P::A][1][4]) { lf_frags<P::A>(a_s, r_a, kk, pos.t, a); },
          [&](const float(&d)[64]) {
#pragma unroll
            for (int i = 0; i < 64; ++i) tot[i] = kc < LF_GROUP ? d[i] : tot[i] + d[i];
          },
          iit::smem_u32(smem + s * kLfStage + kLfW), LF_PLANE, kc % LF_GROUP == 0, end, held,
          empty + s);
    }
    iit::wg_wait<0>();  // a tile ends a group (none in flight): ptxas cannot see that
    lf_epilogue<BF16, MX>(tot, p, tl.n0, tile * LW_T + 64 * w, pos);
  }
}

// -------- sine_mlp_layer_bwd, kLwHidden: ga_{l-1} = G_l W_l^T on wgmma
//
// The forward's design and product shape: block (s, c) of tile_grid walks
// slice s's row tiles and, for each, K = H of G_l (n, H) against column
// tile c of W_l^T, in stages of LF_KC: G's 128 rows x 32 fp32 by one tensor
// copy of a box (a tensor map of G, 128-byte swizzle, rows from n on
// zeros) and W^T's chunk of planes (ops/sine_mlp.layer_weight_planes of
// W^T, packed once per K2 call) by one bulk copy, both from one feeding
// thread. The consumers split their A fragments of G into BwPlanes::G
// planes in registers and issue the passes against W^T's BwPlanes::W
// planes (six in fp32, three in fp32+mixed, one in bf16), K summed in
// groups of 128 from zero (LW_K_GROUP). The same thread also copies the
// tile's z (128 x 128 fp32, four tensor-copy boxes of a map of z) into a
// buffer of its own while the tile's products run, once the epilogue of
// the tile before is done with it (zfull / zempty). The epilogue of a
// warpgroup's 64 rows, gz = rnd<MX>(ga) omega cos(omega z), G_{l-1} =
// rnd(gz) into p.dst and A_{l-1} = rnd_act(sin(omega z)) over z in device
// memory (which nothing reads after it: sine_mlp_layer_dw takes it as its
// A), reads z from the buffer and runs while the other warpgroup's
// products are in flight, as the forward's does: only the ring joins the
// warpgroups. (z read from device memory in the epilogue held the kernel to
// its loads' latency, even behind an L2 prefetch; the epilogue cut into
// pieces under the next tile's first K group read slower in bf16 and
// "+mixed": PERF.md §6, PR 22.) db's column sums: the thread's two
// rows, then its column's 8 lanes by shuffles, then tile after tile in a
// running sum held by one of those lanes (lane g holds column pairs g and
// g + 8 of its 16); at the end the 8 consumer warps meet at named barriers
// of their 256 threads, and one thread a column adds the warps' sums in
// warp order through shared memory and stores them into the slice. FIRST
// (the layer below is the first) then sums dW_0 = x^T G_{l-1} over the
// slice's rows from G_{l-1} as stored, two threads a column (half the rows
// each, then added in order). A fixed order throughout: a run repeats bit
// for bit, with no atomics.
constexpr int LB_NS = 4;  // stages (z's buffer takes the forward's fifth)
// The hidden backward's shared memory: LB_NS stages, z's buffer (four
// 32-column boxes of 128 rows) from byte kLbZ, then full[LB_NS],
// empty[LB_NS], zfull, zempty from kLbBar; + 1 KB: the stages and z start
// at 1024-byte boundaries (the swizzled boxes). The column sums meet in the
// first stage at the end.
constexpr size_t kLbZ = LB_NS * kLfStage, kLbBar = kLbZ + (size_t)LW_T * LW_N * 4;
constexpr size_t kLbSmem = kLbBar + (2 * LB_NS + 2) * sizeof(uint64_t) + 1024;
static_assert(kLbSmem + sizeof(LayerArgs) <= 232448 && (8 + MAX_IO) * LW_N * 4 <= kLfStage &&
                  kLfW == (size_t)LW_T * 32 * 4,
              "the hidden backward's shared memory");

// The epilogue of the warpgroup's rows row0 + r + 8 hh (tot their
// product; rt + 8 hh the same rows in the tile) from z's buffer z_s; db:
// the thread's running column sums of db, of column pairs g and g + 8.
template <bool BF16, bool MX>
__device__ __forceinline__ void lb_epilogue(const float (&tot)[64], const uint8_t* __restrict__ z_s,
                                            const LayerArgs& p, float (&db)[2][2], int n0,
                                            long long row0, int r, int rt, int g, int t) {
  const long long h = p.hidden;
  const float omega = p.omega;
#pragma unroll
  for (int ni = 0; ni < 16; ++ni) {
    const int c = 8 * ni + 2 * t;
    float v[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = row0 + r + 8 * hh;
      // the box of column c, its row rt + 8 hh of the tile
      const float2 zv = *reinterpret_cast<const float2*>(z_s + (c >> 5) * kLfW +
                                                         iit::swz128(rt + 8 * hh, c & 31));
      const float zz[2] = {zv.x, zv.y};
      const bool valid = row < p.n;
      float gb[2], av[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float d = omega * iit::fast_cos(omega * zz[cc]);
        v[hh][cc] = valid ? rnd<MX>(tot[4 * ni + 2 * hh + cc]) * d : 0.f;
        gb[cc] = rnd<BF16>(v[hh][cc]);
        av[cc] = rnd_act<BF16, MX>(iit::fast_sin(omega * zz[cc]));
      }
      if (valid) {
        const long long o = row * h + n0 + c;
        *reinterpret_cast<float2*>(p.dst + o) = make_float2(gb[0], gb[1]);
        *reinterpret_cast<float2*>(p.z + o) = make_float2(av[0], av[1]);
      }
    }
    // the column pair's sums over the warp's 16 rows, into lane g = ni % 8's
    // running sums
    const float s0 = lw_lanes(v[0][0] + v[1][0]), s1 = lw_lanes(v[0][1] + v[1][1]);
    const bool mine = g == (ni & 7);
    db[ni >> 3][0] = mine ? db[ni >> 3][0] + s0 : db[ni >> 3][0];
    db[ni >> 3][1] = mine ? db[ni >> 3][1] + s1 : db[ni >> 3][1];
  }
}

// FIRST, after the tiles: dW_0[k] over the block's rows [r0, r1) from
// G_{l-1} as this block stored it (p.dst, the block's columns) and x,
// consumer thread ct (0-255) summing column ct % LW_N over half the rows
// in order, the second half's sums then added to the first's through
// shared memory (comb, MAX_IO x LW_N floats) under a named barrier.
template <bool BF16>
__device__ __forceinline__ void lb_dw0(const LayerArgs& p, const LwTiles& tl, long long r0,
                                       long long r1, float* __restrict__ comb, int ct) {
  const int c = ct % LW_N, half = ct / LW_N, in_size = p.in_size;
  const long long mid = (r0 + r1) / 2, a = half ? mid : r0, b = half ? r1 : mid;
  const float* g = p.dst + tl.n0 + c;
  float acc[MAX_IO];
#pragma unroll
  for (int k = 0; k < MAX_IO; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (long long row = a; row < b; ++row) {
    const float gv = g[row * p.hidden];
#pragma unroll
    for (int k = 0; k < MAX_IO; ++k)
      if (k < in_size) acc[k] += rnd<BF16>(__ldg(p.x + row * in_size + k)) * gv;
  }
  if (half)
    for (int k = 0; k < in_size; ++k) comb[k * LW_N + c] = acc[k];
  iit::named_barrier(1, 256);
  if (!half) {
    float* part = p.part + tl.slice * p.n_part + p.off_dw0 + tl.n0 + c;
    for (int k = 0; k < in_size; ++k) part[k * p.hidden] = acc[k] + comb[k * LW_N + c];
  }
}

template <bool BF16, bool MX, bool FIRST>
__device__ __forceinline__ void lb_hidden(const LayerArgs& p, const CUtensorMap* tm_g,
                                          const CUtensorMap* tm_z, uint8_t* smem, int tid) {
  using P = BwPlanes<BF16, MX>;  // G = rnd(gz): P::G planes; W^T: P::W
  smem += (1024 - iit::smem_u32(smem) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kLbBar);
  uint64_t* empty = full + LB_NS;
  uint64_t* zfull = empty + LB_NS;
  uint64_t* zempty = zfull + 1;
  uint8_t* z_s = smem + kLbZ;
  if (tid == 0) {
    for (int i = 0; i < LB_NS; ++i) {
      iit::mbar_init(full + i, 1);
      iit::mbar_init(empty + i, 8);
    }
    iit::mbar_init(zfull, 1);
    iit::mbar_init(zempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const LwTiles tl(p);
  const int kcs = p.hidden / LF_KC;
  if (tid < 128) {  // the feeding warpgroup: its thread 0 streams the stages and z
    iit::reg_dealloc<LF_FEED_REGS>();
    if (tid != 0) return;
    const __nv_bfloat16* wp = reinterpret_cast<const __nv_bfloat16*>(p.w) +
                              (size_t)(tl.n0 / LW_N) * kcs * P::W * (LF_KC * LW_N);
    const int mg = p.g_m != 0 ? (int)blockIdx.y : 0, mz = p.z_m != 0 ? (int)blockIdx.y : 0;
    // z after the tile's stage kz: by then the ring's slots have waited for
    // the tile's first stage to be consumed, so for the epilogue before
    const int kz = LB_NS < kcs - 1 ? LB_NS : kcs - 1;
    uint32_t q = 0;
    for (long long tile = tl.t0; tile < tl.t1; ++tile) {
      for (int kc = 0; kc < kcs; ++kc, ++q) {
        const int s = q % LB_NS;
        if (q >= LB_NS) iit::mbar_wait(empty + s, (q / LB_NS - 1) & 1);
        uint8_t* st = smem + s * kLfStage;
        iit::mbar_expect_tx(full + s, kLfW + P::W * LF_PLANE);
        iit::tensor_g2s(st, tm_g, kc * LF_KC, (int)(tile * LW_T), mg, full + s);
        iit::bulk_g2s(st + kLfW, wp + (size_t)kc * P::W * (LF_KC * LW_N), P::W * LF_PLANE,
                      full + s);
        if (kc == kz) {
          const long long k = tile - tl.t0;
          if (k > 0) iit::mbar_wait(zempty, (k - 1) & 1);
          iit::mbar_expect_tx(zfull, LW_T * LW_N * 4);
#pragma unroll
          for (int b = 0; b < LW_N / 32; ++b)
            iit::tensor_g2s(z_s + b * kLfW, tm_z, tl.n0 + 32 * b, (int)(tile * LW_T), mz, zfull);
        }
      }
    }
    return;
  }
  iit::reg_alloc<LF_CONS_REGS>();
  const int w = (tid >> 7) - 1;
  const WgPos pos(tid & 127);
  const int r_w = 16 * pos.wi + pos.g;  // the thread's first row of the warpgroup's 64
  const int r_a = 64 * w + r_w;         // and of the tile
  float db[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float tot[64], grp[64];
  uint32_t a0[P::G][1][4], a1[P::G][1][4];
  uint64_t* held = nullptr;
  uint32_t q = 0;
  for (long long tile = tl.t0; tile < tl.t1; ++tile) {
    for (int kc = 0; kc < kcs; ++kc, ++q) {
      const int s = q % LB_NS;
      iit::mbar_wait(full + s, (q / LB_NS) & 1);
      const uint8_t* a_s = smem + s * kLfStage;
      const bool end = kc % LF_GROUP == LF_GROUP - 1;  // a tile ends a group
      lwg_chunk<P::G, P::W>(
          grp, a0, a1,
          [&](int kk, uint32_t(&a)[P::G][1][4]) { lf_frags<P::G>(a_s, r_a, kk, pos.t, a); },
          [&](const float(&d)[64]) {
#pragma unroll
            for (int i = 0; i < 64; ++i) tot[i] = kc < LF_GROUP ? d[i] : tot[i] + d[i];
          },
          iit::smem_u32(a_s + kLfW), LF_PLANE, kc % LF_GROUP == 0, end, held, empty + s);
    }
    iit::wg_wait<0>();  // a tile ends a group (none in flight): ptxas cannot see that
    iit::mbar_wait(zfull, (tile - tl.t0) & 1);
    lb_epilogue<BF16, MX>(tot, z_s, p, db, tl.n0, tile * LW_T + 64 * w, r_w, r_a, pos.g, pos.t);
    lwg_release(zempty);
  }
  // db: the 8 warps' sums, added in warp order, one thread a column, in the
  // first stage once no warp reads the stages
  float* sums = reinterpret_cast<float*>(smem);
  iit::named_barrier(1, 256);
  float* mine = sums + ((tid >> 5) - 4) * LW_N + 8 * pos.g + 2 * pos.t;
#pragma unroll
  for (int i = 0; i < 4; ++i) mine[64 * (i >> 1) + (i & 1)] = db[i >> 1][i & 1];
  iit::named_barrier(1, 256);
  const int ct = tid - 128;
  if (ct < LW_N) {
    float v = sums[ct];
#pragma unroll
    for (int wd = 1; wd < 8; ++wd) v += sums[wd * LW_N + ct];
    p.part[tl.slice * p.n_part + p.off_db + tl.n0 + ct] = v;
  }
  if constexpr (FIRST)
    lb_dw0<BF16>(p, tl, tl.t0 * LW_T, tl.t1 * LW_T < p.n ? tl.t1 * LW_T : p.n, sums + 8 * LW_N, ct);
}

// ------------------------- sine_mlp_layer_dw: dW_l = A_l^T G_l on wgmma
//
// Block (s, tile) sums the 128 x 128 tile (m0, n0) of dW over split s's rows
// [s n / S, (s + 1) n / S) into row s of the partials at p.off_dw (row-major
// H x H); the blocks of a split are adjacent in the grid, so its rows come
// from HBM about once. Both operands reduce over the rows, so both are
// MN-major here. One thread stages chunks of LD_KC rows of both (A's
// columns m0 .., G's n0 ..) in fp32 through a ring of LD_NF slots, four
// tensor copies of 32-column boxes an operand (tensor maps of A and G,
// 128-byte swizzle). Two feeding warpgroups split each chunk's G into B's
// planes once, into a ring of LD_NPL plane slots; the consumers load their
// A fragments of a k-step from the fp32 slot and split them in registers
// between commits, as the hidden forward does (rows past the split are
// zeros in both). A slot goes back to the feeding thread once both
// consumer warpgroups hold its fragments and the feeders are done with its
// G. Rows are summed in groups of LW_DW_GROUP x 32 = 1,024 from zero in
// `acc`, each group added into the running total `tot` (registers) by fp32
// adds in order; one block writes each address once: no atomics, a run
// repeats bit for bit. (Row copies, cp.async, one feeding warpgroup and
// the feeders splitting A too each ran slower: PERF.md §6.)
constexpr int LD_KC = 32;                             // rows of a chunk: two k-steps
constexpr int LD_NF = 5;                              // fp32 chunk slots
constexpr int LD_NPL = 2;                             // plane slots
constexpr int LD_GROUP = LW_DW_GROUP * LW_KC / LD_KC;  // chunks of a row group of 1,024
constexpr int LD_BOX = LD_KC * 32 * 4;                // bytes of a 32-column box of a chunk
constexpr uint32_t LD_GPLANE = LD_KC * LW_N * 2;      // bytes: a plane of G's chunk
constexpr size_t kLdF32 = 2 * (size_t)LD_KC * LW_N * 4;  // a chunk slot: A's 4 boxes, G's
constexpr size_t kLdSlot = 3 * (size_t)LD_GPLANE;        // a plane slot: G's planes
constexpr size_t kLdPl = LD_NF * kLdF32;                 // the plane slots
// fp32 full, fp32 empty, planes full, planes empty
constexpr size_t kLdBar = kLdPl + LD_NPL * kLdSlot;
// + 1 KB: the slots start at the first 1024-byte boundary (the swizzled boxes)
constexpr size_t kLdSmem = kLdBar + 2 * (LD_NF + LD_NPL) * sizeof(uint64_t) + 1024;
static_assert(kLdF32 % 1024 == 0 && kLdSlot % 128 == 0 && kLdSmem + sizeof(LayerArgs) <= 232448,
              "sine_mlp_layer_dw's shared memory");
static_assert(LD_KC == 32, "a chunk is two k-steps, and four K groups");
constexpr int LD_FEEDERS = 256, LD_THREADS = LD_FEEDERS + 256;  // two feeding warpgroups, two consuming
// 256 x 64 + 256 x 192 = 65,536 (48 and 208: the fp32 instances spilled)
constexpr int LD_FEED_REGS = 64, LD_CONS_REGS = 192;

// Byte offset of element (r, c) of an operand's chunk in a slot: column box
// c / 32, 128-byte swizzled.
__device__ __forceinline__ int ld_at(int r, int c) { return (c >> 5) * LD_BOX + iit::swz128(r, c & 31); }

// G of chunk slot `f32` (its first `valid` rows; rows past them are zeros)
// into the NP planes of plane slot `pl` by feeding thread fc (0-255): warp
// fc / 32 takes K group fc / 64 (8 rows) and 8 of its 16 core matrices (8
// rows x 8 columns, 128 contiguous bytes), the loads first (the split is
// latency-bound).
template <int NP>
__device__ __forceinline__ void ld_split_g(const uint8_t* __restrict__ f32, uint8_t* __restrict__ pl,
                                           int valid, int fc) {
  const uint8_t* g_s = f32 + kLdF32 / 2;
  const int fw = fc >> 5, g = (fc & 31) >> 2, t = fc & 3;
  const int kg = fw >> 1, r = 8 * kg + g, ng0 = 8 * (fw & 1);
  float2 x[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    x[q] = r < valid ? *reinterpret_cast<const float2*>(g_s + ld_at(r, 8 * (ng0 + q) + 2 * t))
                     : make_float2(0.f, 0.f);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint32_t v[NP];
    iit::split_planes<NP>(x[q].x, x[q].y, v);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      *reinterpret_cast<uint32_t*>(pl + i * LD_GPLANE + (kg * 16 + ng0 + q) * 128 + g * 16 +
                                   t * 4) = v[i];
  }
}

// The A fragments of k-step kk of chunk slot `f32` (its first `valid` rows)
// for consumer warpgroup w's thread (wi, g, t), split into NP planes: a[j] =
// A^T(16 wi + g + 8 (j & 1), 2 t + 8 (j >> 1) + {0, 1}), dW's row 64 w + 16
// wi + g + 8 (j & 1) against the k-step's chunk rows.
template <int NP>
__device__ __forceinline__ void ld_frags(const uint8_t* __restrict__ f32, int valid, int w, int kk,
                                         const WgPos& pos, uint32_t (&a)[NP][1][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 16 * kk + 2 * pos.t + 8 * (j >> 1), c = 64 * w + 16 * pos.wi + pos.g + 8 * (j & 1);
    const float x0 = r < valid ? *reinterpret_cast<const float*>(f32 + ld_at(r, c)) : 0.f;
    const float x1 = r + 1 < valid ? *reinterpret_cast<const float*>(f32 + ld_at(r + 1, c)) : 0.f;
    uint32_t pl[NP];
    iit::split_planes<NP>(x0, x1, pl);
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i][0][j] = pl[i];
  }
}

// ------------------- the first and last layers: streaming passes
//
// sine_mlp_layer_bwd's kLwLast and sine_mlp_layer_fwd's kLwFirst do a few
// FMAs, a sine and (backward) a cosine per element of an N x h matrix that
// they read or write, and the narrow kinds (sine_mlp_layer_fwd's kLwLast,
// sine_mlp_layer_bwd's kLwFirst) 2 in or 2 out FLOP per element of one that
// they read: each is bound by those bytes (at 512², w640 on an H100: the
// backward's last layer reads z_L and writes G_L, 1.34 GB, 0.40 ms; the
// forward's first writes a_0 and, under autograd, z_0, 1.34 GB; the narrow
// ones read 0.67 GB, 0.20 ms), and their ~30 FP instructions an element
// take less than half of that. So each keeps memory busy and its
// arithmetic under the transfers:
// - The tile kinds (tile_grid: block (s, c) walks slice s's 128-row tiles
//   at column tile c) run 8 consumer warps and one feeding warp, which
//   streams each tile through an LS_NS-stage mbarrier ring: in the
//   backward z_L's 128 x 128 tile by tensor-map copies (four 32-column
//   boxes, as the hidden backward copies z) and g's (and, FIRST, x's) rows
//   by its lanes' loads, in the forward x's rows; LS_NS - 1 tiles are in
//   flight while the consumers work on one. A consumer thread owns fixed
//   columns for the whole slice: W's rows of them (W_{D-1}, or W_0 and b_0)
//   sit in its registers, loaded once, and the backward's column sums
//   (db_L, dW_{D-1}, FIRST dW_0) run in its registers, each tile's from zero
//   then added in tile order, and meet once at the slice's end, the column's
//   4 threads added in a fixed order through shared memory, into the
//   slice's partial (db_{D-1}: the feeding warp of column tile 0 sums g's
//   columns). The outputs (G_L; z_0 and a_0) go out from registers as
//   coalesced stores of whole 128-byte lines (a half-warp a row of a box in
//   the backward, 16 bytes a thread, a quarter-warp a row, in the
//   forward), which do not wait, so they stream under the next rows' work.
//   The sine and cosine share one range reduction (iit::fast_sincos, the
//   bits of fast_sin and fast_cos). The consumers' loops over the outputs
//   (inputs) are unrolled for the count where it is 3 (2), else run to
//   MAX_IO under a guard. G_L, z_0 and a_0 are elementwise: the chain's
//   bits; the column sums add in this order.
// - The narrow kinds (narrow_grid: 2 blocks an SM striding over 64-row
//   groups) hold W (W_{D-1} as out x h, W_0 as in x h) in shared memory,
//   rounded, loaded once a block (in chunks of columns past kLnSmem); a
//   warp takes 8 rows at a time, its lanes 16-byte loads of all 8 rows' next
//   columns in flight together, and sums each output over its lanes by a
//   transposed reduction (9 shuffles for the 8 rows' sums, where a
//   shuffle tree a row takes 40): each output a fixed order, any grid.
constexpr int LS_NS = 3;                               // the tile kinds' ring stages
constexpr int LS_CONS = 256;                           // their consumer threads (8 warps)
constexpr int LS_THREADS = LS_CONS + 32;               // and the feeding warp
constexpr size_t kLsRows = (size_t)LW_T * MAX_IO * 4;  // a tile's rows of g or x (flat)
constexpr size_t kLsZ = (size_t)LW_T * LW_N * 4;       // a tile of z: LW_N / 32 boxes of kLfW
constexpr size_t kLsStage = kLsZ + 2 * kLsRows;        // z, g's rows, x's rows
constexpr size_t kLsBar = LS_NS * kLsStage;            // full[LS_NS], then empty[LS_NS]
// + 1 KB: the stages start at the first 1024-byte boundary (the swizzled boxes)
constexpr size_t kLsSmem = kLsBar + 2 * LS_NS * sizeof(uint64_t) + 1024;
static_assert(kLsStage % 1024 == 0 && kLsZ == (LW_N / 32) * kLfW &&
                  kLsSmem + sizeof(LayerArgs) <= 232448 &&
                  (1 + 2 * MAX_IO) * 4 * LW_N * 4 <= kLsZ,
              "the backward's last layer: its ring, and the column sums in its first stage's z "
              "(the feeding warp may still read that stage's g rows)");
// the forward's first layer: a ring of x's rows, then full[LS_NS], empty[LS_NS]
constexpr size_t kLxSmem = LS_NS * kLsRows + 2 * LS_NS * sizeof(uint64_t);
constexpr int LN_THREADS = 256, LN_ROWS = 8;  // the narrow kinds: 8 warps, 8 rows a warp at a time
constexpr size_t kLnSmem = 64 * 1024;         // their W's (chunk's) bytes at most
constexpr int LN_BLOCKS_PER_SM = 2;

// The feeding warp's share of a tile: `count` floats of src from float
// `first` on (zeros from float `total` on) into dst, its lanes' loads in
// flight together.
__device__ __forceinline__ void ls_rows(float* __restrict__ dst, const float* __restrict__ src,
                                        long long first, long long total, int count, int lane) {
  constexpr int PER = LW_T * MAX_IO / 32;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < count && first + e < total ? __ldg(src + first + e) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (lane + 32 * i < count) dst[lane + 32 * i] = v[i];
}

// The ring's barriers: full[s] completes when the feeding warp's 32 lanes
// have staged their rows and (in the backward) its lane 0's tensor copies
// have landed (33 arrivals there: lane 0's expect_tx, then every lane's);
// empty[s] when the 8 consumer warps are done with the stage.
__device__ __forceinline__ void ls_init(uint64_t* full, uint64_t* empty, int feed_arrivals) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < LS_NS; ++i) {
      iit::mbar_init(full + i, feed_arrivals);
      iit::mbar_init(empty + i, LS_CONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ls_last_bwd's consumer warps, their loops over the outputs NO long (out
// = NO, or NO = MAX_IO with out <= NO).
template <bool BF16, bool MX, bool FIRST, int NO>
__device__ __forceinline__ void ls_last_cons(const LayerArgs& p, const LwTiles& tl, uint8_t* smem,
                                             uint64_t* full, uint64_t* empty, int tid) {
  const int in_size = p.in_size, out_size = NO == MAX_IO ? p.out_size : NO, lane = tid & 31;
  const long long n = p.n;
  const int w = tid >> 5, box = w & 3;
  const int c = 32 * box + 2 * (lane & 15), rs = 2 * (w >> 2) + (lane >> 4);
  const long long h = p.hidden;
  const float omega = p.omega;
  float* g_out = p.dst + tl.n0 + c;
  float wv[2][NO];  // rnd(W_{D-1}) at the thread's columns
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int o = 0; o < NO; ++o)
      wv[cc][o] = o < out_size ? rnd<BF16>(__ldg(p.w + (long long)(tl.n0 + c + cc) * out_size + o))
                               : 0.f;
  float db[2] = {0.f, 0.f}, dwl[2][NO] = {}, dw0[2][MAX_IO] = {};
  uint32_t q = 0;
  for (long long tile = tl.t0; tile < tl.t1; ++tile, ++q) {
    const int s = q % LS_NS;
    iit::mbar_wait(full + s, (q / LS_NS) & 1);
    const uint8_t* z_s = smem + s * kLsStage + box * kLfW;
    const float* g_s = reinterpret_cast<const float*>(smem + s * kLsStage + kLsZ);
    const float* x_s = g_s + LW_T * MAX_IO;
    float tdb[2] = {0.f, 0.f}, tdwl[2][NO] = {}, tdw0[2][MAX_IO] = {};
    const long long row0 = tile * LW_T;
#pragma unroll 4
    for (int i = 0; i < LW_T / 4; ++i) {
      const int r = 4 * i + rs;
      const long long row = row0 + r;
      const bool valid = row < n;
      const float2 zv = *reinterpret_cast<const float2*>(z_s + iit::swz128(r, c & 31));
      const float zz[2] = {zv.x, zv.y};
      float gq[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) gq[o] = o < out_size ? rnd<BF16>(g_s[r * out_size + o]) : 0.f;
      float gb[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float ga = 0.f;
#pragma unroll
        for (int o = 0; o < NO; ++o)
          if (o < out_size) ga += gq[o] * wv[cc][o];
        float sn, cs;
        iit::fast_sincos(omega * zz[cc], sn, cs);
        const float d = omega * cs;
        const float v = valid ? rnd<MX>(ga) * d : 0.f;
        gb[cc] = rnd<BF16>(v);
        const float av = valid ? rnd_act<BF16, MX>(sn) : 0.f;
        tdb[cc] += v;
#pragma unroll
        for (int o = 0; o < NO; ++o)
          if (o < out_size) tdwl[cc][o] += av * gq[o];
      }
      if constexpr (FIRST) {
#pragma unroll
        for (int k = 0; k < MAX_IO; ++k) {
          if (k >= in_size) break;
          const float xv = rnd<BF16>(x_s[r * in_size + k]);
          tdw0[0][k] += xv * gb[0];
          tdw0[1][k] += xv * gb[1];
        }
      }
      if (valid) *reinterpret_cast<float2*>(g_out + row * h) = make_float2(gb[0], gb[1]);
    }
    __syncwarp();
    if (lane == 0) iit::mbar_arrive(empty + s);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      db[cc] += tdb[cc];
#pragma unroll
      for (int o = 0; o < NO; ++o) dwl[cc][o] += tdwl[cc][o];
      if constexpr (FIRST) {
#pragma unroll
        for (int k = 0; k < MAX_IO; ++k) dw0[cc][k] += tdw0[cc][k];
      }
    }
  }
  // the slice's sums: slot 0 db, FIRST 1 + k dW_0[k], then o_slot + o
  // dW_{D-1}[., o]; the column's 4 threads (rs) meet in the first stage's
  // z (no tensor copy is in flight: every one issued was waited for; the
  // feeding warp of column tile 0 may still be reading g's rows after it)
  const int o_slot = 1 + (FIRST ? in_size : 0), slots = o_slot + out_size;
  float* red = reinterpret_cast<float*>(smem);
  iit::named_barrier(1, LS_CONS);  // every consumer is done with the stages
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    float* mine = red + rs * LW_N + c + cc;
    mine[0] = db[cc];
#pragma unroll
    for (int k = 0; k < MAX_IO; ++k)
      if (FIRST && k < in_size) mine[(1 + k) * 4 * LW_N] = dw0[cc][k];
#pragma unroll
    for (int o = 0; o < NO; ++o)
      if (o < out_size) mine[(o_slot + o) * 4 * LW_N] = dwl[cc][o];
  }
  iit::named_barrier(1, LS_CONS);
  float* part = p.part + tl.slice * p.n_part;
  for (int e = tid; e < slots * LW_N; e += LS_CONS) {
    const int slot = e / LW_N, col = e % LW_N;
    const float* rsum = red + slot * 4 * LW_N + col;
    const float v = ((rsum[0] + rsum[LW_N]) + rsum[2 * LW_N]) + rsum[3 * LW_N];
    float* d;
    if (slot == 0)
      d = part + p.off_db + tl.n0 + col;
    else if (slot < o_slot)
      d = part + p.off_dw0 + (slot - 1) * h + tl.n0 + col;
    else
      d = part + p.off_dwl + (tl.n0 + col) * (long long)out_size + (slot - o_slot);
    *d = v;
  }
}

// sine_mlp_layer_bwd, kLwLast: G_L = rnd(gz), gz = rnd<MX>(rnd(g) W_{D-1}^T)
// omega cos(omega z_L), and into the slice's partial db_L = sum gz, dW_{D-1}
// = sum a_L^T rnd(g) (a_L = rnd_act(sin(omega z_L))), db_{D-1} = sum g
// (column tile 0), FIRST dW_0 = sum rnd(x)^T G_L. Consumer thread (warp w,
// lane l) owns columns c, c + 1 (c = 32 (w % 4) + 2 (l % 16)) and rows
// 4 i + rs of each tile (rs = 2 (w / 4) + l / 16): a half-warp reads a
// 128-byte row of a box and writes G's row there.
template <bool BF16, bool MX, bool FIRST>
__device__ __forceinline__ void ls_last_bwd(const LayerArgs& p, const CUtensorMap* tm_z,
                                            uint8_t* smem, int tid) {
  smem += (1024 - iit::smem_u32(smem) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kLsBar);
  uint64_t* empty = full + LS_NS;
  ls_init(full, empty, 33);
  const LwTiles tl(p);
  const int in_size = p.in_size, out_size = p.out_size, lane = tid & 31;
  const long long n = p.n;
  if (tid >= LS_CONS) {  // the feeding warp
    const int mz = p.z_m != 0 ? (int)blockIdx.y : 0;
    float dbl = 0.f;  // column tile 0: lane q < out sums db_{D-1}[q]
    uint32_t q = 0;
    for (long long tile = tl.t0; tile < tl.t1; ++tile, ++q) {
      const int s = q % LS_NS;
      if (q >= LS_NS) iit::mbar_wait(empty + s, (q / LS_NS - 1) & 1);
      uint8_t* st = smem + s * kLsStage;
      if (lane == 0) {
        iit::mbar_expect_tx(full + s, (uint32_t)kLsZ);
#pragma unroll
        for (int b = 0; b < LW_N / 32; ++b)
          iit::tensor_g2s(st + b * kLfW, tm_z, tl.n0 + 32 * b, (int)(tile * LW_T), mz, full + s);
      }
      float* g_s = reinterpret_cast<float*>(st + kLsZ);
      ls_rows(g_s, p.src, tile * LW_T * out_size, n * out_size, LW_T * out_size, lane);
      if constexpr (FIRST)
        ls_rows(g_s + LW_T * MAX_IO, p.x, tile * LW_T * in_size, n * in_size, LW_T * in_size,
                lane);
      iit::mbar_arrive(full + s);
      if (tl.n0 == 0) {  // the tile's sum of g from zero, in row order, then into the total
        __syncwarp();
        if (lane < out_size) {
          float t = 0.f;
          for (int r = 0; r < LW_T; ++r) t += g_s[r * out_size + lane];
          dbl = tile == tl.t0 ? t : dbl + t;
        }
      }
    }
    if (tl.n0 == 0 && lane < out_size) p.part[tl.slice * p.n_part + p.off_dbl + lane] = dbl;
    return;
  }
  // the consumers, their loops over the outputs unrolled for the count
  // (no guard, no idle multiply of a padded output): 3 (RGB), any
  if (out_size == 3)
    ls_last_cons<BF16, MX, FIRST, 3>(p, tl, smem, full, empty, tid);
  else
    ls_last_cons<BF16, MX, FIRST, MAX_IO>(p, tl, smem, full, empty, tid);
}

// ls_first_fwd's consumer warps, their loops over the inputs NI long (in =
// NI, or NI = MAX_IO with in <= NI).
template <bool BF16, bool MX, int NI>
__device__ __forceinline__ void ls_first_cons(const LayerArgs& p, const LwTiles& tl,
                                              const uint8_t* smem, uint64_t* full,
                                              uint64_t* empty, int tid) {
  const float* x_ring = reinterpret_cast<const float*>(smem);
  const int in_size = NI == MAX_IO ? p.in_size : NI, lane = tid & 31;
  const long long n = p.n;
  const int w = tid >> 5;
  const int c = 32 * (w & 3) + 4 * (lane & 7), rs = 4 * (w >> 2) + (lane >> 3);
  const long long h = p.hidden;
  const float omega = p.omega;
  float wk[NI][4];  // rnd(W_0) at the thread's columns
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const float4 v = k < in_size ? __ldg(reinterpret_cast<const float4*>(p.w + k * h + tl.n0 + c))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    wk[k][0] = rnd<BF16>(v.x);
    wk[k][1] = rnd<BF16>(v.y);
    wk[k][2] = rnd<BF16>(v.z);
    wk[k][3] = rnd<BF16>(v.w);
  }
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(p.b + tl.n0 + c));
  const float bias[4] = {b4.x, b4.y, b4.z, b4.w};
  float* z_out = p.z == nullptr ? nullptr : p.z + tl.n0 + c;
  float* a_out = p.dst == nullptr ? nullptr : p.dst + tl.n0 + c;
  uint32_t q = 0;
  for (long long tile = tl.t0; tile < tl.t1; ++tile, ++q) {
    const int s = q % LS_NS;
    iit::mbar_wait(full + s, (q / LS_NS) & 1);
    const float* x_s = x_ring + s * (LW_T * MAX_IO);
    const long long row0 = tile * LW_T;
#pragma unroll 4
    for (int i = 0; i < LW_T / 8; ++i) {
      const int r = 8 * i + rs;
      const long long row = row0 + r;
      float xk[NI];
#pragma unroll
      for (int k = 0; k < NI; ++k) xk[k] = k < in_size ? rnd<BF16>(x_s[r * in_size + k]) : 0.f;
      float z[4], a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < NI; ++k)
          if (k < in_size) acc += xk[k] * wk[k][j];
        z[j] = acc + bias[j];
        a[j] = rnd_act<BF16, MX>(iit::fast_sin(omega * z[j]));
      }
      if (row < n) {
        if (z_out != nullptr)
          __stcs(reinterpret_cast<float4*>(z_out + row * h), make_float4(z[0], z[1], z[2], z[3]));
        if (a_out != nullptr)
          *reinterpret_cast<float4*>(a_out + row * h) = make_float4(a[0], a[1], a[2], a[3]);
      }
    }
    __syncwarp();
    if (lane == 0) iit::mbar_arrive(empty + s);
  }
}

// sine_mlp_layer_fwd, kLwFirst: z_0 = rnd(x) rnd(W_0) + b_0 (FMA over k <
// in, from zero), a_0 = rnd_act(sin(omega z_0)); z_0 into the stash (p.z)
// and a_0 into p.dst, where given. Consumer thread (warp w, lane l) owns
// columns c .. c + 3 (c = 32 (w % 4) + 4 (l % 8)) and rows 8 i + rs of each
// tile (rs = 4 (w / 4) + l / 8).
template <bool BF16, bool MX>
__device__ __forceinline__ void ls_first_fwd(const LayerArgs& p, uint8_t* smem, int tid) {
  float* x_ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + LS_NS * kLsRows);
  uint64_t* empty = full + LS_NS;
  ls_init(full, empty, 32);
  const LwTiles tl(p);
  const int in_size = p.in_size, lane = tid & 31;
  const long long n = p.n;
  if (tid >= LS_CONS) {  // the feeding warp: x's rows a tile ahead
    uint32_t q = 0;
    for (long long tile = tl.t0; tile < tl.t1; ++tile, ++q) {
      const int s = q % LS_NS;
      if (q >= LS_NS) iit::mbar_wait(empty + s, (q / LS_NS - 1) & 1);
      ls_rows(x_ring + s * (LW_T * MAX_IO), p.src, tile * LW_T * in_size, n * in_size,
              LW_T * in_size, lane);
      iit::mbar_arrive(full + s);
    }
    return;
  }
  // the consumers, their loops over the inputs unrolled for the count: 2
  // (an image's coordinates), any
  if (in_size == 2)
    ls_first_cons<BF16, MX, 2>(p, tl, smem, full, empty, tid);
  else
    ls_first_cons<BF16, MX, MAX_IO>(p, tl, smem, full, empty, tid);
}

// The sum over the warp's lanes of v[j] for j = (lane / 4) % 8, in every
// lane of the 4 that hold it: halves of v change hands at xor 16, 8 and 4
// (each lane keeping the half its lane bit says), then xor 2 and 1 add
// the rest; a fixed order.
__device__ __forceinline__ float ln_rows_sum(const float (&v)[LN_ROWS], int lane) {
  static_assert(LN_ROWS == 8, "three halvings");
  float a[4], b[2];
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (u16 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, u16 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (u8 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, u8 ? a[i] : a[i + 2], 8);
  float r = (u4 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, u4 ? b[0] : b[1], 4);
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  return r;
}

// The narrow kinds: dst[r][o] = sum_c src[r][c] rnd(w(c, o)) (+ bias[o]),
// o < no <= MAX_IO, src (n, K) rows 16-byte aligned, K a multiple of LW_N,
// w(c, o) = w[c sk + o so]; ws (dynamic shared memory, kLnSmem bytes)
// holds rnd(w) as no rows of kc columns. Lane l sums columns 4 l + 128 j ..
// + 3 of its warp's 8 rows in order of j, then ln_rows_sum.
template <bool BF16>
__device__ __forceinline__ void ln_rows(const float* __restrict__ src, int K,
                                        const float* __restrict__ w, long long sk, long long so,
                                        int no, const float* __restrict__ bias,
                                        float* __restrict__ dst, long long n,
                                        float* __restrict__ ws, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int fit = (int)(kLnSmem / (4 * no)) / LW_N * LW_N;
  const int kc = K < fit ? K : fit, chunks = (K + kc - 1) / kc;
  const auto stage = [&](int c0) {
    const int width = K - c0 < kc ? K - c0 : kc;
    for (int e = tid; e < no * width; e += LN_THREADS) {
      const int o = e / width, col = e % width;
      ws[o * kc + col] = rnd<BF16>(__ldg(w + (c0 + col) * sk + o * so));
    }
  };
  if (chunks == 1) {
    stage(0);
    __syncthreads();
  }
  constexpr int BLOCK_ROWS = LN_ROWS * LN_THREADS / 32;
  for (long long b0 = (long long)blockIdx.x * BLOCK_ROWS; b0 < n;
       b0 += (long long)gridDim.x * BLOCK_ROWS) {  // the block's trip count: its barriers
    const long long r0 = b0 + LN_ROWS * warp;
    float acc[LN_ROWS][MAX_IO] = {};
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = ch * kc, width = K - c0 < kc ? K - c0 : kc;
      if (chunks > 1) {
        __syncthreads();
        stage(c0);
        __syncthreads();
      }
      for (int j = 0; j < width / LW_N; ++j) {
        const int col = c0 + LW_N * j + 4 * lane;
        float4 v[LN_ROWS];
#pragma unroll
        for (int r = 0; r < LN_ROWS; ++r)
          v[r] = r0 + r < n ? __ldcs(reinterpret_cast<const float4*>(src + (r0 + r) * K + col))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int o = 0; o < MAX_IO; ++o) {
          if (o >= no) break;
          const float4 wv = *reinterpret_cast<const float4*>(ws + o * kc + (col - c0));
#pragma unroll
          for (int r = 0; r < LN_ROWS; ++r) {
            acc[r][o] += v[r].x * wv.x;
            acc[r][o] += v[r].y * wv.y;
            acc[r][o] += v[r].z * wv.z;
            acc[r][o] += v[r].w * wv.w;
          }
        }
      }
    }
    const long long row = r0 + ((lane >> 2) & 7);
#pragma unroll
    for (int o = 0; o < MAX_IO; ++o) {
      if (o >= no) break;
      float v[LN_ROWS];
#pragma unroll
      for (int r = 0; r < LN_ROWS; ++r) v[r] = acc[r][o];
      const float sum = ln_rows_sum(v, lane);
      if ((lane & 3) == 0 && row < n) dst[row * no + o] = bias != nullptr ? sum + __ldg(bias + o) : sum;
    }
  }
}

// The layer launchers' checks and grids (host code).
bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

// A tensor map of `members` row-major (rows, cols) fp32 matrices,
// member_stride floats apart (0: one, shared by the members), read in boxes
// of 32 columns x box_rows rows with 128-byte swizzle (iit::swz128), rows
// from `rows` on as zeros. cuTensorMapEncodeTiled comes through the
// runtime's driver entry point, so the library links no driver library.
cudaError_t row_tensor_map(CUtensorMap* map, const float* base, long long rows, long long cols,
                           int members, long long member_stride, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const bool many = members > 1 && member_stride != 0;
  if (rows < 1 || rows > INT_MAX || cols % 32 != 0 || member_stride % 4 != 0 || !aligned16(base))
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)(many ? members : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)(many ? member_stride : rows * cols) * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}
bool layer_args_ok(const LayerArgs* a) {
  return a != nullptr && a->hidden > 0 && a->hidden % LW_N == 0 && a->slices >= 1 &&
         a->members >= 1 && a->members <= 65535 && a->in_size >= 1 && a->in_size <= MAX_IO &&
         a->out_size >= 1 && a->out_size <= MAX_IO && a->n >= 0 &&
         a->slices <= (a->n + LW_T - 1) / LW_T;
}
// the narrow kinds: LN_BLOCKS_PER_SM blocks an SM (at most one per group of
// 64 rows), striding over the rest
dim3 narrow_grid(const LayerArgs* a, int sms) {
  const long long groups = (a->n + LN_ROWS * LN_THREADS / 32 - 1) / (LN_ROWS * LN_THREADS / 32);
  const long long most = (long long)LN_BLOCKS_PER_SM * sms;
  return dim3((unsigned)(groups < most ? groups : most), a->members);
}
dim3 tile_grid(const LayerArgs* a) { return dim3(a->slices * (a->hidden / LW_N), a->members); }

// kLwFirst: the streaming pass (ls_first_fwd, LS_THREADS threads); kLwHidden
// on wgmma (lf_hidden, LF_THREADS threads, p.w W's planes, tm a tensor map of
// src); kLwLast: the narrow pass (ln_rows, LN_THREADS threads). tm is read
// by kLwHidden only.
template <bool BF16, bool MX, int KIND>
__global__ void __launch_bounds__(KIND == kLwHidden  ? LF_THREADS
                                  : KIND == kLwFirst ? LS_THREADS
                                                     : LN_THREADS,
                                  KIND == kLwLast ? LN_BLOCKS_PER_SM : 1)
    sine_mlp_layer_fwd_kernel(LayerArgs arg, const __grid_constant__ CUtensorMap tm) {
  __shared__ LayerArgs p;
  lw_member(p, arg);
  const int tid = threadIdx.x;
  extern __shared__ float4 smem4[];
  if constexpr (KIND == kLwLast) {  // out = a_L W_{D-1} + b_{D-1}
    ln_rows<BF16>(p.src, p.hidden, p.w, p.out_size, 1, p.out_size, p.b, p.dst, p.n,
                  reinterpret_cast<float*>(smem4), tid);
  } else if constexpr (KIND == kLwHidden) {
    lf_hidden<BF16, MX>(p, &tm, reinterpret_cast<uint8_t*>(smem4), tid);
  } else {  // z_0 = x W_0 + b_0
    ls_first_fwd<BF16, MX>(p, reinterpret_cast<uint8_t*>(smem4), tid);
  }
}

// kLwLast: the streaming pass (ls_last_bwd, LS_THREADS threads, tm_z a
// tensor map of z); kLwHidden on wgmma (lb_hidden, LF_THREADS threads, p.w
// W^T's planes, tm_g and tm_z tensor maps of g and z); kLwFirst: the narrow
// pass (ln_rows, LN_THREADS threads, the maps not read).
template <bool BF16, bool MX, int KIND, bool FIRST>
__global__ void __launch_bounds__(KIND == kLwHidden ? LF_THREADS
                                  : KIND == kLwLast ? LS_THREADS
                                                    : LN_THREADS,
                                  KIND == kLwFirst ? LN_BLOCKS_PER_SM : 1)
    sine_mlp_layer_bwd_kernel(LayerArgs arg, const __grid_constant__ CUtensorMap tm_g,
                              const __grid_constant__ CUtensorMap tm_z) {
  __shared__ LayerArgs p;
  lw_member(p, arg);
  const int tid = threadIdx.x;
  extern __shared__ float4 smem4[];
  if constexpr (KIND == kLwFirst) {  // dx = G_0 W_0^T
    ln_rows<BF16>(p.g, p.hidden, p.w, 1, p.hidden, p.in_size, nullptr, p.dst, p.n,
                  reinterpret_cast<float*>(smem4), tid);
  } else if constexpr (KIND == kLwHidden) {
    lb_hidden<BF16, MX, FIRST>(p, &tm_g, &tm_z, reinterpret_cast<uint8_t*>(smem4), tid);
  } else {
    ls_last_bwd<BF16, MX, FIRST>(p, &tm_z, reinterpret_cast<uint8_t*>(smem4), tid);
  }
}

// dW_l = A_l^T G_l (its design: "sine_mlp_layer_dw" above).
template <bool BF16, bool MX>
__global__ void __launch_bounds__(LD_THREADS, 1)
    sine_mlp_layer_dw_kernel(LayerArgs arg, const __grid_constant__ CUtensorMap tm_a,
                             const __grid_constant__ CUtensorMap tm_g) {
  using P = BwPlanes<BF16, MX>;  // A = rnd_act(a): P::A planes; G = rnd(gz): P::G
  __shared__ LayerArgs p;
  lw_member(p, arg);
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  smem += (1024 - iit::smem_u32(smem) % 1024) % 1024;
  uint64_t* f32_full = reinterpret_cast<uint64_t*>(smem + kLdBar);
  uint64_t* f32_empty = f32_full + LD_NF;
  uint64_t* pl_full = f32_empty + LD_NF;
  uint64_t* pl_empty = pl_full + LD_NPL;
  const int tid = threadIdx.x;
  const long long h = p.hidden;
  const int cols = p.hidden / LW_N, tiles = cols * cols;
  const int tile = blockIdx.x % tiles, s = blockIdx.x / tiles;
  const int m0 = tile / cols * LW_N, n0 = tile % cols * LW_N;
  const long long r0 = s * p.n / p.slices, r1 = (s + 1) * p.n / p.slices;
  const int chunks = (int)((r1 - r0 + LD_KC - 1) / LD_KC);
  const auto valid = [&](int k) {
    const long long left = r1 - r0 - (long long)k * LD_KC;
    return left < LD_KC ? (int)left : LD_KC;
  };
  if (tid == 0) {
    for (int i = 0; i < LD_NF; ++i) {
      iit::mbar_init(f32_full + i, 1);
      iit::mbar_init(f32_empty + i, 8 + 1);  // the consumers' warps, the feeders
    }
    for (int i = 0; i < LD_NPL; ++i) {
      iit::mbar_init(pl_full + i, LD_FEEDERS);
      iit::mbar_init(pl_empty + i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < LD_FEEDERS) {  // the feeding warpgroups
    iit::reg_dealloc<LD_FEED_REGS>();
    // thread 0: chunk k's rows of A and G into fp32 slot k % LD_NF, four
    // 32-column boxes an operand
    const int ma = p.src_m != 0 ? (int)blockIdx.y : 0, mg = p.g_m != 0 ? (int)blockIdx.y : 0;
    const auto fill = [&](int k) {
      const int f = k % LD_NF, row0 = (int)(r0 + (long long)k * LD_KC);
      uint8_t* slot = smem + f * kLdF32;
      iit::mbar_expect_tx(f32_full + f, (uint32_t)kLdF32);
#pragma unroll
      for (int b = 0; b < LW_N / 32; ++b) {
        iit::tensor_g2s(slot + b * LD_BOX, &tm_a, m0 + 32 * b, row0, ma, f32_full + f);
        iit::tensor_g2s(slot + kLdF32 / 2 + b * LD_BOX, &tm_g, n0 + 32 * b, row0, mg,
                        f32_full + f);
      }
    };
    if (tid == 0)
      for (int k = 0; k < LD_NF && k < chunks; ++k) fill(k);
    for (int k = 0; k < chunks; ++k) {
      const int f = k % LD_NF, ps = k % LD_NPL;
      iit::mbar_wait(f32_full + f, (k / LD_NF) & 1);
      if (k >= LD_NPL) iit::mbar_wait(pl_empty + ps, (k / LD_NPL - 1) & 1);
      ld_split_g<P::G>(smem + f * kLdF32, smem + kLdPl + ps * kLdSlot, valid(k), tid);
      iit::fence_async_shared();  // the planes are read by wgmma (the async proxy)
      iit::mbar_arrive(pl_full + ps);
      iit::named_barrier(1, LD_FEEDERS);  // every feeding thread is done with G
      if (tid == 0) {
        iit::mbar_arrive(f32_empty + f);
        // the slot chunk k - 1 used, once the consumers hold its fragments
        const int kp = k - 1;
        if (kp >= 0 && kp + LD_NF < chunks) {
          iit::mbar_wait(f32_empty + kp % LD_NF, (kp / LD_NF) & 1);
          fill(kp + LD_NF);
        }
      }
    }
    return;
  }
  iit::reg_alloc<LD_CONS_REGS>();
  const int w = (tid - LD_FEEDERS) >> 7;
  const WgPos pos(tid & 127);
  float tot[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] = 0.f;
  uint32_t a0[P::A][1][4], a1[P::A][1][4];
  uint64_t* held = nullptr;
  for (int k = 0; k < chunks; ++k) {
    const int f = k % LD_NF, ps = k % LD_NPL, rows = valid(k);
    const uint8_t* f32 = smem + f * kLdF32;
    iit::mbar_wait(f32_full + f, (k / LD_NF) & 1);
    iit::mbar_wait(pl_full + ps, (k / LD_NPL) & 1);
    const bool end = (k + 1) % LD_GROUP == 0 || k + 1 == chunks;
    lwg_chunk<P::A, P::G>(
        acc, a0, a1,
        [&](int kk, uint32_t(&a)[P::A][1][4]) {
          ld_frags<P::A>(f32, rows, w, kk, pos, a);
          if (kk == 1) lwg_release(f32_empty + f);  // the fragments are in registers
        },
        [&](const float(&d)[64]) {
#pragma unroll
          for (int i = 0; i < 64; ++i) tot[i] += d[i];
        },
        iit::smem_u32(smem + kLdPl + ps * kLdSlot), LD_GPLANE, k % LD_GROUP == 0, end, held,
        pl_empty + ps);
  }
  iit::wg_wait<0>();  // the last chunk ends a group (none in flight): ptxas cannot see that
  float* out = p.part + s * p.n_part + p.off_dw + (m0 + 64 * w) * h + n0;
#pragma unroll
  for (int ni = 0; ni < 16; ++ni)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + pos.row(hh) * h + pos.col(ni)) =
          make_float2(tot[4 * ni + 2 * hh], tot[4 * ni + 2 * hh + 1]);
}

// ------------------------------------------------------ the partial sum
//
// out = the column sum of a (B, P) fp32 buffer, P % 4 == 0, in float4
// columns. Memory-bound (header note). The design, chosen by timing
// candidates in turns on an H100 (tools/sum_partials_ab.py, PERF.md):
// - kSumBlocksPerSm blocks per SM, block b taking float4 columns
//   [b C / grid, (b + 1) C / grid) of the C = P / 4: every SM the same
//   work, to one column (189 or 190 at the main path's shapes). Over a
//   member axis, while a member's share of a block fits its lanes (one
//   column a lane, as at width 128) each member has such a grid (grid y);
//   beyond (width 182: 423 columns a block), C = members x P / 4, the
//   members' columns one flat range over one wave of blocks (a grid per
//   member left most lanes idle in the last round of each of 8 waves);
// - in a block, kSumGroups row groups (the split of the header note) of
//   kSumLanes threads; a thread sums one float4 column over its group's
//   rows in index order, kSumUnroll loads issued before their adds;
// - the group sums meet in shared memory, kSumCols columns at a time, and
//   are added in group order.
// Loads stream past L1 (__ldcs): each value is read once. More groups
// (rows read at once: 4, 8, 16) and more, smaller blocks read slower on
// the card.
constexpr int kSumGroups = 2;  // row groups
constexpr int kSumLanes = 192;  // threads of a group, one float4 column each
constexpr int kSumBlocksPerSm = 1;
constexpr int kSumUnroll = 16;
constexpr int kSumThreads = kSumGroups * kSumLanes;
constexpr int kSumCols = 2048 / kSumGroups;  // float4 columns per pass: 32 KB of shared memory
static_assert(kSumCols >= kSumLanes && kSumThreads <= 1024, "a pass covers a group's lanes");

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <bool MB>
__global__ void __launch_bounds__(kSumThreads, kSumBlocksPerSm)
sum_partials_kernel(const float4* __restrict__ part, float4* __restrict__ out, int n_rows,
                    int n_cols, int members) {
  // MB: (n_rows, n_cols) blocks one after another, `members` of them from
  // member blockIdx.y * members on, their columns one flat range of members
  // * n_cols (member m's column c at m n_cols + c, its output at the same
  // index of out), split over the grid as one member's columns are
  if constexpr (MB) {
    part += blockIdx.y * (long long)members * n_rows * n_cols;
    out += blockIdx.y * (long long)members * n_cols;
  }
  __shared__ float4 red[kSumGroups][kSumCols];
  const long long n_flat = MB ? (long long)members * n_cols : n_cols;
  const int groups = n_rows < kSumGroups ? n_rows : kSumGroups;
  const int g = threadIdx.x / kSumLanes, lane = threadIdx.x % kSumLanes;
  const int r0 = g * n_rows / groups, r1 = (g + 1) * n_rows / groups;
  const long long c0 = blockIdx.x * n_flat / gridDim.x;
  const long long c1 = (blockIdx.x + 1) * n_flat / gridDim.x;
  for (long long base = c0; base < c1; base += kSumCols) {
    const int width = c1 - base < kSumCols ? (int)(c1 - base) : kSumCols;
    if (g < groups) {
      for (int j = lane; j < width; j += kSumLanes) {
        const long long f = base + j;
        const long long m = MB ? f / n_cols : 0;
        const float4* p = part + m * n_rows * n_cols + (f - m * n_cols);
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = r0; r < r1; r += kSumUnroll) {
          float4 v[kSumUnroll];
#pragma unroll
          for (int u = 0; u < kSumUnroll; ++u)
            if (r + u < r1) v[u] = __ldcs(p + (size_t)(r + u) * n_cols);
#pragma unroll
          for (int u = 0; u < kSumUnroll; ++u)
            if (r + u < r1) s = add4(s, v[u]);
        }
        red[g][j] = s;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < width; j += kSumThreads) {
      float4 s = red[0][j];
      for (int q = 1; q < groups; ++q) s = add4(s, red[q][j]);
      out[base + j] = s;
    }
    __syncthreads();
  }
}

Chain make_chain(const float* w0, const float* wm, const float* wmt, const float* wl,
                 const float* bs, const float* bl, int n, int in_size, int out_size, int depth,
                 float omega0, float omega_h) {
  Chain c;
  c.w0 = w0; c.wm = wm; c.wmt = wmt; c.wl = wl; c.bs = bs; c.bl = bl;
  c.n = n; c.in_size = in_size; c.out_size = out_size; c.depth = depth;
  c.omega0 = omega0; c.omega_h = omega_h;
  return c;
}

// f(bf16, mixed) with the launchers' `bf16` argument as two compile-time
// flags: bit 0 the bf16 mode, bit 1 mixed precision (MX).
template <typename F>
cudaError_t by_mode(int mode, F f) {
  using T = std::true_type;
  using N = std::false_type;
  switch (mode & 3) {
    case 0: return f(N{}, N{});
    case 1: return f(T{}, N{});
    case 2: return f(N{}, T{});
    default: return f(T{}, T{});
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Raise the kernel's shared-memory limit, launch it, and return the launch's
// error.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem, cudaStream_t s,
                   A... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

// The width-192 kernels' launchers, one part of the build each (C linkage:
// the Chain type is local to each part).
#define SINE_MLP_FWD_WIDE_ARGS                                                                \
  const float *x, const float *w0, const float *wm, const void *wp, const float *wl,          \
      const float *bs, const float *bl, float *out, int n, int in_size, int out_size,          \
      int depth, float omega0, float omega_h, int bf16, int sms, int members,                  \
      long long x_stride, void *stream
#define SINE_MLP_BWD_WIDE_ARGS                                                                \
  const float *x, const float *g, const float *w0, const float *wm, const float *wmt,          \
      const float *wl, const float *bs, float *dx, float *z, float *partials, int grid,         \
      int n_part, int n, int in_size, int out_size, int depth, float omega0, float omega_h,    \
      int bf16, int members, long long x_stride, void *stream

extern "C" {

#if defined(SINE_MLP_LAYER)

// The layer-wise kernels' launchers (widths above LW_MIN), one part of the
// build each: SINE_MLP_LAYER = 0 the forward, 1 the backward, 2 dW. Each
// launches one kernel for `args` (its note) over args->members members (grid
// y) and returns the launch's error; misaligned or misshaped arguments
// return cudaErrorInvalidValue without launching.

#if SINE_MLP_LAYER == 0
// kind: kLwFirst (src x, w W_0, b b_0, dst a_0), kLwHidden (src a_{l-1}, w
// W_l's planes, b b_l, dst a_l), each with z the stash or null; kLwLast (src
// a_L, w W_{D-1}, b b_{D-1}, dst out).
int sine_mlp_layer_fwd(const LayerArgs* a, int kind, int bf16, void* stream) {
  if (!layer_args_ok(a) || a->n == 0) return a != nullptr && a->n == 0 ? 0 : (int)cudaErrorInvalidValue;
  // 16-byte copies of the hidden product's operands and loads of the last
  // layer's rows, 16-byte loads of W_0 and b_0 and stores of the tile kinds'
  // rows; x, out and the last layer's W and b are read and written a value
  // at a time
  const bool tiles = kind == kLwFirst || kind == kLwHidden;
  if (kind != kLwHidden && kind != kLwFirst && kind != kLwLast) return (int)cudaErrorInvalidValue;
  if ((kind != kLwFirst && !aligned16(a->src)) || (kind == kLwLast && a->dst == nullptr) ||
      (tiles && (!aligned16(a->w) || !aligned16(a->b) || (a->dst && !aligned16(a->dst)) ||
                 (a->z && !aligned16(a->z)))))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (kind == kLwLast)
    if (const int err = sm_count(&sms)) return err;
  CUtensorMap tm{};  // kLwHidden's activations (the other kinds read none)
  if (kind == kLwHidden) {
    const cudaError_t err = row_tensor_map(&tm, a->src, a->n, a->hidden, a->members, a->src_m, LW_T);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)by_mode(bf16, [&](auto bf, auto mx) {
    constexpr bool BF = decltype(bf)::value, MXV = decltype(mx)::value;
    if (kind == kLwFirst)
      return launch(sine_mlp_layer_fwd_kernel<BF, MXV, kLwFirst>, tile_grid(a), LS_THREADS,
                    kLxSmem, s, *a, tm);
    if (kind == kLwHidden)
      return launch(sine_mlp_layer_fwd_kernel<BF, MXV, kLwHidden>, tile_grid(a), LF_THREADS,
                    kLfSmem, s, *a, tm);
    return launch(sine_mlp_layer_fwd_kernel<BF, MXV, kLwLast>, narrow_grid(a, sms), LN_THREADS,
                  kLnSmem, s, *a, tm);
  });
}
#elif SINE_MLP_LAYER == 1
// kind: kLwLast (src g, w W_{D-1}, z z_L, dst G_L), kLwHidden (g G_l, w
// W_l^T's planes (ops/sine_mlp.layer_weight_planes of W_l^T), z z_{l-1},
// dst G_{l-1}), each with part and x where the layer below is the first;
// kLwFirst (g G_0, w W_0, dst dx).
int sine_mlp_layer_bwd(const LayerArgs* a, int kind, int bf16, void* stream) {
  if (!layer_args_ok(a) || a->n == 0) return a != nullptr && a->n == 0 ? 0 : (int)cudaErrorInvalidValue;
  // tensor copies of G and z and bulk copies of W^T's planes, 8-byte stores
  // of the epilogue's rows (z, G), 16-byte loads of G_0's rows; g, x, dx,
  // the last and first layers' W and the partials are read and written a
  // value at a time
  if (kind != kLwHidden && kind != kLwFirst && kind != kLwLast) return (int)cudaErrorInvalidValue;
  if ((kind == kLwHidden && (!aligned16(a->g) || !aligned16(a->w))) ||
      (kind != kLwFirst && (!aligned16(a->z) || !aligned16(a->dst) || a->part == nullptr ||
                            (kind == kLwLast && a->src == nullptr))) ||
      (kind == kLwFirst && (!aligned16(a->g) || a->dst == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_g{}, tm_z{};  // kLwHidden's G, and z (kLwFirst reads neither)
  if (kind != kLwFirst) {
    cudaError_t err = row_tensor_map(&tm_z, a->z, a->n, a->hidden, a->members, a->z_m, LW_T);
    if (err == cudaSuccess && kind == kLwHidden)
      err = row_tensor_map(&tm_g, a->g, a->n, a->hidden, a->members, a->g_m, LW_T);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0;
  if (kind == kLwFirst)
    if (const int err = sm_count(&sms)) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool first = a->x != nullptr;
  return (int)by_mode(bf16, [&](auto bf, auto mx) {
    constexpr bool BF = decltype(bf)::value, MXV = decltype(mx)::value;
    if (kind == kLwFirst)
      return launch(sine_mlp_layer_bwd_kernel<BF, MXV, kLwFirst, false>, narrow_grid(a, sms),
                    LN_THREADS, kLnSmem, s, *a, tm_g, tm_z);
    if (kind == kLwLast)
      return first ? launch(sine_mlp_layer_bwd_kernel<BF, MXV, kLwLast, true>, tile_grid(a),
                            LS_THREADS, kLsSmem, s, *a, tm_g, tm_z)
                   : launch(sine_mlp_layer_bwd_kernel<BF, MXV, kLwLast, false>, tile_grid(a),
                            LS_THREADS, kLsSmem, s, *a, tm_g, tm_z);
    return first ? launch(sine_mlp_layer_bwd_kernel<BF, MXV, kLwHidden, true>, tile_grid(a),
                          LF_THREADS, kLbSmem, s, *a, tm_g, tm_z)
                 : launch(sine_mlp_layer_bwd_kernel<BF, MXV, kLwHidden, false>, tile_grid(a),
                          LF_THREADS, kLbSmem, s, *a, tm_g, tm_z);
  });
}
#else
// src A_l, g G_l (n, H) each, part (S = slices, n_part) floats: row s of it
// at off_dw gets split s's dW_l.
int sine_mlp_layer_dw(const LayerArgs* a, int bf16, void* stream) {
  if (!layer_args_ok(a) || a->n == 0) return a != nullptr && a->n == 0 ? 0 : (int)cudaErrorInvalidValue;
  if (!aligned16(a->src) || !aligned16(a->g) || !aligned16(a->part) || a->n_part % 4 != 0 ||
      a->off_dw < 0 || a->off_dw % 2 != 0 ||
      a->off_dw + (long long)a->hidden * a->hidden > a->n_part)
    return (int)cudaErrorInvalidValue;
  const int cols = a->hidden / LW_N;
  const dim3 grid(a->slices * cols * cols, a->members);
  CUtensorMap tm_a, tm_g;  // A's and G's rows, in boxes of LD_KC rows
  cudaError_t err = row_tensor_map(&tm_a, a->src, a->n, a->hidden, a->members, a->src_m, LD_KC);
  if (err == cudaSuccess)
    err = row_tensor_map(&tm_g, a->g, a->n, a->hidden, a->members, a->g_m, LD_KC);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)by_mode(bf16, [&](auto bf, auto mx) {
    constexpr bool BF = decltype(bf)::value, MXV = decltype(mx)::value;
    return launch(sine_mlp_layer_dw_kernel<BF, MXV>, grid, LD_THREADS, kLdSmem, s, *a, tm_a,
                  tm_g);
  });
}
#endif

#elif defined(SINE_MLP_WIDE)

// SINE_MLP_WIDE is the width of SINE_MLP_WIDE_GEOS, 192; SINE_MLP_PART 0
// the forward, 1 the backward
static_assert(SINE_MLP_WIDE == 192, "the fused kernels above 128 are the width-192 ones");
using GW = WideGeo<SINE_MLP_WIDE>;

#if SINE_MLP_PART == 1
// The width-192 backward (wgmma): wmt holds W's planes; dW_m goes into the
// partials.
int sine_mlp_bwd_w192(SINE_MLP_BWD_WIDE_ARGS) {
  static_assert(GW::bwd::T == B2_T, "KERNEL_TILE_ROWS[192]");
  if (reinterpret_cast<uintptr_t>(wmt) % 16 != 0 || reinterpret_cast<uintptr_t>(z) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Chain c = make_chain(w0, wm, wmt, wl, bs, nullptr, n, in_size, out_size, depth, omega0,
                             omega_h);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 blocks(grid, members);
  return (int)by_mode(bf16, [&](auto bf, auto mx) {
    constexpr bool BF = decltype(bf)::value, MXV = decltype(mx)::value;
    if (members > 1) {
      return launch(sine_mlp_bwd_wg192_kernel<BF, MXV, true>, blocks, BW_THREADS, kB2Smem, s, c, x,
                    g, dx, z, partials, n_part, x_stride);
    }
    return launch(sine_mlp_bwd_wg192_kernel<BF, MXV, false>, blocks, BW_THREADS, kB2Smem, s, c, x,
                  g, dx, z, partials, n_part, x_stride);
  });
}
#else
// The width-192 forward (wgmma): wp holds W's planes
// (ops/sine_mlp.weight_planes at width 192, both images; this reads the
// forward one), 16-byte aligned: a null or misaligned wp is refused. One
// persistent block per SM, at most one per 128-row tile, for each of
// `members` members (grid y; the batched instantiation above 1).
int sine_mlp_fwd_w192(SINE_MLP_FWD_WIDE_ARGS) {
  if (wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Chain c = make_chain(w0, wm, reinterpret_cast<const float*>(wp), wl, bs, bl, n, in_size,
                             out_size, depth, omega0, omega_h);
  const int tiles = (n + F2_T - 1) / F2_T;
  const dim3 grid(tiles < sms ? tiles : sms, members);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)by_mode(bf16, [&](auto bf, auto mx) {
    constexpr bool BF = decltype(bf)::value, MXV = decltype(mx)::value;
    constexpr size_t smem = F2Smem<BwPlanes<BF, MXV>::W>::BYTES;
    if (members > 1) {
      return launch(sine_mlp_fwd_wg192_kernel<BF, MXV, true>, grid, BW_THREADS, smem, s, c, x,
                    out, x_stride);
    }
    return launch(sine_mlp_fwd_wg192_kernel<BF, MXV, false>, grid, BW_THREADS, smem, s, c, x, out,
                  x_stride);
  });
}
#endif

#else  // the width-128 kernels, sum_partials and the C interface

#define SINE_MLP_DECLARE(W, TR, KS, NB) \
  int sine_mlp_fwd_w##W(SINE_MLP_FWD_WIDE_ARGS);   \
  int sine_mlp_bwd_w##W(SINE_MLP_BWD_WIDE_ARGS);
SINE_MLP_WIDE_GEOS(SINE_MLP_DECLARE)
#undef SINE_MLP_DECLARE

// The kernel width a model of hidden width h runs on (h zero-padded up to
// it): 128 or a width of SINE_MLP_WIDE_GEOS, above the widest (LW_MIN) h
// rounded up to a multiple of LW_N (the layer-wise kernels); 0 below 1.
int sine_mlp_kernel_width(int h) {
#define SINE_MLP_WIDTH(W, TR, KS, NB) W,
  constexpr int widths[] = {H, SINE_MLP_WIDE_GEOS(SINE_MLP_WIDTH)};
#undef SINE_MLP_WIDTH
  static_assert(widths[sizeof(widths) / sizeof(int) - 1] == LW_MIN, "the layer kernels' threshold");
  for (int k : widths)
    if (h <= k) return h >= 1 ? k : 0;
  return h <= INT_MAX - LW_N ? (h + LW_N - 1) / LW_N * LW_N : 0;  // the layer-wise kernels
}
// Pixel rows per tile of the backward kernel of width `hidden` (0 if there
// is none): the partial buffer has at most one slice per tile.
int sine_mlp_tile_rows(int hidden) {
  if (hidden > LW_MIN) return hidden % LW_N == 0 ? LW_T : 0;
  switch (hidden) {
    case H: return T;
#define SINE_MLP_ROWS(W, TR, KS, NB) \
  case W: return TR;
    SINE_MLP_WIDE_GEOS(SINE_MLP_ROWS)
#undef SINE_MLP_ROWS
    default: return 0;
  }
}
int sine_mlp_max_io() { return MAX_IO; }

// The forward of `members` models of one shape (grid y; see the top), x at
// x_stride floats per member (0: shared); one member launches the single
// instantiation (sine_mlp_fwd). One persistent block per SM (at
// most one per tile) for each member. hidden: the kernel width the weights
// are padded to. wp: W's planes (ops/sine_mlp.weight_planes), 16-byte
// aligned, read at widths 128 and 192 (the wgmma forwards), which refuse a
// null or misaligned one. At most kMaxRows rows and 65,535 members.
int sine_mlp_fwd_batched(const float* x, const float* w0, const float* wm, const void* wp,
                         const float* wl, const float* bs, const float* bl, float* out,
                         int members, long long x_stride, int n, int in_size, int out_size,
                         int depth, int hidden, float omega0, float omega_h, int bf16,
                         void* stream) {
  if (n <= 0 || members <= 0) return 0;
  const int rows = sine_mlp_tile_rows(hidden);
  if (rows == 0 || n > kMaxRows || members > 65535 || x_stride < 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  switch (hidden) {
#define SINE_MLP_FWD_CASE(W, TR, KS, NB)                                                   \
  case W:                                                                                  \
    return sine_mlp_fwd_w##W(x, w0, wm, wp, wl, bs, bl, out, n, in_size, out_size, depth,    \
                             omega0, omega_h, bf16, sms, members, x_stride, stream);
    SINE_MLP_WIDE_GEOS(SINE_MLP_FWD_CASE)
#undef SINE_MLP_FWD_CASE
  }
  if (wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + rows - 1) / rows;
  const dim3 grid(tiles < sms ? tiles : sms, members);
  const Chain c = make_chain(w0, wm, reinterpret_cast<const float*>(wp), wl, bs, bl, n, in_size,
                             out_size, depth, omega0, omega_h);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)by_mode(bf16, [&](auto bf, auto mx) {
    constexpr bool BF = decltype(bf)::value, MXV = decltype(mx)::value;
    if (members > 1) {
      return launch(sine_mlp_fwd_kernel<BF, MXV, true>, grid, BW_THREADS, kFwdSmem, s, c, x, out,
                    x_stride);
    }
    return launch(sine_mlp_fwd_kernel<BF, MXV, false>, grid, BW_THREADS, kFwdSmem, s, c, x, out,
                  x_stride);
  });
}

int sine_mlp_max_rows() { return kMaxRows; }

// The backward of `members` models of one shape (grid y; the batched
// instantiation above 1 member, as the forward), x at x_stride floats per
// member (0: shared). Per member: g (n, out) and dx (n, in) floats, one
// after another; partials (grid, n_part) floats, n_part a multiple of 4
// (16-byte aligned slices); z_scratch (grid, max(depth-3, 1), T, hidden)
// floats, T = sine_mlp_tile_rows(hidden). wmt: W's planes
// (ops/sine_mlp.weight_planes, both images), 16-byte aligned. At most 65,535
// members.
int sine_mlp_bwd_batched(const float* x, const float* g, const float* w0, const float* wm,
                         const float* wmt, const float* wl, const float* bs, float* dx,
                         float* z_scratch, float* partials, int members, long long x_stride,
                         int grid, int n_part, int n, int in_size, int out_size, int depth,
                         int hidden, float omega0, float omega_h, int bf16, void* stream) {
  if (n <= 0 || grid <= 0 || members <= 0) return 0;
  if (n_part % 4 != 0 || members > 65535 || x_stride < 0 || wmt == nullptr)
    return (int)cudaErrorInvalidValue;
  if (hidden != H) {
    switch (hidden) {
#define SINE_MLP_BWD_CASE(W, TR, KS, NB)                                                      \
  case W:                                                                                     \
    return sine_mlp_bwd_w##W(x, g, w0, wm, wmt, wl, bs, dx, z_scratch, partials, grid, n_part, \
                             n, in_size, out_size, depth, omega0, omega_h, bf16, members,      \
                             x_stride, stream);
      SINE_MLP_WIDE_GEOS(SINE_MLP_BWD_CASE)
#undef SINE_MLP_BWD_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (reinterpret_cast<uintptr_t>(wmt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(z_scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Chain c = make_chain(w0, wm, wmt, wl, bs, nullptr, n, in_size, out_size, depth,
                             omega0, omega_h);
  static_assert(kBwdSmem <= kMaxSmem, "the backward's shared memory");
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 blocks(grid, members);
  return (int)by_mode(bf16, [&](auto bf, auto mx) {
    constexpr bool BF = decltype(bf)::value, MXV = decltype(mx)::value;
    if (members > 1) {
      return launch(sine_mlp_bwd_kernel<BF, MXV, true>, blocks, BW_THREADS, kBwdSmem, s, c, x,
                    g, dx, z_scratch, partials, n_part, x_stride);
    }
    return launch(sine_mlp_bwd_kernel<BF, MXV, false>, blocks, BW_THREADS, kBwdSmem, s, c, x,
                  g, dx, z_scratch, partials, n_part, x_stride);
  });
}

// The row split's group count; ops/sine_mlp.py mirrors it.
int sum_partials_groups() { return kSumGroups; }

// out = the column sum of partials (n_blocks, n_part), n_part % 4 == 0 and
// both pointers 16-byte aligned.
int sum_partials(const float* partials, float* out, int n_blocks, int n_part, void* stream) {
  if (n_part <= 0 || n_blocks <= 0) return 0;
  if (n_part % 4 != 0 || reinterpret_cast<uintptr_t>(partials) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  const int n_cols = n_part / 4;
  const int grid = n_cols < sms * kSumBlocksPerSm ? n_cols : sms * kSumBlocksPerSm;
  sum_partials_kernel<false><<<grid, kSumThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partials), reinterpret_cast<float4*>(out), n_blocks,
      n_cols, 1);
  return (int)cudaGetLastError();
}

// The column sums of `members` (n_blocks, n_part) buffers one after another
// into `members` rows of out (n_part floats each) in one launch (a grid per
// member, or the members' columns one flat range: the kernel's note), each
// column summed in sum_partials' order: each member's bits.
int sum_partials_batched(const float* partials, float* out, int members, int n_blocks,
                         int n_part, void* stream) {
  if (members == 1) return sum_partials(partials, out, n_blocks, n_part, stream);
  if (n_part <= 0 || n_blocks <= 0 || members <= 0) return 0;
  if (n_part % 4 != 0 || members > 65535 || reinterpret_cast<uintptr_t>(partials) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  const int n_cols = n_part / 4, blocks = sms * kSumBlocksPerSm;
  // one grid per member while a member's share of a block fits its lanes,
  // else one flat range of the members' columns (the kernel's note)
  const int flat = (long long)n_cols > (long long)blocks * kSumLanes ? members : 1;
  const long long n_flat = (long long)flat * n_cols;
  const dim3 grid(n_flat < blocks ? (int)n_flat : blocks, members / flat);
  sum_partials_kernel<true><<<grid, kSumThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partials), reinterpret_cast<float4*>(out), n_blocks,
      n_cols, flat);
  return (int)cudaGetLastError();
}

#endif  // SINE_MLP_LAYER, SINE_MLP_WIDE

}  // extern "C"
