// The tile-level device code of the per-point pipeline: the forward of one
// tile of ROWS points (forward_tile: 128 in the forward kernels, 64 in the
// backward's recompute, which keeps every layer input when SAVE) and the
// pullback of its five outputs over a 64-point tile (backward_tile), the
// products on wgmma they share, the shared-memory tile and scratch
// layouts they use, and the host helpers of the kernels built on them.
// point_pipeline.cu (kernel rows 5 and 6) and ray_march.cu (rows 3 and 4)
// include it; the design and the bound are in point_pipeline.cu's note.
// Both tile functions read and write only the tile: the caller fills its
// points, view dirs (P3, D3) and, for the backward, the cotangents (CT) of
// the five outputs, and reads the outputs (S1, G3, GC, RL, DL) or the point
// and dir cotangents (PH, DH) back.
//
// The arithmetic is the TPU kernels' production arithmetic (JAX bf16 = not
// interpret) under the MARCH_BWD_PRECISION mode PREC, a template parameter
// of every tile function, so that each mode is its own instantiation (a
// library of its own: PP_PREC below):
//   f32stash (the default) every product rounds its two operands to bf16
//     and sums in f32 (the 256-wide ones on wgmma: wg_product with B
//     streamed from the weight images through a ring of bulk-copied slabs,
//     and the backward's dw_flush; the 1- and 3-wide ones as SIMT FMAs,
//     narrow_layer and narrow_back); the activations, gates and stores stay
//     f32; layer 0's weight grad takes its f32 operands (the PE and the
//     tangent seed) as hi + lo bf16 pairs, and the last layer's rank-1
//     tangent term is summed in f32;
//   bf16 as f32stash, but the SDF chain's stores are bf16: the backward's
//     tangent pre-gates (zt), and the save mode's stash of the SDF layer
//     outputs, from whose bf16 values the load entry rebuilds the gates;
//   f32 every product of the SDF chain (its forward, the reverse sweep, the
//     backward's tangent stream, the joint value / tangent reverse, the
//     last layer's) in f32 as JAX's Precision.HIGHEST computes it, six
//     bf16 passes on wgmma (hp_product: each operand split into three bf16
//     parts, B's from three-part weight images the wrapper packs), and its
//     weight grads the same way (their operands stored as three bf16 parts
//     each, the flush summing six passes a term pair); the 1-wide products
//     (the sdf row) as exact f32 FMAs; the colour and relight chains as
//     f32stash.
// The backward's weight grads are summed on chip over a batch of tiles
// (dw_flush); point_pipeline.cu's note gives the design.
#pragma once

#include <cuda_runtime.h>

#include "mlp_common.cuh"

namespace {

using mlp::EMB;
using mlp::HID;
using mlp::INV_SQRT2;
using mlp::THREADS;
using mlp::TILE;
using mlp::emb_value;
using mlp::load_a3;
using mlp::pack_bf16;
using mlp::round_bf16;
using mlp::softplus100;
using mlp::unbias_truncated;

constexpr float SQRT2 = 1.41421356f;
constexpr int LDX = HID + EMB + 4;       // activation row stride: [h 256 | small 48] + pad
constexpr int LDX_FWD = HID + EMB + 8;   // the forward kernels' (load_a's reads then hit
                                         // 32 banks a half-warp)
template <int ROWS>
constexpr int LD = ROWS == TILE ? LDX : LDX_FWD;   // the stride of a ROWS-point tile's X
constexpr int LDS = HID + EMB;           // row stride of a layer input stored in the scratch
constexpr int MAXL = 16;                 // max layers per network
// slots of the offset tables: `off` holds element offsets into the packed
// f32 weights (the gradient buffers use the same table; its WT slots are
// unused), `ioff` the first slab of each 256-wide layer's weight image in
// wimg (its W slot: the forward product's, rows the 256 outputs; its WT
// slot: the reverse product's, rows the K inputs)
constexpr int W_SDF = 0, WT_SDF = MAXL, B_SDF = 2 * MAXL, W_COL = 3 * MAXL, B_COL = 4 * MAXL,
              W_REL = 5 * MAXL, B_REL = 6 * MAXL, WT_COL = 7 * MAXL, WT_REL = 8 * MAXL,
              W_LAST = 9 * MAXL, B_LAST = W_LAST + 1, W_FEAT = W_LAST + 2, B_FEAT = W_LAST + 3,
              WT_FEAT = W_LAST + 4, N_OFF = W_LAST + 5;
constexpr int FWD_ROWS = 2 * TILE;       // points per tile of the forward kernels (rows 3, 5)

// MARCH_BWD_PRECISION, the SDF chain's arithmetic (the note above). A
// library's kernels compute one mode, PP_PREC (nvcc -DPP_PREC=...); the
// kernels of the non-default modes carry its suffix.
enum Prec { PREC_F32STASH = 0, PREC_BF16 = 1, PREC_F32 = 2 };
#ifndef PP_PREC
#define PP_PREC 0
#endif
#if PP_PREC == 1
#define PP_NAME(name) name##_bf16s
#elif PP_PREC == 2
#define PP_NAME(name) name##_f32s
#else
#define PP_NAME(name) name
#endif

// RM_ABLATE: a cost probe of the march backward's load entry (row 4 in the
// save mode), for color_neus_torch/tools/march_ablate.py only: nvcc
// -DRM_ABLATE=k builds ray_march.cu with one part of the work skipped
// (ops/kernels/build.py ABLATIONS), whose outputs are garbage and only
// timed: 1 no_pullback, backward_tile (the reverse sweeps' products and
// the weight-grad operands) and the weight-grad flush; 2 no_unflatten,
// the stash not read: load_tile skipped (the tile and its scratch keep
// what they held) and backward_tile's reads of it constants (TileStash);
// 3 pullback_only, the per-ray compositing of both entries (the backward
// takes the cotangent scratch as it finds it); 4 no_wgrad, the weight-grad
// operand stores (save_t) and the flush. Absent, it is 0:
// every test of it is then a constant that keeps the production code.
#ifndef RM_ABLATE
#define RM_ABLATE 0
#endif

struct Params {
  const float* pts;    // [n, 3]
  const float* dirs;   // [n, 3]
  const float* w;      // packed f32 weights, see off
  const unsigned char* wimg;   // the 256-wide layers' weights as wgmma B slabs, see ioff
  float* out;          // forward: [n, 16]
  float* scratch;      // per block: see the kernels
  long long n_pts;
  int n_sdf;           // SDF linear layers (the last one included)
  int skip;            // index of the SDF skip layer, -1 for none
  int d0;              // SDF PE width (3 + 6 multires)
  float scale;
  int n_color;         // colour linear layers
  int color_dv;        // view-dir PE width of the colour input (0: no_view_dir)
  int squeeze;
  int n_relight;       // relight linear layers (in_layer + mlps), 0 for NeuS
  int rl_dv;           // view-dir PE width of the relight input
  int y_in;            // relight layer that takes [h, gc]
  int inv_sigmoid;
  long long off[N_OFF];
  long long ioff[N_OFF];       // first WSLAB-byte slab of each layer's image in wimg
  // backward only
  const float* gbar;   // [n, 16] cotangents in the forward's output lanes
  float* pts_hat;      // [n, 3]
  float* dirs_hat;     // [n, 3]
  float* partial;      // [gridDim.x][n_grad] weight-grad partials, zeroed
  long long n_grad;
  int dw_batch;                // tiles whose weight grads a block sums on chip per flush
};

// The wgmma operands: a weight slab is 64 rows (output columns of the
// product) x 64 k of bf16, K-major with the 128-byte swizzle
// (mlp::sw128_offset), 8 KB; the weight ring holds four (in the forward
// kernels three stages of two consecutive slabs of a chunk, 16 KB: half the
// waits a product makes). A stage of the
// backward's weight-grad flush holds two 64-row blocks of one tile's A^T
// (64 rows x 64 points, 8 KB each) and its output cotangent (256 rows x 64
// points, 32 KB); three stages, laid over the X / Y buffers, which the
// flush does not use.
constexpr int WSLAB = 8192, WSTAGES = 4;
constexpr int FWD_STAGES = 3, FWD_SPS = 2;   // the forward kernels' ring: 3 stages of 2 slabs
constexpr int DW_A = 8192, DW_B = 32768, DW_STAGE = 2 * DW_A + DW_B, DW_STAGES = 3;
constexpr int CR_SLOT = HID * 128;   // the save stash's image of a cr slot of a tile (act_layout)
constexpr int SMEM_ALIGN = 1024;     // the swizzle atom: descriptors need it
// the forward kernels: the weight ring, X of 128 points (its PE columns
// also hold the PE cotangents: forward_tile), the small buffers, the
// ring's mbarriers
constexpr size_t SMEM_FWD = SMEM_ALIGN + size_t(FWD_STAGES) * FWD_SPS * WSLAB +
                            (size_t(FWD_ROWS) * LDX_FWD + FWD_ROWS * (6 * 3 + 1)) * 4 +
                            2 * FWD_STAGES * sizeof(unsigned long long);
constexpr size_t SMEM_BWD = SMEM_ALIGN + size_t(WSTAGES) * WSLAB +
                            (2 * size_t(TILE) * LDX + 2 * size_t(TILE) * EMB + TILE * 16 +
                             11 * TILE * 3 + TILE) * 4 +
                            2 * (WSTAGES + DW_STAGES) * sizeof(unsigned long long);
static_assert(size_t(DW_STAGES) * DW_STAGE <= 2 * size_t(TILE) * LDX * 4, "flush stages over X, Y");
static_assert(SMEM_FWD <= 232448 && SMEM_BWD <= 232448, "shared memory of one block");

// A tile's buffers in shared memory, rows R (FWD_ROWS in the forward
// kernels, TILE in the backward).
struct Tile {
  float* X;    // [R][LDX] activations (value stream)
  float* P3;   // [R][3] points
  float* D3;   // [R][3] view dirs
  float* G3;   // [R][3] grad
  float* GC;   // [R][3] global colour
  float* DL;   // [R][3] delta
  float* RL;   // [R][3] relit
  float* S1;   // [R] sdf
  // backward only
  float* EG;   // [TILE][EMB] emb_hat
  float* Y;    // [TILE][LDX] the tangent stream and its cotangents
  float* VH;   // [TILE][EMB] v0_hat (also stages view-dir PE cotangents)
  float* CT;   // [TILE][16] the cotangents gbar
  float* PH;   // [TILE][3] pts_hat
  float* DH;   // [TILE][3] dirs_hat
  float* GH;   // [TILE][3] the total grad cotangent
  float* CG;   // [TILE][3] the total gc cotangent
  float* HB;   // [TILE][3] the cotangent of a 3-wide layer output
};

// Where the backward's recompute keeps the layer inputs: the colour and
// relight ones in f32 ([TILE][LDS] slabs of the block's scratch, for their
// relu masks and the 3-wide last layers), and every 256-wide layer's as a
// bf16 weight-grad operand in the tile's store (dw_a).
struct Save {
  float* cx;           // [n_color] colour layer inputs
  float* rx;           // [n_relight] relight layer inputs
  unsigned char* dw;   // the tile's weight-grad store (dw_tile_bytes), nullptr for none;
                       // PREC_F32: it starts with hp_product's stage (hp_stage_of)
};

// The fused march's save mode (ray_march.cu): the rows of a forward tile in
// the activation stash ([R S] rows of `bytes` each, laid out by
// act_layout), which forward_tile<ROWS, false, true> fills as it goes.
struct Export {
  unsigned char* row0;   // the row of the tile's first point
  int rows;              // the tile's points that have a row (the rest pad)
  int bytes;             // bytes a row
  unsigned char* cr = nullptr;   // the colour / relight images of the tile's first
                                 // 64-point backward tile (act_layout); the second's next
};

constexpr size_t SLAB = size_t(TILE) * LDS;
constexpr size_t GSLAB = size_t(TILE) * HID;
constexpr int LDH = HID + 64;            // row stride of hp_product's stage: 5 whole chunks
constexpr size_t HS_FLOATS = 2 * size_t(TILE) * LDH;   // the stage: two streams of [TILE][LDH]

// PREC_F32: hp_product's stage, the first HS_FLOATS floats of the tile's
// weight-grad store (dw_block places the operands after it; the forward
// kernels, which store none, point Save::dw at a stage of their own).
__device__ __forceinline__ float* hp_stage_of(const Save& sv) {
  return reinterpret_cast<float*>(sv.dw);
}

enum Epi { EPI_NONE = 0, EPI_RELU = 1, EPI_SOFTPLUS = 2 };

// ------------------------------------------------------------------------
// The tile's products on wgmma, B streamed through a ring of weight slabs
// ------------------------------------------------------------------------

// The A fragment of rows m0 .. m0 + 16, columns k0 .. k0 + 16 of an f32
// tile in shared memory (row stride lda), rounded to bf16 as it loads:
// a0 / a2 rows g, a1 / a3 rows g + 8; a0 / a1 columns 2t, 2t + 1, a2 / a3
// eight further.
__device__ __forceinline__ void load_a(const float* A, int lda, int m0, int k0, unsigned (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* r0 = A + (m0 + g) * lda + k0 + 2 * t;
  const float* r8 = r0 + 8 * lda;
  const float2 x0 = *reinterpret_cast<const float2*>(r0);
  const float2 x1 = *reinterpret_cast<const float2*>(r8);
  const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(r8 + 8);
  a[0] = pack_bf16(x0.x, x0.y);
  a[1] = pack_bf16(x1.x, x1.y);
  a[2] = pack_bf16(x2.x, x2.y);
  a[3] = pack_bf16(x3.x, x3.y);
}

// ---- the rings of bulk copies: the weight slabs, and the backward's flush ----
// A ring of stages in shared memory, each filled by the TMA unit's bulk
// copies completing on its "full" mbarrier and released by every warp on
// its "empty" one; slab s of a block's sequence goes to stage s % STAGES,
// and its k-th use of a stage waits with parity k & 1. The block counts
// its slabs (Rings::ws, ds) across tiles, so the parities carry on.
struct Ring {
  unsigned char* buf;
  unsigned long long* full;
  unsigned long long* empty;
};

struct Rings {
  Ring w;        // the weight slabs of the tile's products (WSTAGES x WSLAB; in the
                 // forward kernels FWD_STAGES x FWD_SPS x WSLAB)
  Ring d;        // backward only: the weight-grad flush's operands (DW_STAGES x DW_STAGE,
                 // over X and Y)
  unsigned ws;   // weight slabs consumed so far
  unsigned ds;   // flush stages consumed so far
};

// Thread 0: until every warp has released what slab s's stage held before.
template <int STAGES>
__device__ __forceinline__ void ring_wait_empty(const Ring& r, unsigned s) {
  if (s >= STAGES) mlp::mbar_wait(r.empty + s % STAGES, (s / STAGES - 1) & 1u);
}

// Every thread: until slab s has landed.
template <int STAGES>
__device__ __forceinline__ const unsigned char* ring_acquire(const Ring& r, unsigned s,
                                                             int stage_bytes) {
  mlp::mbar_wait(r.full + s % STAGES, (s / STAGES) & 1u);
  __syncwarp();
  return r.buf + (s % STAGES) * stage_bytes;
}

// Every thread, after its warp's last read of slab s (its wgmma done).
template <int STAGES>
__device__ __forceinline__ void ring_release(const Ring& r, unsigned s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mlp::mbar_arrive(r.empty + s % STAGES);
}

// ---- the tile's products on wgmma ----
// out = bf16(A[:, :16 KS]) @ B, B [16 KS][NOUT] streamed through the weight
// ring from its slab image img (point_pipeline.py's _pack_images: chunks of
// 64 output columns, the last one 48 when NOUT % 64 == 48, each as
// ceil(KS / 4) slabs of 64 k, K-major), thread 0 keeping STAGES - 1 slabs
// in flight. A comes from registers: every thread loads its fragments of
// the f32 activations (rounded to bf16, as load_a) before a barrier, so put
// may overwrite A, and no staging copy of A is made. Single (DUAL false):
// both warpgroups read A0, warpgroup h computing columns 32 h .. 32 h + 32
// of each 64-column chunk (24 h .. 24 h + 24 of a 48-column one) and
// calling put0; DUAL: warpgroup 0 the product of A0 and warpgroup 1 that of
// A1 with the same B, all columns of each chunk, calling put0 / put1 (the
// SDF reverse sweep's value and tangent streams share every weight slab;
// the forward kernels' 128-point tile is two 64-row halves that do). The
// ring: STAGES stages of SPS slabs; A's row stride LDA. put(r, c, v) for
// every output; a barrier after.

// Stage li of the product (SPS consecutive slabs of a chunk a stage; a
// lone slab copies only its `rows` rows).
template <int KS, int STAGES, int SPS>
__device__ __forceinline__ void issue_slab(Rings& st, const unsigned char* img, unsigned li,
                                           int n_stages, int nfull, int rows_last) {
  if (int(li) >= n_stages) return;
  constexpr int KSL = (KS + 3) / 4, NST = (KSL + SPS - 1) / SPS;
  const unsigned s = st.ws + li;
  const int chunk = int(li) / NST, q = int(li) % NST, nsub = min(SPS, KSL - SPS * q);
  const int rows = chunk < nfull ? 64 : rows_last;
  ring_wait_empty<STAGES>(st.w, s);
  mlp::bulk_load(st.w.buf + (s % STAGES) * (SPS * WSLAB),
                 img + (size_t(chunk) * KSL + SPS * q) * WSLAB,
                 nsub == 1 ? unsigned(rows) * 128u : unsigned(nsub) * WSLAB,
                 st.w.full + s % STAGES);
}

// One chunk's products into the warpgroup's accumulators, then its
// epilogue: put1 for every output where `second` (the warpgroup's), else
// put0. The choice is made once a chunk, so each epilogue is straight-line
// code over the chunk's outputs, whose loads and special-function chains
// the compiler interleaves.
template <int NW, int KS, int STAGES, int SPS, class F0, class F1>
__device__ __forceinline__ void chunk_products(Rings& st, const unsigned (&a)[KS][4],
                                               const unsigned char* img, unsigned li0,
                                               int n_stages, int nfull, int rows_last, int row0,
                                               int col0, bool second, F0&& put0, F1&& put1) {
  constexpr int KSL = (KS + 3) / 4, NST = (KSL + SPS - 1) / SPS;
  const int tid = threadIdx.x, w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    const unsigned li = li0 + i, s = st.ws + li;
    if (tid == 0)
      issue_slab<KS, STAGES, SPS>(st, img, li + STAGES - 1, n_stages, nfull, rows_last);
    const unsigned char* stage = ring_acquire<STAGES>(st.w, s, SPS * WSLAB);
    mlp::wgmma_fence();
#pragma unroll
    for (int u = 0; u < SPS; ++u)
#pragma unroll
      for (int kk = 0; kk < 4 && 4 * (SPS * i + u) + kk < KS; ++kk)
        mlp::wgmma_rs_bf16<NW>(acc, a[4 * (SPS * i + u) + kk],
                               mlp::wgmma_desc(stage + u * WSLAB + row0 * 128 + 32 * kk),
                               (i | u | kk) != 0);
    mlp::wgmma_commit();
    mlp::wgmma_wait_all();
    ring_release<STAGES>(st.w, s);
  }
  auto emit = [&](auto&& put) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          put(16 * w + g + 8 * h, col0 + 8 * j + 2 * q + e, acc[4 * j + 2 * h + e]);
  };
  if (second) emit(put1);
  else emit(put0);
}

template <int KS, int NOUT, bool DUAL, int STAGES = WSTAGES, int SPS = 1, int LDA = LDX,
          class F0, class F1>
__device__ __forceinline__ void wg_product(Rings& st, const float* A0, const float* A1,
                                           const unsigned char* img, F0&& put0, F1&& put1) {
  static_assert(NOUT % 64 == 0 || NOUT % 64 == 48, "wg_product: NOUT");
  constexpr int KSL = (KS + 3) / 4, NST = (KSL + SPS - 1) / SPS, NFULL = NOUT / 64;
  constexpr int TAIL = NOUT % 64, N_ST = (NFULL + (TAIL ? 1 : 0)) * NST;
  const int tid = threadIdx.x, wg = tid >> 7;
  const float* A = DUAL && wg ? A1 : A0;
  unsigned a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(A, LDA, 16 * ((tid >> 5) & 3), 16 * ks, a[ks]);
  if (tid == 0)   // the product's first slabs
    for (int li = 0; li < STAGES - 1; ++li)
      issue_slab<KS, STAGES, SPS>(st, img, li, N_ST, NFULL, TAIL);
  __syncthreads();
  const bool second = DUAL && wg;
  // not unrolled: unrolled chunks cost registers (ray_march_bwd_kernel spilled)
#pragma unroll 1
  for (int j = 0; j < NFULL; ++j) {
    if constexpr (DUAL)
      chunk_products<64, KS, STAGES, SPS>(st, a, img, j * NST, N_ST, NFULL, TAIL, 0, 64 * j,
                                          second, put0, put1);
    else
      chunk_products<32, KS, STAGES, SPS>(st, a, img, j * NST, N_ST, NFULL, TAIL, 32 * wg,
                                          64 * j + 32 * wg, false, put0, put0);
  }
  if constexpr (TAIL != 0) {
    if constexpr (DUAL)
      chunk_products<TAIL, KS, STAGES, SPS>(st, a, img, NFULL * NST, N_ST, NFULL, TAIL, 0,
                                            64 * NFULL, second, put0, put1);
    else
      chunk_products<TAIL / 2, KS, STAGES, SPS>(st, a, img, NFULL * NST, N_ST, NFULL, TAIL,
                                                TAIL / 2 * wg, 64 * NFULL + TAIL / 2 * wg, false,
                                                put0, put0);
  }
  st.ws += N_ST;
  __syncthreads();
}

__device__ __forceinline__ const unsigned char* image(const Params& p, int slot) {
  return p.wimg + size_t(p.ioff[slot]) * WSLAB;
}

// Four consecutive floats.
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// ---- the SDF chain's exact-f32 products on wgmma (PREC_F32) ----
// JAX's Precision.HIGHEST as six bf16 passes: each f32 operand x is split
// into three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
// hi - mid) (hi + mid + lo == x exactly for a normal x), and A B is summed
// as the six products of parts whose ranks add to at most 2 (lo Hi, mid
// Mid, hi Lo, mid Hi, hi Mid, hi Hi, in that order: smallest first; the
// three dropped are below f32's rounding) on wgmma. B's parts are one
// slab a k16 step (point_pipeline.py _pack_images: a slab's 128-byte row
// holds the step's 16 k of hi, mid and lo, then 16 of padding), so each
// step's six passes run from one ring stage into a fresh accumulator,
// whose sum, nudged to undo the truncation's bias (unbias_truncated), is
// added into the chunk's running f32 total (round to nearest). The tensor
// cores truncate where they add (round toward zero: Fasi, Higham, Mikaitis
// and Pranesh, "Numerical behavior of NVIDIA tensor cores", PeerJ Comput.
// Sci. 7:e330, 2021, on V100, T4 and A100; chip_smoke.py phase 12a holds
// the H100's activations and features against float64, since the CPU
// emulator rounds to nearest). A step's six passes are issued smallest
// first and hi Hi last, so one truncation lands at the sum's magnitude and
// the five before it at 2^-8 of it or less: the nudge corrects that one.
// One accumulator over the whole depth,
// truncated at the total's magnitude at every step, biased the activations
// on the H100 by ~2 f32 ulps a layer, and the features, the colour net's
// input, then rounded to another bf16 value than float64's 4.9x as often
// as the plain f32 path's; stepwise and nudged, 0.34x (PERF.md §6). A's
// three parts are built in registers from the f32 activations in shared
// memory, one k16 step at a time (all of them for a whole K would not
// fit: wg_product's a[KS][4] three times over). So A is read again for
// each output chunk, and the outputs go to a stage in the block's
// device-memory scratch (L2) until the last chunk has read A: put runs
// after the product, as in wg_product.

// One k16 step (k0) of a chunk: A's parts built, the step's slab (ring
// slab li of the product) acquired, its six passes into a fresh
// accumulator, then tot += it (STEPWISE; else into tot itself). KS: the
// slabs a chunk streams (its steps). A pass is (A's part, B's part), ranks
// 0 hi, 1 mid, 2 lo; B's part p sits 32 p bytes into the slab's row.
template <int NW, int KS, int STAGES, int LDA, bool STEPWISE>
__device__ __forceinline__ void hp_step(Rings& st, float (&tot)[NW / 2], const float* A, int k0,
                                        const unsigned char* img, unsigned li, int n_stages,
                                        int row0) {
  const int tid = threadIdx.x;
  unsigned a[3][4];
  load_a3(A, LDA, 16 * ((tid >> 5) & 3), k0, a);
  const unsigned s = st.ws + li;
  if (tid == 0) issue_slab<4 * KS, STAGES, 1>(st, img, li + STAGES - 1, n_stages, n_stages, 0);
  const unsigned char* stage = ring_acquire<STAGES>(st.w, s, WSLAB) + row0 * 128;
  auto passes = [&](float (&acc)[NW / 2]) {
    mlp::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 6; ++i)
      mlp::wgmma_rs_bf16<NW>(acc, a[mlp::hp_part(i, 0)],
                             mlp::wgmma_desc(stage + 32 * mlp::hp_part(i, 1)), 1);
    mlp::wgmma_commit();
    mlp::wgmma_wait_all();
    ring_release<STAGES>(st.w, s);
  };
  if constexpr (STEPWISE) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    passes(acc);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) tot[i] += unbias_truncated(acc[i]);
  } else {
    passes(tot);
  }
}

// One chunk's products (its k16 steps in a loop), its total then stored to
// the stage S ([TILE][LDH] floats: the warpgroup's rows, columns col0 ..).
template <int NW, int KS, int STAGES, int LDA, bool STEPWISE>
__device__ __forceinline__ void hp_chunk(Rings& st, const float* A, const unsigned char* img,
                                         unsigned li0, int n_stages, int row0, int col0,
                                         float* S) {
  const int tid = threadIdx.x, w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, q = lane & 3;
  float tot[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) tot[i] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < KS; ++ks)
    hp_step<NW, KS, STAGES, LDA, STEPWISE>(st, tot, A, 16 * ks, img, li0 + ks, n_stages, row0);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(S + (16 * w + g + 8 * h) * LDH + col0 + 8 * j + 2 * q) =
          make_float2(tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
}

// wg_product's product and contract in PREC_F32's six passes: out = A[:,
// :16 KS] @ B in f32, B the three-part slab image img; single (DUAL false:
// both warpgroups on A0, each half of a chunk's columns) or DUAL (A0 / A1
// and put0 / put1, warpgroup h on stream h, B shared). S: the stage, two
// [TILE][LDH] f32 blocks in the block's scratch (hp_stage_of). put(r, c, v)
// for every output after the product, so put may overwrite A; a barrier
// after. The ring: STAGES stages of one slab. STEPWISE false sums every
// step in one accumulator: half its registers, and its outputs carry the
// truncation's bias (~2 f32 ulps).
template <int KS, bool DUAL, int STAGES = WSTAGES, int LDA = LDX, bool STEPWISE = true,
          class F0, class F1>
__device__ __forceinline__ void hp_product(Rings& st, const float* A0, const float* A1,
                                           const unsigned char* img, int nout, float* S,
                                           F0&& put0, F1&& put1) {
  // nout (<= 304: 5 chunks, LDH) a runtime width, each chunk 64 columns:
  // a 48-column tail (48, 304) runs as a full chunk on its image's zero
  // rows, so one compiled product serves every width of its depth (more
  // copies, or narrower chunks, cost registers the backward kernels
  // spilled)
  const int nch = (nout + 63) / 64, n_st = nch * KS;
  const int tid = threadIdx.x, wg = tid >> 7;
  const float* A = DUAL && wg ? A1 : A0;
  float* Sw = DUAL && wg ? S + TILE * LDH : S;
  if (tid == 0)   // the product's first slabs
    for (int li = 0; li < STAGES - 1; ++li)
      issue_slab<4 * KS, STAGES, 1>(st, img, li, n_st, n_st, 0);
#pragma unroll 1
  for (int j = 0; j < nch; ++j) {
    if constexpr (DUAL)
      hp_chunk<64, KS, STAGES, LDA, STEPWISE>(st, A, img, j * KS, n_st, 0, 64 * j, Sw);
    else
      hp_chunk<32, KS, STAGES, LDA, STEPWISE>(st, A, img, j * KS, n_st, 32 * wg,
                                              64 * j + 32 * wg, Sw);
  }
  st.ws += n_st;
  __syncthreads();
  // the outputs from the stage, a warp a row at a time, rolled: unrolled,
  // the puts cost the backward kernels registers they spilled
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll 1
  for (int hr = warp; hr < (DUAL ? 2 : 1) * TILE; hr += THREADS / 32) {
    const float* row = S + hr * LDH;
#pragma unroll 1
    for (int c = lane; c < nout; c += 32) {
      if (DUAL && hr >= TILE) put1(hr - TILE, c, row[c]);
      else put0(hr, c, row[c]);
    }
  }
  __syncthreads();
}

// A reverse product (depth 256, the layer's output cotangents; NOUT = K,
// its input width) of a 256-wide layer, one stream (put0) or the SDF's
// value and tangent streams (DUAL: A1 and put1 too); HP: hp_product's six
// passes (PREC_F32's SDF chain; hs its stage).
template <bool DUAL, bool HP = false, class F0, class F1>
__device__ __forceinline__ void reverse_product(Rings& st, int K, const float* A0,
                                                const float* A1, const unsigned char* img,
                                                F0&& put0, F1&& put1, float* hs = nullptr) {
  if constexpr (HP) {
    hp_product<HID / 16, DUAL>(st, A0, A1, img, K, hs, put0, put1);
  } else {
    if (K == EMB) wg_product<HID / 16, EMB, DUAL>(st, A0, A1, img, put0, put1);
    else if (K == HID) wg_product<HID / 16, HID, DUAL>(st, A0, A1, img, put0, put1);
    else wg_product<HID / 16, HID + EMB, DUAL>(st, A0, A1, img, put0, put1);
  }
}

// X[:, :NOUT] = bf16(A[:, :16 KS]) @ B over a tile's rows, the f32 products
// staged in X (A may be X: its fragments are in registers by then): ROWS = TILE
// as one stream (the two warpgroups split each chunk's columns), ROWS = 2
// TILE as two 64-row halves sharing every slab (warpgroup h rows 64 h ..
// 64 h + 64, all columns), each on its kernel's weight ring. The epilogue
// is then a SIMT pass over X (forward_pass, reverse_pass) that batches its
// loads: on one block of 8 warps an epilogue on the accumulators, one
// dependent chain at a time, cost more than the products.
template <int ROWS, int KS, int NOUT>
__device__ __forceinline__ void stage_product(Rings& st, float* X, const float* A,
                                              const unsigned char* img) {
  static_assert(ROWS == TILE || ROWS == 2 * TILE, "stage_product: ROWS");
  if constexpr (ROWS == TILE) {
    auto put = [=](int r, int c, float v) { X[r * LDX + c] = v; };
    wg_product<KS, NOUT, false, WSTAGES>(st, A, A, img, put, put);
  } else {
    constexpr int L = LD<ROWS>;
    auto put0 = [=](int r, int c, float v) { X[r * L + c] = v; };
    auto put1 = [=](int r, int c, float v) { X[(r + TILE) * L + c] = v; };
    wg_product<KS, NOUT, true, FWD_STAGES, FWD_SPS, L>(st, A, A + TILE * L, img, put0, put1);
  }
}

// stage_product in hp_product's six passes (PREC_F32's SDF chain), nout
// outputs a row, hs the stage, STEPWISE as hp_product's.
template <int ROWS, int KS, bool STEPWISE = true>
__device__ __forceinline__ void hp_stage_product(Rings& st, float* X, const float* A,
                                                 const unsigned char* img, int nout, float* hs) {
  if constexpr (ROWS == TILE) {
    auto put = [=](int r, int c, float v) { X[r * LDX + c] = v; };
    hp_product<KS, false, WSTAGES, LDX, STEPWISE>(st, A, A, img, nout, hs, put, put);
  } else {
    constexpr int L = LD<ROWS>;
    auto put0 = [=](int r, int c, float v) { X[r * L + c] = v; };
    auto put1 = [=](int r, int c, float v) { X[(r + TILE) * L + c] = v; };
    hp_product<KS, true, FWD_STAGES, L, STEPWISE>(st, A, A + TILE * L, img, nout, hs, put0,
                                                  put1);
  }
}

// A 256-wide layer's product over the tile, A's rows at A (stride LD),
// staged in X: forward ([ROWS, K] @ [K, 256], img the W slot's image) or
// reverse ([ROWS, 256] @ [256, K], the WT slot's), K = 48, 256 or 304:
// five shapes, each compiled once (HP: in the six passes, hs the stage;
// every reverse shape one product of runtime width, in one accumulator:
// the reverse sweep feeds only the grad, 3 values a point to the
// features' 256 at the colour net's bf16 input, so a truncation bias of a
// few f32 ulps there adds few bf16 rounding flips, and the registers it
// saves keep the march's backward from spilling).
template <int ROWS, bool HP = false>
__device__ __forceinline__ void layer_product(Rings& st, float* X, const float* A,
                                              const unsigned char* img, int K, bool reverse,
                                              float* hs = nullptr) {
  if constexpr (HP) {
    if (reverse) hp_stage_product<ROWS, HID / 16, false>(st, X, A, img, K, hs);
    else if (K == EMB) hp_stage_product<ROWS, EMB / 16>(st, X, A, img, HID, hs);
    else if (K == HID + EMB) hp_stage_product<ROWS, (HID + EMB) / 16>(st, X, A, img, HID, hs);
    else hp_stage_product<ROWS, HID / 16>(st, X, A, img, HID, hs);
  } else {
    if (!reverse && K == EMB) stage_product<ROWS, EMB / 16, HID>(st, X, A, img);
    else if (!reverse && K == HID + EMB) stage_product<ROWS, (HID + EMB) / 16, HID>(st, X, A, img);
    else if (reverse && K == EMB) stage_product<ROWS, HID / 16, EMB>(st, X, A, img);
    else if (reverse && K == HID + EMB) stage_product<ROWS, HID / 16, HID + EMB>(st, X, A, img);
    else stage_product<ROWS, HID / 16, HID>(st, X, A, img);
  }
}

// The forward product [TILE, K] @ [K, 256] of the backward's tangent
// stream (K = 48, 256 or 304; img its W slot's image; HP as above).
template <bool HP = false, class F>
__device__ __forceinline__ void forward_product(Rings& st, int K, const float* A,
                                                const unsigned char* img, F&& put,
                                                float* hs = nullptr) {
  if constexpr (HP) {
    if (K == EMB) hp_product<EMB / 16, false>(st, A, A, img, HID, hs, put, put);
    else if (K == HID) hp_product<HID / 16, false>(st, A, A, img, HID, hs, put, put);
    else hp_product<(HID + EMB) / 16, false>(st, A, A, img, HID, hs, put, put);
  } else {
    if (K == EMB) wg_product<EMB / 16, HID, false>(st, A, A, img, put, put);
    else if (K == HID) wg_product<HID / 16, HID, false>(st, A, A, img, put, put);
    else wg_product<(HID + EMB) / 16, HID, false>(st, A, A, img, put, put);
  }
}

// An SDF weight as its products take it: rounded to bf16, or as is in PREC_F32.
template <int PREC>
__device__ __forceinline__ float sdf_operand(float w) {
  return PREC == PREC_F32 ? w : round_bf16(w);
}

// After a forward product staged in X[:, :256]: dst[:, :256] = epi(X + b)
// over the tile's ROWS rows. Thread t takes columns 4 (t % 64) .. + 4 (its
// bias read once) of rows t / 64 + 4 m, NB rows a batch: the batch's loads
// first, then its arithmetic, then its stores (a warp a contiguous half
// row each), so a thread has NB rows' latencies in flight at once.
// EPI_SOFTPLUS also stores the gate to `gates` ([ROWS][HID]) and scales
// the value by `post`. dst may be X. EXPORT (EPI_SOFTPLUS) also writes
// each row that has a stash row (ex) at byte column `col` of it: the
// softplus before `post` in f32 (SX_BF16, PREC_BF16's stash: after `post`,
// in bf16, the next layer's input as JAX stores it). GATES false:
// no gate is computed or stored (the reverse sweep rebuilds them from the
// f32 softplus of the stash, export_gate4). A barrier after.
template <int ROWS, bool EXPORT = false, bool SX_BF16 = false, bool GATES = true>
__device__ __forceinline__ void forward_pass(float* X, const float* __restrict__ b, int epi,
                                             float post, float* gates, float* dst, int ld,
                                             const Export& ex = Export{nullptr, 0, 0},
                                             int col = 0) {
  constexpr int NB = 4, STEP = THREADS / (HID / 4);   // rows a batch, the row step (4)
  const int c = 4 * (threadIdx.x % (HID / 4)), r0 = threadIdx.x / (HID / 4);
  const float bias[4] = {__ldg(b + c), __ldg(b + c + 1), __ldg(b + c + 2), __ldg(b + c + 3)};
#pragma unroll 1
  for (int m = 0; m < ROWS / STEP; m += NB) {
    float4 x[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) x[u] = ld4(X + (r0 + STEP * (m + u)) * LD<ROWS> + c);
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int r = r0 + STEP * (m + u);
      float v[4] = {x[u].x + bias[0], x[u].y + bias[1], x[u].z + bias[2], x[u].w + bias[3]};
      float keep[4];
      if (epi == EPI_SOFTPLUS) {
        float g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sp = softplus100(v[i]);
          if constexpr (GATES) g[i] = 1.f - expf(-100.f * sp);
          keep[i] = sp;
          v[i] = sp * post;
        }
        if constexpr (GATES) st4(gates + r * HID + c, make_float4(g[0], g[1], g[2], g[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) keep[i] = v[i] = epi == EPI_RELU ? fmaxf(v[i], 0.f) : v[i];
      }
      st4(dst + r * ld + c, make_float4(v[0], v[1], v[2], v[3]));
      if constexpr (EXPORT) {
        if (epi == EPI_SOFTPLUS && r < ex.rows) {
          unsigned char* k = ex.row0 + size_t(r) * ex.bytes + col;
          if (SX_BF16)
            *reinterpret_cast<uint2*>(k + 2 * c) =
                make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
          else
            st4(reinterpret_cast<float*>(k) + c, make_float4(keep[0], keep[1], keep[2], keep[3]));
        }
      }
    }
  }
  __syncthreads();
}

// EXPORT (the save entry): a colour / relight layer input, X[:, :HID] of
// the forward tile's ROWS = 2 TILE points (two backward tiles, rows 64 h
// ..), as cr slot `slot` of each backward tile's images in the stash (ex.cr
// + h tile_bytes; act_layout): bf16, K-major [HID k][64 points], the
// 128-byte swizzle, a padding point (r >= ex.rows) zero, a tile without
// points not written. Each tile's image is built in shared memory at
// `stage` (the weight ring, idle between products), thread t its row k =
// t (a warp's reads of X on 32 consecutive columns, its 16-byte writes on
// 8 rows' distinct bank groups: no bank conflict), then thread 0 copies
// it out with one 32 KB bulk store; the second tile waits for the first
// copy's reads, and the caller's next product for the last one's (thread
// 0, before it refills the ring: forward_tile). Only reads X.
template <int ROWS>
__device__ __forceinline__ void export_cr(const float* X, const Export& ex, int slot,
                                          long long tile_bytes, unsigned char* stage) {
  static_assert(ROWS == 2 * TILE, "export_cr: the forward kernels' tiles");
  static_assert(size_t(FWD_STAGES) * FWD_SPS * WSLAB >= CR_SLOT, "export_cr: the stage");
  static_assert(THREADS == HID, "export_cr: a thread a row");
  const int k = threadIdx.x;
  for (int h = 0; h < 2 && TILE * h < ex.rows; ++h) {
    if (h == 1) {   // the first tile's copy has read the stage
      if (threadIdx.x == 0) mlp::bulk_store_wait_read();
      __syncthreads();
    }
#pragma unroll 2
    for (int c = 0; c < TILE / 8; ++c) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = TILE * h + 8 * c + e;
        v[e] = r < ex.rows ? X[r * LD<ROWS> + k] : 0.f;
      }
      *reinterpret_cast<uint4*>(stage + mlp::sw128_offset(k, 8 * c)) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
    mlp::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0)
      mlp::bulk_store(ex.cr + h * tile_bytes + size_t(slot) * CR_SLOT, stage, CR_SLOT);
  }
}

// out[r][j] = bf16(X[r, :K]) . bf16(W[j, :K]) + b[j] for j < n_out <= 3, r
// < ROWS (W: f32 row-major [n_out, K]), summed in f32 (exact: the operands
// unrounded, PREC_F32's sdf row): a warp takes four rows at a time, its
// lanes strided over K, and reduces the 4 x 3 partial sums together
// (independent shuffle chains, not one row's after another's).
template <int ROWS>
__device__ __forceinline__ void narrow_layer(const float* X, int K, int n_out,
                                             const float* __restrict__ W,
                                             const float* __restrict__ b, float* out, int ld_out,
                                             bool exact = false) {
  constexpr int RG = 4;   // rows at a time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = RG * warp; r0 < ROWS; r0 += RG * (THREADS / 32)) {
    float s[RG][3] = {};
    for (int k = lane; k < K; k += 32) {
      float w[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float wv = j < n_out ? __ldg(W + j * K + k) : 0.f;
        w[j] = exact ? wv : round_bf16(wv);
      }
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float xv = X[(r0 + i) * LD<ROWS> + k];
        const float x = exact ? xv : round_bf16(xv);
#pragma unroll
        for (int j = 0; j < 3; ++j) s[i][j] = fmaf(x, w[j], s[i][j]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], o);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (j < n_out) out[(r0 + i) * ld_out + j] = s[i][j] + b[j];
  }
  __syncthreads();
}

// The f32 softplus at byte column col of row r of a forward tile's stash
// rows (ex), a padding row's read from row 0: every read of a batch issues
// unconditionally, ahead of its use (a read under a branch waits for the
// one before it: PERF.md §6). The block wrote the rows (forward_pass's
// export, a barrier since), so they are read with plain loads, not __ldg.
__device__ __forceinline__ const float* export_sp(const Export& ex, int col, int r) {
  return reinterpret_cast<const float*>(ex.row0 + size_t(r < ex.rows ? r : 0) * ex.bytes + col);
}

// The gates 1 - exp(-100 sp) of four of export_sp's values, bit for bit
// forward_pass's; 0 on a padding row (real false).
__device__ __forceinline__ float4 export_gate4(float4 sp, bool real) {
  return real ? make_float4(1.f - expf(-100.f * sp.x), 1.f - expf(-100.f * sp.y),
                            1.f - expf(-100.f * sp.z), 1.f - expf(-100.f * sp.w))
              : make_float4(0.f, 0.f, 0.f, 0.f);
}

// After reverse layer l's product: X[:, :K] holds p = q_l @ W_l^T, the
// cotangent of layer l's input (q_l = d raw / d (layer l output) times its
// gate). Its hidden part, times 1/sqrt(2) at the skip layer and times the
// gate of layer l - 1 (gates_prev, read in 16-byte groups), becomes q_{l-1}
// in X; its PE part (the skip layer's last 48 columns, or all of layer 0's)
// adds to the PE cotangents, which the sweep keeps in X's PE columns (X[:,
// 256:304], zeros before the sweep): the skip layer's output lands there
// and is scaled in place (the sweep's one 304-wide product, with the
// cotangents still zero), layer 0's adds. SG: the gates of layer l - 1
// rebuilt from its f32 softplus in the tile's stash rows (ex, byte column
// col: export_sp, read with X, export_gate4) instead of gates_prev. A
// barrier after.
template <int ROWS, bool SG = false>
__device__ __forceinline__ void reverse_pass(float* X, int K, bool is_skip,
                                             const float* gates_prev,
                                             const Export& ex = Export{nullptr, 0, 0},
                                             int col = 0) {
  if (K == EMB) {
    for (int e = threadIdx.x; e < ROWS * EMB; e += THREADS) {
      const int r = e / EMB, c = e % EMB;
      X[r * LD<ROWS> + HID + c] += X[r * LD<ROWS> + c];
    }
  } else {
    // as forward_pass's batches: X and the gates of NB rows loaded at once
    constexpr int NB = 8, STEP = THREADS / (HID / 4);
    const int c = 4 * (threadIdx.x % (HID / 4)), r0 = threadIdx.x / (HID / 4);
    const float s = is_skip ? INV_SQRT2 : 1.f;
#pragma unroll 1
    for (int m = 0; m < ROWS / STEP; m += NB) {
      float4 x[NB], g[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int r = r0 + STEP * (m + u);
        x[u] = ld4(X + r * LD<ROWS> + c);
        if constexpr (SG) g[u] = ld4(export_sp(ex, col, r) + c);
        else g[u] = ld4(gates_prev + r * HID + c);
      }
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int r = r0 + STEP * (m + u);
        if constexpr (SG) g[u] = export_gate4(g[u], r < ex.rows);
        st4(X + r * LD<ROWS> + c,
            is_skip ? make_float4(x[u].x * s * g[u].x, x[u].y * s * g[u].y, x[u].z * s * g[u].z,
                                  x[u].w * s * g[u].w)
                    : make_float4(x[u].x * g[u].x, x[u].y * g[u].y, x[u].z * g[u].z,
                                  x[u].w * g[u].w));
      }
    }
    if (K == HID + EMB)
      for (int e = threadIdx.x; e < ROWS * EMB; e += THREADS) {
        const int r = e / EMB, c = e % EMB;
        X[r * LD<ROWS> + HID + c] *= INV_SQRT2;
      }
  }
  __syncthreads();
}

// dst[:, :K] = src[:, :K] (a layer input, kept for the backward). Only
// reads src, so it needs no barrier before the layer that reads src too.
__device__ __forceinline__ void save_cols(const float* src, int K, float* dst) {
  for (int e = threadIdx.x; e < TILE * K; e += THREADS) {
    const int r = e / K, c = e % K;
    dst[r * LDS + c] = src[r * LDX + c];
  }
}

// ------------------------------------------------------------------------
// The weight-grad store: per tile, every 256-wide layer's weight-grad
// operands in bf16, transposed so that the 64 points are the contiguous
// (K-major) dimension of a wgmma operand: the layer's inputs X^T
// ([round64(K)][64], 128 bytes a row, 128-byte swizzle) and its output
// cotangents ([256][64]). The flush (dw_flush) sums X^T abar over the
// tiles of a batch on chip.
// ------------------------------------------------------------------------

struct Shape {
  int n_sdf, skip, n_color, n_relight, y_in;
};

__host__ __device__ inline int round64(int k) { return (k + 63) / 64 * 64; }

// Blocks in flush order: SDF hidden layers 0 .. n_sdf - 2, the features,
// colour layers 0 .. n_color - 2, relight layers 0 .. n_relight - 2.
__host__ __device__ inline int dw_n_blocks(const Shape& s) {
  return s.n_sdf + s.n_color - 1 + (s.n_relight > 0 ? s.n_relight - 1 : 0);
}

// Block bi: its K (input rows), its slot in the offset table and its
// terms. An SDF layer sums X^T abar + U^T zbar (value and tangent); layer
// 0 takes X and U as hi + lo bf16 pairs, four terms: (X hi, abar), (X lo,
// abar), (U hi, zbar), (U lo, zbar). Term i reads A^T block i and
// cotangent block i / 2 (four terms), i (two) or 0 (one). PREC_F32 (a
// library of PP_PREC 2) sums six terms a stream (12 an SDF layer, 6 the
// features), each reading A^T block i and cotangent block i: a stream's
// six blocks each side hold, term by term, (A part, cotangent part) =
// (hi, Mid), (hi, Lo), (mid, Hi), (mid, Mid), (lo, Hi), (hi, Hi) of the
// operands' three bf16 parts (save_t3), so a part is stored once for each
// term that reads it: a mapping from term to part computed in the flush's
// loop cost the backward kernels a register they spilled. Within a
// stream the small terms come first, so they round at their own sum's
// ulp in the flush's accumulator, not at the weight grad's.
struct DwBlock {
  int K, slot, nterm;
  long long base;   // byte offset of the block's operands in a tile's store
};

__host__ __device__ inline DwBlock dw_kind(const Shape& s, int bi) {
  DwBlock b{};
  if (bi < s.n_sdf - 1) {
    b.K = bi == 0 ? EMB : (bi == s.skip ? HID + EMB : HID);
    b.slot = W_SDF + bi;
    b.nterm = PP_PREC == PREC_F32 ? 12 : (bi == 0 ? 4 : 2);
  } else if (bi == s.n_sdf - 1) {
    b.K = HID;
    b.slot = W_FEAT;
    b.nterm = PP_PREC == PREC_F32 ? 6 : 1;
  } else if (bi < s.n_sdf + s.n_color - 1) {
    const int l = bi - s.n_sdf;
    b.K = l == 0 ? HID + EMB : HID;
    b.slot = W_COL + l;
    b.nterm = 1;
  } else {
    const int l = bi - (s.n_sdf + s.n_color - 1);
    b.K = l == 0 ? EMB : (l == s.y_in ? HID + EMB : HID);
    b.slot = W_REL + l;
    b.nterm = 1;
  }
  return b;
}

__host__ __device__ inline long long dw_block_bytes(const DwBlock& b) {
  return (long long)b.nterm * round64(b.K) * 128 +
         (PP_PREC == PREC_F32 ? b.nterm : (b.nterm == 1 ? 1 : 2)) * HID * 128;
}

__host__ __device__ inline DwBlock dw_block(const Shape& s, int bi) {
  // PREC_F32: after hp_product's stage (hp_stage_of)
  long long base = PP_PREC == PREC_F32 ? (long long)(HS_FLOATS * sizeof(float)) : 0;
  for (int i = 0; i < bi; ++i) base += dw_block_bytes(dw_kind(s, i));
  DwBlock b = dw_kind(s, bi);
  b.base = base;
  return b;
}

__host__ __device__ inline long long dw_tile_bytes(const Shape& s) {
  return dw_block(s, dw_n_blocks(s)).base;
}

// A^T block i and cotangent block j of block bi in a tile's store.
__device__ __forceinline__ unsigned char* dw_a(const Shape& s, unsigned char* store, int bi,
                                               int i) {
  const DwBlock b = dw_block(s, bi);
  return store + b.base + (long long)i * round64(b.K) * 128;
}
__device__ __forceinline__ unsigned char* dw_b(const Shape& s, unsigned char* store, int bi,
                                               int j) {
  const DwBlock b = dw_block(s, bi);
  return store + b.base + (long long)b.nterm * round64(b.K) * 128 + (long long)j * HID * 128;
}

__host__ __device__ inline Shape shape_of(const Params& p) {
  return Shape{p.n_sdf, p.skip, p.n_color, p.n_relight, p.y_in};
}

// The activation stash of mode prec, in two parts. A point's row, byte
// offsets: sx, the softplus of every hidden SDF layer ([n_sdf - 1][HID],
// sxw bytes a layer: f32, layer l + 1's input before the skip's 1/sqrt(2),
// and layer l's gate rebuilt as 1 - exp(-100 sp); in PREC_BF16 bf16, layer
// l + 1's input after it, the gate rebuilt from the bf16 value times
// sqrt(2) there); tail, 8 f32: gc (3), delta (3), T, 0. Then, from a
// 1024-byte boundary after the rows (act_cr_offset), the cr images of
// every 64-point backward tile (the halves of the forward's tiles, a group
// of rays ray_march.cu's rays_per_group), n_cr * CR_SLOT bytes a tile:
// slot j, in bf16, the hidden part of a colour layer's input (slot
// l: colour layer l's, layer 0's the features) or a relight layer's
// (slot n_color + l - 1: relight layer l's, l >= 1; relu outputs), as the
// flush's A^T operand: K-major [HID k][64 points], 128 bytes a row, the
// 128-byte swizzle (mlp::sw128_offset(k, point)), a padding point zero.
// So the flush bulk-copies a colour / relight layer's first 256 rows from
// the stash (dw_issue_load) and the backward stages them from it (stage_cr).
// The PE, the small inputs and the y_in layer's gc block are rebuilt from
// the points and the tail. The backward reads the bf16 parts only as bf16
// product operands, relu masks and the bf16 gates' source.
struct ActLayout {
  int sx, sxw, tail, bytes;   // bytes: a point's row
  int n_cr;                   // cr slots: n_color + n_relight - 1
};

__host__ __device__ inline ActLayout act_layout(const Shape& s, int prec) {
  ActLayout a;
  a.sx = 0;
  a.sxw = HID * (prec == PREC_BF16 ? 2 : 4);
  a.tail = (s.n_sdf - 1) * a.sxw;
  a.bytes = a.tail + 8 * 4;
  a.n_cr = s.n_color + (s.n_relight > 0 ? s.n_relight - 1 : 0);
  return a;
}

// Where the cr images start in a stash of n_pts points' rows.
__host__ __device__ inline long long act_cr_offset(long long n_pts, const ActLayout& a) {
  return (n_pts * a.bytes + 1023) / 1024 * 1024;
}

// The cr slot of a weight-grad block bi (dw_kind's order) whose first 256
// input rows the stash holds (a colour layer's, a relight layer's from
// layer 1 on), else -1.
__host__ __device__ inline int cr_slot_of(const Shape& s, int bi) {
  const int c = bi - s.n_sdf, r = bi - (s.n_sdf + s.n_color - 1);
  return c >= 0 && c < s.n_color - 1 ? c : (r >= 1 ? s.n_color + r - 1 : -1);
}

// x less its bf16 parts before PART (PART 0: x; 1: x - hi; 2: x - hi - mid):
// rounded to bf16, part PART of x (hp_product's split, load_a3).
template <int PART>
__device__ __forceinline__ float bf16_rest(float x) {
#pragma unroll
  for (int i = 0; i < PART; ++i) x -= round_bf16(x);
  return x;
}

// dst = part PART of src[:, :K]^T in bf16 (0 hi, bf16(x); 1 bf16(x -
// hi): f32stash's lo of layer 0's hi + lo pair, PREC_F32's mid; 2
// PREC_F32's lo, bf16(x - hi - mid)) as a K-major [K][64 points] wgmma
// operand (row c: the 64 points, 128 bytes, the 128-byte swizzle). A warp
// stores an 8-column x 8-point patch a step: its shared-memory reads hit
// 32 banks, its global writes fill one 16-byte chunk of 8 rows. Only
// reads src.
template <int PART>
__device__ __forceinline__ void save_t(const float* src, int K, unsigned char* dst) {
  if constexpr (RM_ABLATE == 4) return;   // no_wgrad
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gi = warp; gi < K; gi += THREADS / 32) {   // K / 8 column groups x 8 point groups
    const int c = 8 * (gi >> 3) + (lane & 7), pr = 4 * (gi & 7) + (lane >> 3);
    const float x0 = src[(2 * pr) * LDX + c], x1 = src[(2 * pr + 1) * LDX + c];
    const unsigned w = pack_bf16(bf16_rest<PART>(x0), bf16_rest<PART>(x1));
    *reinterpret_cast<unsigned*>(dst + mlp::sw128_offset(c, 2 * pr)) = w;
  }
}

// PREC_F32: save_t of src's three parts into a stream's six blocks of the
// store from dst (round64(K) 128 bytes apart; dw_kind's terms): block t
// gets the part term t reads, its A part (COT false: src an A^T
// operand) or its cotangent part (COT true). The loop stays rolled:
// unrolled it cost the backward kernels registers they spilled. Only
// reads src.
template <bool COT>
__device__ __forceinline__ void save_t3(const float* src, int K, unsigned char* dst) {
  if constexpr (RM_ABLATE == 4) return;   // no_wgrad
  constexpr int part_of[2][6] = {{0, 0, 1, 1, 2, 0}, {1, 2, 0, 1, 0, 0}};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t block_bytes = size_t(round64(K)) * 128;
#pragma unroll 1
  for (int gi = warp; gi < K; gi += THREADS / 32) {
    const int c = 8 * (gi >> 3) + (lane & 7), pr = 4 * (gi & 7) + (lane >> 3);
    float x0 = src[(2 * pr) * LDX + c], x1 = src[(2 * pr + 1) * LDX + c];
    unsigned w[3];
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      w[part] = pack_bf16(x0, x1);
      x0 -= __uint_as_float(w[part] << 16);
      x1 -= __uint_as_float(w[part] & 0xffff0000u);
    }
    unsigned char* const d = mlp::sw128_offset(c, 2 * pr) + dst;
#pragma unroll
    for (int t = 0; t < 6; ++t)
      *reinterpret_cast<unsigned*>(d + t * block_bytes) = w[part_of[COT][t]];
  }
}

// The load entry's view of a 64-point tile of the save mode's activation
// stash (ray_march.cu): row r at row0 + r bytes (layout al), its first n
// rows real, a padding row reading as zeros; its cr images at cr
// (act_layout). Nothing is read under RM_ABLATE 2 (no_unflatten: the
// stash not read).
struct TileStash {
  const unsigned char* row0;
  int bytes, n;
  ActLayout al;
  const unsigned char* cr;
};

// The stash is read-only in the backward: its reads are wide non-coherent
// loads (__ldg), issued in batches ahead of the stores that use them, so
// that a thread has a batch's latencies in flight at once (one read after
// another, each behind the last one's store, pays a device-memory latency
// each: the load entry's time when the tile staged its rows so, PERF.md
// §5).

// Columns c .. c + 4 of row r of what the stash holds of hidden SDF layer
// l: its softplus sp in f32 (one 16-byte read), or in PREC_BF16 the input
// of layer l + 1 in bf16 (8 bytes); zeros on a padding row.
template <int PREC>
__device__ __forceinline__ float4 stash_sx4(const TileStash& ts, int l, int r, int c) {
  if (RM_ABLATE == 2) return make_float4(0.01f, 0.01f, 0.01f, 0.01f);
  if (r >= ts.n) return make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned char* row = ts.row0 + size_t(r) * ts.bytes + ts.al.sx + l * ts.al.sxw;
  if constexpr (PREC == PREC_BF16) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(row + 2 * c));
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(row) + c / 4);
  }
}

// Layer l's gates 1 - exp(-100 sp) from what stash_sx4 read: bit for bit
// the forward's (forward_pass) from the same sp (PREC_BF16: sp rebuilt
// from the bf16 input, times sqrt(2) before the skip layer, as JAX's
// unflatten_stash); 0 on a padding row.
template <int PREC>
__device__ __forceinline__ float4 stash_gate4(float4 x, bool pre_skip) {
  const float s = PREC == PREC_BF16 && pre_skip ? SQRT2 : 1.f;
  if constexpr (PREC == PREC_BF16) x = make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
  return make_float4(1.f - expf(-100.f * x.x), 1.f - expf(-100.f * x.y),
                     1.f - expf(-100.f * x.z), 1.f - expf(-100.f * x.w));
}

// A pass over a tile's [TILE][HID] block, as forward_pass's batches:
// thread t takes columns 4 (t % 64) .. + 4 of rows t / 64 + 4 m, NB rows a
// batch, the batch's reads read(r, c) first, then its put(r, c, v).
template <int NB, class R, class F>
__device__ __forceinline__ void stash_rows(R&& read, F&& put) {
  constexpr int STEP = THREADS / (HID / 4);
  const int c = 4 * (threadIdx.x % (HID / 4)), r0 = threadIdx.x / (HID / 4);
#pragma unroll 1
  for (int m = 0; m < TILE / STEP; m += NB) {
    float4 v[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) v[u] = read(r0 + STEP * (m + u), c);
#pragma unroll
    for (int u = 0; u < NB; ++u) put(r0 + STEP * (m + u), c, v[u]);
  }
}

// Point 8 c + e's value in a 16-byte chunk w of a cr image (points 8 c ..
// 8 c + 8 of one row k), in f32.
__device__ __forceinline__ float cr_value(const uint4& w, int e) {
  const unsigned x = e < 4 ? (e < 2 ? w.x : w.y) : (e < 6 ? w.z : w.w);
  return __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
}

// dst[:, :HID] (row stride LDX) = the cr slot `slot` of the tile in f32,
// from its image in the stash (ts.cr; K-major [HID k][64 points], the
// 128-byte swizzle: act_layout), a padding point's zeros as the forward
// wrote them: thread t takes rows k 4 (t % 64) .. + 4 of points 8 c .. + 8,
// c = t / 64 and 4 + t / 64, its eight 16-byte reads first, then sixteen
// 16-byte stores of four columns a point (a warp on 128 consecutive
// columns of a row: no bank conflict); gc_block: also dst[:, HID .. HID +
// EMB] = [gc, 0 ...] (the relight y_in layer's input). A barrier after.
__device__ __forceinline__ void stage_cr(const TileStash& ts, const Tile& t, int slot, float* dst,
                                         bool gc_block) {
  const int k0 = 4 * (threadIdx.x % 64), c0 = threadIdx.x / 64;
  const unsigned char* img = ts.cr + size_t(slot) * CR_SLOT;
  uint4 w[2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[u][i] = RM_ABLATE == 2 ? make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u)
                               : __ldg(reinterpret_cast<const uint4*>(
                                     img + mlp::sw128_offset(k0 + i, 8 * (c0 + 4 * u))));
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      st4(dst + (8 * (c0 + 4 * u) + e) * LDX + k0,
          make_float4(cr_value(w[u][0], e), cr_value(w[u][1], e), cr_value(w[u][2], e),
                      cr_value(w[u][3], e)));
  if (gc_block)
    for (int e = threadIdx.x; e < TILE * EMB; e += THREADS)
      dst[(e / EMB) * LDX + HID + e % EMB] = e % EMB < 3 ? t.GC[(e / EMB) * 3 + e % EMB] : 0.f;
  __syncthreads();
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void pe_row(const Params& p, const Tile& t, int r, float* x) {
#pragma unroll
  for (int j = 0; j < 3; ++j) x[j] = __fmul_rn(t.P3[r * 3 + j], p.scale);
}

// PE[r * LD + c] = PE(p * scale) of the tile's ROWS points (X's PE
// columns: PE = X + HID). No barrier.
template <int ROWS>
__device__ __forceinline__ void fill_pe(const Params& p, const Tile& t, float* PE) {
  for (int e = threadIdx.x; e < ROWS * EMB; e += THREADS) {
    const int r = e / EMB, c = e % EMB;
    float x[3];
    pe_row(p, t, r, x);
    PE[r * LD<ROWS> + c] = emb_value(x, c, p.d0);
  }
}

// X[:, col0 .. col0 + EMB] = a network's small inputs [pts, grad, PE(dirs)
// of width dv, 0 ...] of the tile's ROWS points; gc_block: also X[:, HID
// .. HID + EMB] = [gc, 0 ...], the relight y_in layer's. No barrier.
template <int ROWS>
__device__ __forceinline__ void small_inputs(const Tile& t, float* X, int col0, int dv,
                                             bool gc_block) {
  for (int e = threadIdx.x; e < ROWS * EMB; e += THREADS) {
    const int r = e / EMB, c = e % EMB;
    float v;
    if (c < 3) v = t.P3[r * 3 + c];
    else if (c < 6) v = t.G3[r * 3 + c - 3];
    else v = (c - 6 < dv) ? emb_value(t.D3 + r * 3, c - 6, dv) : 0.f;
    X[r * LD<ROWS> + col0 + c] = v;
    if (gc_block) X[r * LD<ROWS> + HID + c] = c < 3 ? t.GC[r * 3 + c] : 0.f;
  }
}

// The input width of SDF layer l (l < n_sdf - 1).
__device__ __forceinline__ int sdf_k(const Params& p, int l) {
  return l == 0 ? EMB : (l == p.skip ? HID + EMB : HID);
}

// The forward of the ROWS-point tile whose points and view dirs the caller
// has put in t.P3 / t.D3 (zeros for a padding point; a barrier after),
// leaving sdf, grad, gc, relit and delta in t.S1/G3/GC/RL/DL and the gates
// ([n_sdf - 1][ROWS][HID]) and features ([ROWS][HID]) in the block's
// scratch. SAVE (the backward's recompute, ROWS = TILE) also keeps every
// layer's input (sv); EXPORT (the march's save mode) writes each point's
// row of the activation stash (ex, act_layout) from the passes, and where
// the stash keeps the SDF softplus in f32 (PREC_F32STASH, PREC_F32: SG) the
// reverse sweep rebuilds the gates from it (export_gate4) and `gates` is
// neither written nor read.
//
// PREC is the MARCH_BWD_PRECISION mode (the note at the top): in PREC_F32
// the SDF layers' products, the last layer's and the reverse sweep's run
// in hp_product's six passes (staged in hp_stage_of(sv); narrow_layer
// exact for the sdf row), and SAVE stores their inputs as three bf16
// parts (save_t3);
// in PREC_BF16 EXPORT writes the SDF part of the stash in bf16.
//
// The tile runs as one loop of steps: the SDF layers, the last layer (its
// sdf row as a narrow layer, its features), the reverse sweep, the colour
// and the relight layers, and a closing step. A step does the work due
// before its product (each piece at one place in the loop), then the
// layer's product on wgmma (layer_product) and its pass. So every product
// shape, pass and SIMT piece is compiled once.
// The SDF PE stays in X's PE columns (X[:, 256:304]) from layer 0, which
// reads it there, to the skip layer, which takes it times 1/sqrt(2); the
// reverse sweep then keeps the PE cotangents there.
template <int ROWS, bool SAVE, bool EXPORT, int PREC>
__device__ __forceinline__ void forward_tile(const Params& p, const Tile& t, Rings& st,
                                             float* gates, float* feat, const Save& sv,
                                             const Export& ex = Export{nullptr, 0, 0}) {
  static_assert(!SAVE || ROWS == TILE, "forward_tile: the saved operands are 64-point tiles");
  static_assert(!(SAVE && EXPORT), "forward_tile: SAVE or EXPORT");
  constexpr size_t GS = size_t(ROWS) * HID;   // one layer's gates
  enum { SDF, LAST, REV, COL, REL, END };
  constexpr int L = LD<ROWS>;   // X's row stride
  const int tid = threadIdx.x;
  const float* W = p.w;
  const Shape sh = shape_of(p);
  float* const X = t.X;
  float* const PE = X + HID;
  const int nf = p.n_sdf - 1, nc = p.n_color - 1, nr = p.n_relight > 0 ? p.n_relight - 1 : 0;
  const int c0 = 2 * nf + 1, q0 = c0 + nc, n_steps = q0 + nr;
  constexpr bool SG = EXPORT && PREC != PREC_BF16;   // the gates from the stash

  for (int i = 0; i <= n_steps; ++i) {
    const int kind = i < nf ? SDF : i == nf ? LAST : i < c0 ? REV : i < q0 ? COL
                   : i < n_steps ? REL : END;
    const int l = kind == SDF ? i : kind == LAST ? nf : kind == REV ? c0 - 1 - i
                : kind == COL ? i - c0 : kind == REL ? i - q0 : nr;
    // the input width of the step's layer (END: the relight net's last layer)
    const int K = kind == SDF || kind == REV ? sdf_k(p, l)
                : kind == COL ? (l == 0 ? HID + EMB : HID)
                : kind == LAST ? HID
                : p.n_relight > 0 ? (l == 0 ? EMB : (l == p.y_in ? HID + EMB : HID)) : HID;
    if (i == 0) {   // X[:, 256:304] = PE(p * scale)
      fill_pe<ROWS>(p, t, PE);
      __syncthreads();
    }
    if (kind == COL && l == 0) {
      // PE pullback: grad_j = sum_c EG_c d emb_c / d (p_j scale) (the
      // scale of the PE and the 1/scale of the sdf cancel); X = features
      if (tid < ROWS) {
        float x[3], gr[3] = {0.f, 0.f, 0.f};
        pe_row(p, t, tid, x);
        for (int c = 0; c < p.d0; ++c) {
          int j;
          const float sl = mlp::emb_slope(x, c, p.d0, &j);
          gr[j] = fmaf(PE[tid * L + c], sl, gr[j]);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) t.G3[tid * 3 + j] = gr[j];
        t.S1[tid] *= 1.f / p.scale;
      }
#pragma unroll 4
      for (int e = tid; e < ROWS * HID / 4; e += THREADS) {
        const int r = e / (HID / 4), c = 4 * (e % (HID / 4));
        st4(X + r * L + c, ld4(feat + r * HID + c));
      }
      __syncthreads();
      if constexpr (EXPORT)   // the features: cr slot 0
        export_cr<ROWS>(X, ex, 0, (long long)act_layout(sh, PREC).n_cr * CR_SLOT, st.w.buf);
    }
    // ---- a narrow layer: the sdf row, gc (colour's last), delta (relight's last) ----
    const bool colour_last = (kind == REL && l == 0) || (kind == END && nr == 0);
    if (kind == LAST || colour_last || (kind == END && nr > 0)) {
      const int wn = kind == LAST ? W_LAST : colour_last ? W_COL + nc : W_REL + nr;
      const int bn = kind == LAST ? B_LAST : colour_last ? B_COL + nc : B_REL + nr;
      const int n_out = kind == LAST ? 1 : 3;
      const int kn = kind == LAST || colour_last ? HID : K;
      float* out = kind == LAST ? t.S1 : colour_last ? t.GC : t.DL;
      if (SAVE && kind != LAST) save_cols(X, kn, colour_last ? sv.cx + nc * SLAB : sv.rx + nr * SLAB);
      narrow_layer<ROWS>(X, kn, n_out, W + p.off[wn], W + p.off[bn], out, n_out,
                         PREC == PREC_F32 && kind == LAST);
      if (colour_last && p.squeeze) {
        for (int e = tid; e < ROWS * 3; e += THREADS) t.GC[e] = sigmoidf_(t.GC[e]);
        __syncthreads();
      }
    }
    if (kind == END) break;
    // ---- a network's small inputs: [pts, grad, PE(dirs)] (colour: after
    // the features; relight: first, gc after the hidden part) ----
    if ((kind == COL || kind == REL) && l == 0) {
      small_inputs<ROWS>(t, X, kind == COL ? HID : 0, kind == COL ? p.color_dv : p.rl_dv,
                         kind == REL);
      __syncthreads();
    }
    if (kind == REV && l == nf - 1) {
      // q = W_last[0, :] (in bf16; f32 in PREC_F32) * gate of the last
      // hidden layer; the PE cotangents (X[:, 256:304]) zero
      const float* wl = W + p.off[W_LAST];
      const float* g_last = gates + (nf - 1) * GS;
      if constexpr (SG) {   // the stash's softplus read in batches of NB rows, then used
        constexpr int NB = 8, STEP = THREADS / (HID / 4);
        const int c = 4 * (tid % (HID / 4)), r0 = tid / (HID / 4);
        const ActLayout al = act_layout(sh, PREC);
        const int col = al.sx + (nf - 1) * al.sxw;
        const float4 w4 = make_float4(
            sdf_operand<PREC>(__ldg(wl + c)), sdf_operand<PREC>(__ldg(wl + c + 1)),
            sdf_operand<PREC>(__ldg(wl + c + 2)), sdf_operand<PREC>(__ldg(wl + c + 3)));
#pragma unroll 1
        for (int m = 0; m < ROWS / STEP; m += NB) {
          float4 sp[NB];
#pragma unroll
          for (int u = 0; u < NB; ++u) sp[u] = ld4(export_sp(ex, col, r0 + STEP * (m + u)) + c);
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int r = r0 + STEP * (m + u);
            const float4 g4 = export_gate4(sp[u], r < ex.rows);
            st4(X + r * L + c, make_float4(w4.x * g4.x, w4.y * g4.y, w4.z * g4.z, w4.w * g4.w));
          }
        }
      } else {
#pragma unroll 4
        for (int e = tid; e < ROWS * HID / 4; e += THREADS) {
          const int r = e / (HID / 4), c = 4 * (e % (HID / 4));
          const float4 g4 = ld4(g_last + r * HID + c);
          st4(X + r * L + c, make_float4(sdf_operand<PREC>(__ldg(wl + c)) * g4.x,
                                           sdf_operand<PREC>(__ldg(wl + c + 1)) * g4.y,
                                           sdf_operand<PREC>(__ldg(wl + c + 2)) * g4.z,
                                           sdf_operand<PREC>(__ldg(wl + c + 3)) * g4.w));
        }
      }
      for (int e = tid; e < ROWS * EMB; e += THREADS) PE[(e / EMB) * L + e % EMB] = 0.f;
      __syncthreads();
    }
    // ---- the layer's input kept for the backward ----
    const float* A = kind == SDF && l == 0 ? PE : X;
    // PREC_F32: the SDF chain's products (the SDF layers, the last layer's
    // features, the reverse sweep) in the six passes
    const bool f32_step = PREC == PREC_F32 && (kind == SDF || kind == LAST || kind == REV);
    if (SAVE && kind != REV) {
      const int bi = kind == SDF || kind == LAST ? l : kind == COL ? p.n_sdf + l
                   : p.n_sdf + p.n_color - 1 + l;
      if (kind == COL) save_cols(X, K, sv.cx + l * SLAB);
      if (kind == REL) save_cols(X, K, sv.rx + l * SLAB);
      if (f32_step) {
        save_t3<false>(A, K, dw_a(sh, sv.dw, bi, 0));   // the value stream's
      } else {
        save_t<0>(A, K, dw_a(sh, sv.dw, bi, 0));
        if (kind == SDF && l == 0) save_t<1>(A, K, dw_a(sh, sv.dw, 0, 1));   // hi + lo
      }
    }
    // ---- the product and its pass ----
    const int slot = kind == SDF ? W_SDF + l : kind == LAST ? W_FEAT : kind == REV ? WT_SDF + l
                   : kind == COL ? W_COL + l : W_REL + l;
    // the reverse sweep's next gates (SG: their stash rows' softplus) into
    // L2 while the product runs
    if constexpr (SG) {
      const ActLayout al = act_layout(sh, PREC);
      if (kind == REV && l > 0 && tid < ex.rows && tid < ROWS)
        mlp::prefetch_l2(ex.row0 + size_t(tid) * ex.bytes + al.sx + (l - 1) * al.sxw,
                         unsigned(HID * sizeof(float)));
    } else if (kind == REV && l > 0 && tid == 0) {
      mlp::prefetch_l2(gates + (l - 1) * GS, unsigned(GS * sizeof(float)));
    }
    if constexpr (EXPORT)   // the last cr image's bulk store has read the ring (export_cr)
      if (tid == 0) mlp::bulk_store_wait_read();
    // (PREC_F32 runs every reverse step in the six passes: the other steps
    // are forward products, so its bf16 reverse shapes are not compiled)
    if (f32_step)
      layer_product<ROWS, true>(st, X, A, image(p, slot), K, kind == REV, hp_stage_of(sv));
    else layer_product<ROWS>(st, X, A, image(p, slot), K, PREC != PREC_F32 && kind == REV);
    // a softplus layer's gates; in the reverse sweep the next ones (not
    // kept live across the product: the backward kernel has no register to
    // spare there)
    float* g = kind == SDF ? gates + l * GS : kind == REV && l > 0 ? gates + (l - 1) * GS : nullptr;
    if (kind == REV) {
      if constexpr (SG) {
        const ActLayout al = act_layout(sh, PREC);
        reverse_pass<ROWS, true>(X, K, l == p.skip, g, ex, al.sx + (l > 0 ? l - 1 : 0) * al.sxw);
      } else {
        reverse_pass<ROWS>(X, K, l == p.skip, g);
      }
    } else {
      const int bslot = kind == SDF ? B_SDF + l : kind == LAST ? B_FEAT
                      : kind == COL ? B_COL + l : B_REL + l;
      int col = 0;   // an SDF step's output in the stash row: sx of layer l
      if constexpr (EXPORT) {
        const ActLayout al = act_layout(sh, PREC);
        col = al.sx + l * al.sxw;
      }
      forward_pass<ROWS, EXPORT, PREC == PREC_BF16, !SG>(X, W + p.off[bslot],
                                 kind == SDF ? EPI_SOFTPLUS : kind == LAST ? EPI_NONE : EPI_RELU,
                                 kind == SDF && l + 1 == p.skip ? INV_SQRT2 : 1.f, g,
                                 kind == LAST ? feat : X, kind == LAST ? HID : L, ex, col);
      if (kind == SDF && l + 1 == p.skip) {   // the skip input: [h, PE] / sqrt(2)
        for (int e = tid; e < ROWS * EMB; e += THREADS) PE[(e / EMB) * L + e % EMB] *= INV_SQRT2;
        __syncthreads();
      }
      if constexpr (EXPORT)   // a colour / relight layer's output: the next one's cr slot
        if (kind == COL || kind == REL)
          export_cr<ROWS>(X, ex, kind == COL ? 1 + l : p.n_color + l,
                          (long long)act_layout(sh, PREC).n_cr * CR_SLOT, st.w.buf);
    }
  }

  // relit from gc and delta (NeuS: relit = gc, delta = 0)
  for (int e = tid; e < ROWS * 3; e += THREADS) {
    const float gc = t.GC[e];
    if (p.n_relight == 0) {
      t.RL[e] = gc;
      t.DL[e] = 0.f;
    } else if (p.inv_sigmoid) {
      const float gcc = fminf(fmaxf(gc, 0.f), 1.f);
      const float logit = logf(fmaxf(gcc, 1e-5f) / fmaxf(1.f - gcc, 1e-5f));
      t.RL[e] = sigmoidf_(logit + t.DL[e]);
    } else {
      t.RL[e] = fminf(fmaxf(gc + sigmoidf_(t.DL[e]) - 0.5f, 0.f), 1.f);
    }
  }
  __syncthreads();
}

// The weight ring's barriers (thread 0; a barrier after the caller's
// carve): full counts the one bulk-copy arrival, empty the 8 warps.
__device__ __forceinline__ void init_weight_ring(const Ring& w, int stages) {
  for (int i = 0; i < stages; ++i) {
    mlp::mbar_init(w.full + i, 1);
    mlp::mbar_init(w.empty + i, THREADS / 32);
  }
}

// The forward kernels' shared memory (SMEM_FWD bytes): from the first
// 1024-byte boundary, the weight ring (FWD_STAGES), X of FWD_ROWS points,
// the small buffers and the ring's mbarriers. A barrier after.
__device__ __forceinline__ void carve_fwd(Tile& t, Rings& st, unsigned char* smem) {
  const unsigned mis = unsigned(__cvta_generic_to_shared(smem)) & (SMEM_ALIGN - 1);
  unsigned char* base = smem + ((SMEM_ALIGN - mis) & (SMEM_ALIGN - 1));
  st.w.buf = base;
  t.X = reinterpret_cast<float*>(base + FWD_STAGES * FWD_SPS * WSLAB);
  t.P3 = t.X + FWD_ROWS * LDX_FWD;
  t.D3 = t.P3 + FWD_ROWS * 3;
  t.G3 = t.D3 + FWD_ROWS * 3;
  t.GC = t.G3 + FWD_ROWS * 3;
  t.DL = t.GC + FWD_ROWS * 3;
  t.RL = t.DL + FWD_ROWS * 3;
  t.S1 = t.RL + FWD_ROWS * 3;
  st.w.full = reinterpret_cast<unsigned long long*>(t.S1 + FWD_ROWS);
  st.w.empty = st.w.full + FWD_STAGES;
  st.d = Ring{nullptr, nullptr, nullptr};
  st.ws = st.ds = 0;
  if (threadIdx.x == 0) {
    init_weight_ring(st.w, FWD_STAGES);
    mlp::mbar_init_fence();
  }
  __syncthreads();
}

// The forward kernels' scratch per block, floats: the gates (gates false:
// none, forward_tile's SG) and features of a FWD_ROWS-point tile (PREC_F32:
// then hp_product's stage, fwd_save).
__host__ __device__ inline long long fwd_scratch_floats(int n_sdf, bool gates = true) {
  return (long long)(gates ? n_sdf : 1) * FWD_ROWS * HID +
         (PP_PREC == PREC_F32 ? (long long)HS_FLOATS : 0);
}

// What the forward kernels' tile saves: nothing, but in PREC_F32 Save::dw
// is hp_product's stage, after the features (feat: [FWD_ROWS][HID] of the
// scratch).
__device__ __forceinline__ Save fwd_save(float* feat) {
  return Save{nullptr, nullptr,
              PP_PREC == PREC_F32 ? reinterpret_cast<unsigned char*>(feat + size_t(FWD_ROWS) * HID)
                                  : nullptr};
}

// ------------------------------------------------------------------------
// Backward
// ------------------------------------------------------------------------

// P[c] += sum_r A[r][c] for c < 256: a bias grad over the tile.
__device__ __forceinline__ void bias_accum(const float* A, float* P) {
  const int c = threadIdx.x;   // THREADS == HID
  float s = 0.f;
  for (int r = 0; r < TILE; ++r) s += A[r * LDX + c];
  P[c] += s;
}

// The reverse of a 3-wide output layer (W row-major [3, K] in f32, input
// S(r, k) of row r, column k), operands in bf16, sums in f32: dW += HB^T
// S, db += sum HB, X[:, :K] = HB @ W.
template <class F>
__device__ __forceinline__ void narrow_back_of(const Tile& t, F&& S, const float* __restrict__ W,
                                               int K, float* Pw, float* Pb) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 3 * K; e += THREADS) {
    const int j = e / K, k = e % K;
    float s = 0.f;
    for (int r = 0; r < TILE; ++r)
      s = fmaf(round_bf16(t.HB[r * 3 + j]), round_bf16(S(r, k)), s);
    Pw[e] += s;
  }
  if (tid < 3) {
    float s = 0.f;
    for (int r = 0; r < TILE; ++r) s += t.HB[r * 3 + tid];
    Pb[tid] += s;
  }
  for (int e = tid; e < TILE * K; e += THREADS) {
    const int r = e / K, k = e % K;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s = fmaf(round_bf16(t.HB[r * 3 + j]), round_bf16(__ldg(W + j * K + k)), s);
    t.X[r * LDX + k] = s;
  }
  __syncthreads();
}

// narrow_back with its input S in the scratch ([TILE][LDS]).
__device__ __forceinline__ void narrow_back(const Tile& t, const float* S,
                                            const float* __restrict__ W, int K, float* Pw,
                                            float* Pb) {
  narrow_back_of(t, [=](int r, int k) { return S[r * LDS + k]; }, W, K, Pw, Pb);
}

// DH[r] += the view-dir PE VJP of the cotangents staged in VH[r][:dv].
__device__ __forceinline__ void dirs_pe_vjp(const Tile& t, int dv) {
  const int r = threadIdx.x;
  if (r < TILE) {
    for (int c = 0; c < dv; ++c) {
      int j;
      const float s = mlp::emb_slope(t.D3 + r * 3, c, dv, &j);
      t.DH[r * 3 + j] = fmaf(t.VH[r * EMB + c], s, t.DH[r * 3 + j]);
    }
  }
  __syncthreads();
}

// ---- the weight-grad flush ----
// The flush's stages in order: per block, pair mp of 64-row blocks of its
// K (2 mp and 2 mp + 1), term and tile, each stage one tile's A^T rows of
// the pair and its cotangent. Thread 0 walks them with a cursor,
// DW_STAGES - 1 ahead of the consumers.
struct DwCursor {
  int bi, mp, term, tl;
  int half;   // PREC_F32: the column half (dw_flush)
  DwBlock blk;
};

__device__ __forceinline__ int n_pairs(int K) { return (round64(K) / 64 + 1) / 2; }

__device__ __forceinline__ void cursor_start(const Shape& sh, DwCursor& c, int first) {
  c.bi = first;
  c.mp = c.term = c.tl = c.half = 0;
  c.blk = dw_block(sh, first);
}

// The next slab; false past the last block.
__device__ __forceinline__ bool cursor_next(const Shape& sh, DwCursor& c, int nt) {
  if (++c.tl < nt) return true;
  c.tl = 0;
  if (++c.term < c.blk.nterm) return true;
  c.term = 0;
  if constexpr (PP_PREC == PREC_F32) {
    if (++c.half < 2) return true;
    c.half = 0;
  }
  if (++c.mp < n_pairs(c.blk.K)) return true;
  c.mp = 0;
  if (++c.bi >= dw_n_blocks(sh)) return false;
  c.blk = dw_block(sh, c.bi);
  return true;
}

// The save mode's cr images (act_layout): tile i's at base + i bytes, a
// group's tpg tiles in order. A kernel parameter (the march's), so that
// the flush holds none of it in registers.
struct CrSrc {
  unsigned char* base;
  long long bytes;       // a tile's images
  int tpg;
};

// The images of tile tl of a batch of the block whose first tile is the
// block's n0-th: the block numbers its tiles in its order from 0, and its
// tile n is tile n % tpg of group blockIdx.x + (n / tpg) gridDim.x (every
// group but the last of all has tpg tiles, and that one is its block's
// last).
__device__ __forceinline__ const unsigned char* cr_tile(const CrSrc& c, int n0, int tl) {
  const int n = n0 + tl, g = n / c.tpg;
  return c.base + ((blockIdx.x + (long long)g * gridDim.x) * c.tpg + (n - g * c.tpg)) * c.bytes;
}

// Thread 0: the cursor's stage (global count s), three bulk copies (the
// pair's second A^T block repeats the first where K has an odd count of
// them; its products are not stored; PREC_F32: the cotangent's column half
// only).
__device__ __forceinline__ void dw_issue(Rings& st, const unsigned char* store,
                                         long long tile_bytes, const DwCursor& c, unsigned s) {
  const DwBlock& b = c.blk;
  const int bj = PP_PREC == PREC_F32 ? c.term   // dw_kind: term i's cotangent block i
                                     : (b.nterm == 4 ? c.term / 2 : (b.nterm == 2 ? c.term : 0));
  const unsigned char* base = store + c.tl * tile_bytes + b.base;
  ring_wait_empty<DW_STAGES>(st.d, s);
  unsigned char* stage = st.d.buf + (s % DW_STAGES) * DW_STAGE;
  const unsigned char* a = base + (long long)c.term * round64(b.K) * 128 + 2 * c.mp * DW_A;
  const bool odd = 2 * c.mp + 1 == round64(b.K) / 64;
  mlp::bulk_load(stage, a, DW_A, st.d.full + s % DW_STAGES);
  mlp::bulk_load(stage + DW_A, odd ? a : a + DW_A, DW_A, st.d.full + s % DW_STAGES);
  const unsigned char* cot = base + (long long)b.nterm * round64(b.K) * 128 + (long long)bj * DW_B;
  if constexpr (PP_PREC == PREC_F32)
    mlp::bulk_load(stage + 2 * DW_A, cot + c.half * (DW_B / 2), DW_B / 2,
                   st.d.full + s % DW_STAGES);
  else
    mlp::bulk_load(stage + 2 * DW_A, cot, DW_B, st.d.full + s % DW_STAGES);
}

// dw_issue of the load entry's flush: a colour / relight layer's A^T
// blocks of its first 256 rows come from the tile's cr image in the stash
// (cr, the batch's first tile the block's n0-th); the rest as dw_issue.
__device__ __forceinline__ void dw_issue_load(Rings& st, const unsigned char* store,
                                              long long tile_bytes, const DwCursor& c,
                                              unsigned s, const Shape& sh, const CrSrc& cr,
                                              int n0) {
  const int slot = cr_slot_of(sh, c.bi);
  if (RM_ABLATE == 2 || slot < 0 || 2 * c.mp >= HID / 64) {   // 2 no_unflatten: the stash not read
    dw_issue(st, store, tile_bytes, c, s);
    return;
  }
  const DwBlock& b = c.blk;   // nterm 1: one cotangent block
  ring_wait_empty<DW_STAGES>(st.d, s);
  unsigned char* stage = st.d.buf + (s % DW_STAGES) * DW_STAGE;
  const unsigned char* a = cr_tile(cr, n0, c.tl) + size_t(slot) * CR_SLOT + 2 * c.mp * DW_A;
  mlp::bulk_load(stage, a, DW_A, st.d.full + s % DW_STAGES);   // rows 128 mp .. + 128, in the
  mlp::bulk_load(stage + DW_A, a + DW_A, DW_A, st.d.full + s % DW_STAGES);   // stage's 3 copies
  const unsigned char* cot = store + c.tl * tile_bytes + b.base + (long long)round64(b.K) * 128;
  if constexpr (PP_PREC == PREC_F32)
    mlp::bulk_load(stage + 2 * DW_A, cot + c.half * (DW_B / 2), DW_B / 2,
                   st.d.full + s % DW_STAGES);
  else
    mlp::bulk_load(stage + 2 * DW_A, cot, DW_B, st.d.full + s % DW_STAGES);
}

// P[k + 8 h][8 j + 2 q + c] += acc[4 j + 2 h + c] for j < NJ, h, c < 2
// (a thread's rows k and k + 8 of a flush's accumulators, P its row k; q
// the lane's quad index): lanes q and q ^ 1 swap one row's pair, so that
// each holds four consecutive columns of one row (q even: row k, odd: row
// k + 8; columns 8 j + 4 (q / 2) ..), which one vector reduction adds
// into device memory (red_add4; store: the block's first flush, one
// vector store, the partial not zero-filled): nothing is read back, the
// thread goes on. Each element is added by one thread, in its program
// order (the load entry's in PREC_F32, whose flush takes a row's two
// column halves apart: faster there than bulk_rows, PERF.md §6; one
// read-modify-write after another cost a device-memory latency each,
// PERF.md §5). P's rows 16-byte aligned: the gradient layout's slots and a
// partial's stride are multiples of 4 floats.
template <int NJ>
__device__ __forceinline__ void red_rows(float* P, const float* acc, int q, bool store) {
  const bool odd = q & 1;
  float* d = P + (odd ? 8 * HID + 2 * q - 2 : 2 * q);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float* a = acc + 4 * j;
    const float sx = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
    const float sy = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
    const float4 v = odd ? make_float4(sx, sy, a[2], a[3]) : make_float4(a[0], a[1], sx, sy);
    if (store) st4(d + 8 * j, v);
    else mlp::red_add4(d + 8 * j, v);
  }
}

// P[k][c] += acc's value of row k, column c for the 64 rows k of
// warpgroup wg's block of a flush (P at its first row; rows_left of them
// real, k 16 w + g + 8 h, c 8 j + 2 q + e in the m64n256 layout) as TMA
// bulk reductions from shared memory (store: the block's first flush,
// bulk stores, the partial not zero-filled): nothing is read back into
// the SM. Warp w's 16 rows are staged in round w, in `stage` (16 KB a
// warpgroup, row-major as P: the weight ring, idle in the flush), and one
// thread adds them with one 16 KB bulk reduction, whose reads of the stage
// end before the next round writes (a named barrier a warpgroup). Each
// row is a thread's in every flush, and the block's flush waits for its
// reductions' completion before it ends (dw_flush), so every element's
// adds keep their order. The load entry's full-row flush (f32stash,
// bf16); faster there than red_rows (PERF.md §6).
__device__ __forceinline__ void bulk_rows(float* P, const float* acc, unsigned char* stage,
                                          int rows_left, bool store) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  float* s = reinterpret_cast<float*>(stage + wg * 16 * HID * 4);
  for (int r = 0; r < 4; ++r) {
    if (w == r && 16 * r < rows_left) {
#pragma unroll
      for (int j = 0; j < HID / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(s + (g + 8 * h) * HID + 8 * j + 2 * q) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      mlp::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if (store) mlp::bulk_store(P + size_t(16 * r) * HID, s, 16 * HID * 4);
        else mlp::bulk_reduce_add(P + size_t(16 * r) * HID, s, 16 * HID * 4);
        mlp::bulk_store_wait_read();
      }
      __syncwarp();
    }
    mlp::bar_sync(1 + wg, 128);
  }
}

// LOAD (the load entry, whose partial is not zero-filled: its first flush
// stores the 256-wide layers' weight grads, dw_flush): P[0 .. n) = 0
// outside them, where the rest of the backward adds (the biases, the
// narrow layers, the padding, inv_s's); all of it for a block without a
// tile, which never flushes. No barrier.
__device__ __forceinline__ void zero_outside_flush(const Params& p, float* P, long long n,
                                                   bool all) {
  const Shape sh = shape_of(p);
  const int nb = all ? 0 : dw_n_blocks(sh);
  long long lo = 0;
  for (int bi = 0; bi <= nb; ++bi) {   // dw_kind's order is the layout's
    long long hi = n, next = n;
    if (bi < nb) {
      const DwBlock b = dw_kind(sh, bi);
      hi = p.off[b.slot];
      next = hi + (long long)b.K * HID;
    }
    for (long long e = lo + threadIdx.x; e < hi; e += THREADS) P[e] = 0.f;
    lo = next;
  }
}

// The weight grads of the nt tiles stored from `store` (tile i at store +
// i tile_bytes), summed on chip and added into the block's partial P once:
// per block and pair of 64-row blocks of its K, warpgroup h the product
// [64, 64 nt] x [64 nt, 256] of block 2 mp + h on wgmma (m64n256k16, 128
// accumulators a thread), every term and tile streamed through the flush
// ring in order, then one read-modify-write of those 64 x 256 floats
// (LOAD, the load entry's: none read back, TMA bulk reductions, bulk_rows,
// or in PREC_F32 vector reductions, red_rows; the block's first flush
// stores; its colour / relight inputs from the stash, cr and n0:
// dw_issue_load). The stages lie over X and Y, so the caller has finished
// the tile.
template <int PREC, bool LOAD = false>
__device__ __forceinline__ void dw_flush(const Params& p, Rings& st, const unsigned char* store,
                                         long long tile_bytes, int nt, float* P,
                                         const CrSrc& cr = CrSrc{}, int n0 = 0) {
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const Shape sh = shape_of(p);
  // the batch's global stores reach the bulk copies; X and Y are free
  mlp::fence_proxy_async_global();
  mlp::fence_proxy_async();
  __syncthreads();
  const unsigned d0 = st.ds;
  DwCursor pc;          // thread 0's: the next slab to issue
  bool more = true;     // pc is a slab
  unsigned issued = 0;
  if (tid == 0) {
    cursor_start(sh, pc, 0);
    for (; more && issued + 1 < DW_STAGES; ++issued) {
      if constexpr (LOAD) dw_issue_load(st, store, tile_bytes, pc, d0 + issued, sh, cr, n0);
      else dw_issue(st, store, tile_bytes, pc, d0 + issued);
      more = cursor_next(sh, pc, nt);
    }
  }
  unsigned li = 0;
  const int nb = dw_n_blocks(sh);
  for (int bi = 0; bi < nb; ++bi) {
    const DwBlock blk = dw_block(sh, bi);
    for (int mp = 0; mp < n_pairs(blk.K); ++mp) {
      if constexpr (PREC == PREC_F32) {
        // each column half on its own (m64n128k16, 64 accumulators): the
        // 128 of a whole row left the backward kernels no register for the
        // rest, which they spilled
        for (int half = 0; half < 2; ++half) {
          float acc[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.f;
          for (int term = 0; term < blk.nterm; ++term) {
            for (int tl = 0; tl < nt; ++tl, ++li) {
              const unsigned s = d0 + li;
              if (tid == 0 && more) {
                if constexpr (LOAD)
                  dw_issue_load(st, store, tile_bytes, pc, d0 + issued++, sh, cr, n0);
                else dw_issue(st, store, tile_bytes, pc, d0 + issued++);
                more = cursor_next(sh, pc, nt);
              }
              const unsigned char* stage = ring_acquire<DW_STAGES>(st.d, s, DW_STAGE);
              mlp::wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                mlp::wgmma_m64n128k16_bf16(acc, mlp::wgmma_desc(stage + wg * DW_A + 32 * kk),
                                           mlp::wgmma_desc(stage + 2 * DW_A + 32 * kk),
                                           (term | tl | kk) != 0);
              mlp::wgmma_commit();
              mlp::wgmma_wait_all();
              ring_release<DW_STAGES>(st.d, s);
            }
          }
          float* dst = P + p.off[blk.slot] + 128 * half + 2 * q;
          if constexpr (LOAD) {
            const int k = 64 * (2 * mp + wg) + 16 * w;   // the warp's 16 rows: all or none < K
            mlp::fence_operands(acc);
            if (k < blk.K)
              red_rows<16>(P + p.off[blk.slot] + 128 * half + size_t(k + g) * HID, acc, q, d0 == 0);
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k = 64 * (2 * mp + wg) + 16 * w + g + 8 * h;
                if (k < blk.K) {
                  float* d = dst + size_t(k) * HID + 8 * j;
                  d[0] += acc[4 * j + 2 * h];
                  d[1] += acc[4 * j + 2 * h + 1];
                }
              }
          }
        }
        continue;
      }
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int term = 0; term < blk.nterm; ++term) {
        for (int tl = 0; tl < nt; ++tl, ++li) {
          const unsigned s = d0 + li;
          if (tid == 0 && more) {
            if constexpr (LOAD) dw_issue_load(st, store, tile_bytes, pc, d0 + issued++, sh, cr, n0);
            else dw_issue(st, store, tile_bytes, pc, d0 + issued++);
            more = cursor_next(sh, pc, nt);
          }
          const unsigned char* stage = ring_acquire<DW_STAGES>(st.d, s, DW_STAGE);
          mlp::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mlp::wgmma_m64n256k16_bf16(acc, mlp::wgmma_desc(stage + wg * DW_A + 32 * kk),
                                       mlp::wgmma_desc(stage + 2 * DW_A + 32 * kk),
                                       (term | tl | kk) != 0);
          mlp::wgmma_commit();
          mlp::wgmma_wait_all();
          ring_release<DW_STAGES>(st.d, s);
        }
      }
      float* dst = P + p.off[blk.slot] + 2 * q;
      if constexpr (LOAD) {   // the block's first flush (d0 0) stores: zero_outside_flush
        const int k0 = 64 * (2 * mp + wg);   // the warpgroup's block
        mlp::fence_operands(acc);
        bulk_rows(P + p.off[blk.slot] + size_t(k0) * HID, acc, st.w.buf, blk.K - k0, d0 == 0);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 64 * (2 * mp + wg) + 16 * w + g + 8 * h;
            if (k < blk.K) {
              float* d = dst + size_t(k) * HID + 8 * j;
              d[0] += acc[4 * j + 2 * h];
              d[1] += acc[4 * j + 2 * h + 1];
            }
          }
      }
    }
  }
  if constexpr (LOAD && PREC != PREC_F32)   // bulk_rows' reductions done: their order kept
    if ((threadIdx.x & 31) == 0) mlp::bulk_store_wait();
  st.ds += li;
  __syncthreads();
}

// The f32 part of the block's backward scratch of mode prec, floats:
// [n_sdf - 1] gates, features and [n_sdf - 1] tangent pre-gates as
// [TILE][HID] slabs, then [n_color] colour and [n_relight] relight layer
// inputs as [TILE][LDS] slabs (load, the march's load entry, which reads
// the gates, features and layer inputs from its stash: the tangent
// pre-gates alone); rounded up to 256 floats, the weight-grad store of
// dw_batch tiles (dw_tile_bytes each) after it.
__host__ __device__ inline long long bwd_f32_floats(int n_sdf, int n_color, int n_relight,
                                                    int prec, bool load = false) {
  return ((load ? (n_sdf - 1LL) * GSLAB
                : (2LL * (n_sdf - 1) + 1) * GSLAB + (long long)(n_color + n_relight) * SLAB) +
          255) / 256 * 256;
}

__host__ __device__ inline long long bwd_scratch_floats(const Shape& s, int dw_batch, int prec,
                                                        bool load = false) {
  return bwd_f32_floats(s.n_sdf, s.n_color, s.n_relight, prec, load) +
         dw_batch * dw_tile_bytes(s) / 4;
}

// v0 = scale d emb_c / d x . grad_hat, the tangent seed of row r, column c.
__device__ __forceinline__ float tangent_seed(const Params& p, const Tile& t, int r, int c) {
  float x[3];
  pe_row(p, t, r, x);
  int j;
  const float s = mlp::emb_slope(x, c, p.d0, &j);
  return p.scale * s * t.GH[r * 3 + j];
}

// The pullback of the tile forward_tile<true> has just run, given the
// cotangents of its five outputs in t.CT (the caller's, zeros for a padding
// point; a barrier after): the point and view-dir cotangents to t.PH / t.DH,
// the bias grads and the 3-wide layers' weight grads added into the
// block's partial P, and every 256-wide layer's weight-grad operands
// (inputs and output cotangents, bf16, transposed) into the tile's store
// sv.dw, which dw_flush sums. PREC: the MARCH_BWD_PRECISION mode (the note
// at the top): PREC_BF16 stores the tangent pre-gates zt rounded to bf16;
// PREC_F32 runs the SDF chain's products in hp_product's six passes (the
// stage hp_stage_of(sv)) and stores its weight-grad operands as three
// bf16 parts (save_t3; the layer inputs the recompute or the load stored
// so). LOAD (the march's load entry, after its load_tile): the gates of
// the SDF layers and the colour / relight layer inputs are read from the
// activation stash ts where they are used, in wide batches (the tangent
// stream's gates in a pass after its product, the reverse's in its gate
// pass, each colour / relight input staged in Y, free until the tangent
// stream), instead of from the recompute's scratch (gates, sv.cx, sv.rx).
template <int PREC, bool LOAD = false>
__device__ __forceinline__ void backward_tile(const Params& p, const Tile& t, Rings& st,
                                              float* gates, float* zt, const Save& sv, float* P,
                                              const TileStash& ts = TileStash{}) {
  const int tid = threadIdx.x;
  const float* W = p.w;
  const long long* off = p.off;
  const float inv_scale = 1.f / p.scale;
  const Shape sh = shape_of(p);
  const int bi_col = p.n_sdf, bi_rel = p.n_sdf + p.n_color - 1;

  for (int e = tid; e < TILE * 3; e += THREADS) {
    const int r = e / 3, c = e % 3;
    t.PH[e] = 0.f;
    t.DH[e] = 0.f;
    t.GH[e] = t.CT[r * 16 + 1 + c];
    t.CG[e] = t.CT[r * 16 + 4 + c];
  }
  __syncthreads();

  // ---- relit and the relight net ----
  if (p.n_relight > 0) {
    for (int e = tid; e < TILE * 3; e += THREADS) {
      const int r = e / 3, c = e % 3;
      const float gc = t.GC[e], relit = t.RL[e], rh = t.CT[r * 16 + 7 + c];
      const float dh = t.CT[r * 16 + 10 + c];
      if (p.inv_sigmoid) {
        const float sbar = relit * (1.f - relit) * rh;
        const float dlogit = (gc > 1e-5f ? 1.f / fmaxf(gc, 1e-5f) : 0.f) +
                             (1.f - gc > 1e-5f ? 1.f / fmaxf(1.f - gc, 1e-5f) : 0.f);
        const float inside = (gc > 0.f && gc < 1.f) ? 1.f : 0.f;
        t.CG[e] += sbar * dlogit * inside;
        t.HB[e] = dh + sbar;
      } else {
        const float sd = sigmoidf_(t.DL[e]);
        const float pre = gc + sd - 0.5f;
        const float gate = (pre > 0.f && pre < 1.f) ? 1.f : 0.f;
        t.CG[e] += gate * rh;
        t.HB[e] = dh + gate * rh * sd * (1.f - sd);
      }
    }
    __syncthreads();
    const int last = p.n_relight - 1;
    const int KL = last == p.y_in ? HID + EMB : HID;
    // a layer's input: the recompute's in the scratch; LOAD's staged from
    // the stash into Y (free until the tangent stream)
    const int ld = LOAD ? LDX : LDS;
    const float* rxl = LOAD ? t.Y : sv.rx + last * SLAB;
    if constexpr (LOAD) {
      stage_cr(ts, t, p.n_color + last - 1, t.Y, last == p.y_in);
      narrow_back_of(t, [&](int r, int k) { return t.Y[r * LDX + k]; }, W + off[W_REL + last], KL,
                     P + off[W_REL + last], P + off[B_REL + last]);
    } else {
      narrow_back(t, rxl, W + off[W_REL + last], KL, P + off[W_REL + last],
                  P + off[B_REL + last]);
    }
    for (int e = tid; e < TILE * HID; e += THREADS) {
      const int r = e / HID, c = e % HID;
      if (rxl[r * ld + c] <= 0.f) t.X[r * LDX + c] = 0.f;   // the relu before `last`
      if (last == p.y_in && c < 3) t.CG[r * 3 + c] += t.X[r * LDX + HID + c];
    }
    __syncthreads();
    for (int l = last - 1; l >= 0; --l) {
      const int K = l == 0 ? EMB : (l == p.y_in ? HID + EMB : HID);
      const float* rx = LOAD ? t.Y : sv.rx + l * SLAB;
      if (LOAD && l > 0) stage_cr(ts, t, p.n_color + l - 1, t.Y, false);
      save_t<0>(t.X, HID, dw_b(sh, sv.dw, bi_rel + l, 0));
      bias_accum(t.X, P + off[B_REL + l]);
      auto put = [&](int r, int c, float v) {
        if (l == 0) {   // [pts, grad, PE(dirs)]
          if (c < 3) t.PH[r * 3 + c] += v;
          else if (c < 6) t.GH[r * 3 + c - 3] += v;
          else t.VH[r * EMB + c - 6] = v;
        } else if (c < HID) {
          t.X[r * LDX + c] = rx[r * ld + c] > 0.f ? v : 0.f;
        } else if (c < HID + 3) {   // the y_in layer's gc lanes
          t.CG[r * 3 + c - HID] += v;
        }
      };
      reverse_product<false>(st, K, t.X, t.X, image(p, WT_REL + l), put, put);
    }
    dirs_pe_vjp(t, p.rl_dv);
  } else {
    for (int e = tid; e < TILE * 3; e += THREADS)   // relit aliases gc for NeuS
      t.CG[e] += t.CT[(e / 3) * 16 + 7 + e % 3];
    __syncthreads();
  }

  // ---- the colour net ----
  for (int e = tid; e < TILE * 3; e += THREADS) {
    const float gc = t.GC[e];
    t.HB[e] = p.squeeze ? gc * (1.f - gc) * t.CG[e] : t.CG[e];
  }
  __syncthreads();
  {
    const int last = p.n_color - 1;
    const int ld = LOAD ? LDX : LDS;   // as the relight net's
    const float* cxl = LOAD ? t.Y : sv.cx + last * SLAB;
    if constexpr (LOAD) {
      stage_cr(ts, t, last, t.Y, false);
      narrow_back_of(t, [&](int r, int k) { return t.Y[r * LDX + k]; }, W + off[W_COL + last],
                     HID, P + off[W_COL + last], P + off[B_COL + last]);
    } else {
      narrow_back(t, cxl, W + off[W_COL + last], HID, P + off[W_COL + last],
                  P + off[B_COL + last]);
    }
    for (int e = tid; e < TILE * HID; e += THREADS) {
      const int r = e / HID, c = e % HID;
      if (cxl[r * ld + c] <= 0.f) t.X[r * LDX + c] = 0.f;
    }
    __syncthreads();
    for (int l = last - 1; l >= 0; --l) {
      const int K = l == 0 ? HID + EMB : HID;
      const float* cx = LOAD ? t.Y : sv.cx + l * SLAB;
      if (LOAD && l > 0) stage_cr(ts, t, l, t.Y, false);
      save_t<0>(t.X, HID, dw_b(sh, sv.dw, bi_col + l, 0));
      bias_accum(t.X, P + off[B_COL + l]);
      auto put = [&](int r, int c, float v) {
        if (l > 0) {
          t.X[r * LDX + c] = cx[r * ld + c] > 0.f ? v : 0.f;
        } else if (c < HID) {   // [features | pts, grad, PE(dirs)]
          t.X[r * LDX + c] = v;
        } else if (c < HID + 3) {
          t.PH[r * 3 + c - HID] += v;
        } else if (c < HID + 6) {
          t.GH[r * 3 + c - HID - 3] += v;
        } else {
          t.VH[r * EMB + c - HID - 6] = v;
        }
      };
      reverse_product<false>(st, K, t.X, t.X, image(p, WT_COL + l), put, put);
    }
    if (p.color_dv > 0) dirs_pe_vjp(t, p.color_dv);
  }
  // X[:, :256] = feat_hat

  // ---- SDF tangent stream along grad_hat: Y = v0 = scale d emb/d x . grad_hat ----
  for (int e = tid; e < TILE * EMB; e += THREADS) {
    const int r = e / EMB, c = e % EMB;
    t.Y[r * LDX + c] = tangent_seed(p, t, r, c);
  }
  __syncthreads();
  for (int l = 0; l < p.n_sdf - 1; ++l) {
    const int K = sdf_k(p, l);
    const bool pre_skip = l + 1 == p.skip;
    if constexpr (PREC == PREC_F32) {
      save_t3<false>(t.Y, K, dw_a(sh, sv.dw, l, 6));   // U: the tangent stream's (dw_kind)
    } else {
      // layer 0's U as a hi + lo bf16 pair (dw_kind)
      save_t<0>(t.Y, K, dw_a(sh, sv.dw, l, l == 0 ? 2 : 1));
      if (l == 0) save_t<1>(t.Y, K, dw_a(sh, sv.dw, 0, 3));
    }
    const float* g = gates + l * GSLAB;
    float* z = zt + l * GSLAB;
    auto put = [&](int r, int c, float acc) {
      z[r * HID + c] = PREC == PREC_BF16 ? round_bf16(acc) : acc;   // JAX's Zs store
      if constexpr (LOAD) {   // the gate after the product, read from the stash
        t.Y[r * LDX + c] = acc;
      } else {
        const float v = g[r * HID + c] * acc;
        t.Y[r * LDX + c] = pre_skip ? v * INV_SQRT2 : v;
      }
    };
    if constexpr (PREC == PREC_F32)
      forward_product<true>(st, K, t.Y, image(p, W_SDF + l), put, hp_stage_of(sv));
    else
      forward_product(st, K, t.Y, image(p, W_SDF + l), put);
    if constexpr (LOAD) {
      stash_rows<16>([&](int r, int c) { return stash_sx4<PREC>(ts, l, r, c); },
                     [&](int r, int c, float4 x) {
                       const float4 g = stash_gate4<PREC>(x, pre_skip);
                       float* y = t.Y + r * LDX + c;
                       const float s = pre_skip ? INV_SQRT2 : 1.f;
                       const float4 v = make_float4(g.x * y[0], g.y * y[1], g.z * y[2], g.w * y[3]);
                       st4(y, pre_skip ? make_float4(v.x * s, v.y * s, v.z * s, v.w * s) : v);
                     });
      __syncthreads();
    }
    if (pre_skip) {
      for (int e = tid; e < TILE * EMB; e += THREADS) {
        const int r = e / EMB, c = e % EMB;
        t.Y[r * LDX + HID + c] = tangent_seed(p, t, r, c) * INV_SQRT2;
      }
      __syncthreads();
    }
  }

  // ---- the last SDF layer: ybar = [sdf_hat / scale, feat_hat], tangent
  // cotangent e0 / scale, uL = Y[:, :256] ----
  {
    const int L1 = p.n_sdf - 1;
    // its input, in bf16, from the store (the recompute saved it; in
    // PREC_F32 its three parts, whose sum is the f32 input)
    const unsigned char* sx = dw_a(sh, sv.dw, L1, 0);
    {
      // the sdf row: bf16 products (f32 in PREC_F32), and the rank-1
      // tangent term in f32
      const int k = tid;   // THREADS == HID
      float s = 0.f, u = 0.f;
      for (int r = 0; r < TILE; ++r) {
        if constexpr (PREC == PREC_F32) {
          float x = 0.f;
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            const unsigned bits = *reinterpret_cast<const unsigned short*>(   // blocks 0, 2, 4
                sx + size_t(2 * part) * HID * 128 + mlp::sw128_offset(k, r));
            x += __uint_as_float(bits << 16);
          }
          s = fmaf(t.CT[r * 16] * inv_scale, x, s);
        } else {
          const unsigned bits =
              *reinterpret_cast<const unsigned short*>(sx + mlp::sw128_offset(k, r));
          s = fmaf(round_bf16(t.CT[r * 16] * inv_scale), __uint_as_float(bits << 16), s);
        }
        u += t.Y[r * LDX + k];
      }
      P[off[W_LAST] + k] += s + inv_scale * u;
      if (tid == 0) {
        float sb = 0.f;
        for (int r = 0; r < TILE; ++r) sb += t.CT[r * 16] * inv_scale;
        P[off[B_LAST]] += sb;
      }
    }
    if constexpr (PREC == PREC_F32)
      save_t3<true>(t.X, HID, dw_b(sh, sv.dw, L1, 0));
    else
      save_t<0>(t.X, HID, dw_b(sh, sv.dw, L1, 0));
    bias_accum(t.X, P + off[B_FEAT]);
    const float* wl = W + off[W_LAST];
    // the tangent cotangent: JAX's bf16 weight row times 1/scale cast to
    // bf16, rounded to bf16 (PREC_F32: its f32 row times 1/scale, in f32)
    const float inv_scale_bf = sdf_operand<PREC>(inv_scale);
    auto put = [&](int r, int c, float v) {
      const float w = sdf_operand<PREC>(wl[c]);
      t.X[r * LDX + c] = fmaf(sdf_operand<PREC>(t.CT[r * 16] * inv_scale), w, v);
      t.Y[r * LDX + c] = sdf_operand<PREC>(w * inv_scale_bf);
    };
    if constexpr (PREC == PREC_F32)
      reverse_product<false, true>(st, HID, t.X, t.X, image(p, WT_FEAT), put, put,
                                   hp_stage_of(sv));
    else
      reverse_product<false>(st, HID, t.X, t.X, image(p, WT_FEAT), put, put);
  }

  // ---- value and tangent reversed together ----
  for (int e = tid; e < TILE * EMB; e += THREADS) {
    t.EG[e] = 0.f;
    t.VH[e] = 0.f;
  }
  for (int l = p.n_sdf - 2; l >= 0; --l) {
    const int K = sdf_k(p, l);
    const bool is_skip = l == p.skip;
    const float* g = gates + l * GSLAB;
    const float* z = zt + l * GSLAB;
    __syncthreads();
    if constexpr (LOAD) {   // the gates from the stash, z from the scratch, in batches
      constexpr int NB = 8, STEP = THREADS / (HID / 4);
      const int c = 4 * (tid % (HID / 4)), r0 = tid / (HID / 4);
#pragma unroll 1
      for (int m = 0; m < TILE / STEP; m += NB) {
        float4 sx[NB], zz[NB];
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int r = r0 + STEP * (m + u);
          sx[u] = stash_sx4<PREC>(ts, l, r, c);
          zz[u] = ld4(z + r * HID + c);
        }
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int r = r0 + STEP * (m + u);
          const float4 g4 = stash_gate4<PREC>(sx[u], l + 1 == p.skip);
          const float gg[4] = {g4.x, g4.y, g4.z, g4.w}, zv[4] = {zz[u].x, zz[u].y, zz[u].z, zz[u].w};
          float* x = t.X + r * LDX + c;
          float* y = t.Y + r * LDX + c;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float hb = x[i], ub = y[i];
            x[i] = gg[i] * hb + (ub * zv[i]) * (100.f * gg[i] * (1.f - gg[i]));
            y[i] = gg[i] * ub;
          }
        }
      }
    } else {
      for (int e = tid; e < TILE * HID; e += THREADS) {
        const int r = e / HID, c = e % HID;
        const float gg = g[e], hb = t.X[r * LDX + c], ub = t.Y[r * LDX + c];
        t.X[r * LDX + c] = gg * hb + (ub * z[e]) * (100.f * gg * (1.f - gg));
        t.Y[r * LDX + c] = gg * ub;
      }
    }
    __syncthreads();
    // abar and zbar: the weight grad's cotangents (dw_kind's terms; in
    // PREC_F32 three parts each)
    if constexpr (PREC == PREC_F32) {
      save_t3<true>(t.X, HID, dw_b(sh, sv.dw, l, 0));
      save_t3<true>(t.Y, HID, dw_b(sh, sv.dw, l, 6));
    } else {
      save_t<0>(t.X, HID, dw_b(sh, sv.dw, l, 0));
      save_t<0>(t.Y, HID, dw_b(sh, sv.dw, l, 1));
    }
    bias_accum(t.X, P + off[B_SDF + l]);
    // hbar and ubar of layer l's input: the hidden part stays in X / Y, the
    // PE part (the skip layer's last 48 columns, or all of layer 0's) adds
    // to emb_hat / v0_hat
    auto value = [&](int r, int c, float v) {
      if (l == 0) t.EG[r * EMB + c] += v;
      else if (c < HID) t.X[r * LDX + c] = is_skip ? v * INV_SQRT2 : v;
      else t.EG[r * EMB + c - HID] += v * INV_SQRT2;
    };
    auto tangent = [&](int r, int c, float v) {
      if (l == 0) t.VH[r * EMB + c] += v;
      else if (c < HID) t.Y[r * LDX + c] = is_skip ? v * INV_SQRT2 : v;
      else t.VH[r * EMB + c - HID] += v * INV_SQRT2;
    };
    if constexpr (PREC == PREC_F32) {
      reverse_product<true, true>(st, K, t.X, t.Y, image(p, WT_SDF + l), value, tangent,
                                  hp_stage_of(sv));
    } else {
      reverse_product<true>(st, K, t.X, t.Y, image(p, WT_SDF + l), value, tangent);
    }
  }

  // ---- PE pullback, first and second derivative ----
  if (tid < TILE) {
    float x[3];
    pe_row(p, t, tid, x);
    float* ph = t.PH + tid * 3;
    const float* gh = t.GH + tid * 3;
    for (int c = 0; c < p.d0; ++c) {
      int j;
      const float s = mlp::emb_slope(x, c, p.d0, &j);
      const float k2 = mlp::emb_curvature(x, c, p.d0);
      ph[j] = fmaf(t.EG[tid * EMB + c] * p.scale, s, ph[j]);
      ph[j] = fmaf(t.VH[tid * EMB + c] * p.scale * p.scale * gh[j], k2, ph[j]);
    }
  }
  __syncthreads();
}

// The backward's shared memory (SMEM_BWD bytes): from the first 1024-byte
// boundary, the weight ring, X and Y (the flush ring over them), then the
// forward's small buffers and the backward's, and the rings' mbarriers.
// Thread 0 initialises the barriers; a barrier after.
__device__ __forceinline__ void carve_bwd(Tile& t, Rings& st, unsigned char* smem) {
  const unsigned mis = unsigned(__cvta_generic_to_shared(smem)) & (SMEM_ALIGN - 1);
  unsigned char* base = smem + ((SMEM_ALIGN - mis) & (SMEM_ALIGN - 1));
  st.w.buf = base;
  t.X = reinterpret_cast<float*>(base + WSTAGES * WSLAB);
  st.d.buf = reinterpret_cast<unsigned char*>(t.X);
  t.Y = t.X + TILE * LDX;
  t.EG = t.Y + TILE * LDX;
  t.VH = t.EG + TILE * EMB;
  t.CT = t.VH + TILE * EMB;
  t.P3 = t.CT + TILE * 16;
  t.D3 = t.P3 + TILE * 3;
  t.G3 = t.D3 + TILE * 3;
  t.GC = t.G3 + TILE * 3;
  t.DL = t.GC + TILE * 3;
  t.RL = t.DL + TILE * 3;
  t.PH = t.RL + TILE * 3;
  t.DH = t.PH + TILE * 3;
  t.GH = t.DH + TILE * 3;
  t.CG = t.GH + TILE * 3;
  t.HB = t.CG + TILE * 3;
  t.S1 = t.HB + TILE * 3;
  st.w.full = reinterpret_cast<unsigned long long*>(t.S1 + TILE);
  st.w.empty = st.w.full + WSTAGES;
  st.d.full = st.w.empty + WSTAGES;
  st.d.empty = st.d.full + DW_STAGES;
  st.ws = st.ds = 0;
  if (threadIdx.x == 0) {
    init_weight_ring(st.w, WSTAGES);
    for (int i = 0; i < DW_STAGES; ++i) {
      mlp::mbar_init(st.d.full + i, 3);   // three copies a stage
      mlp::mbar_init(st.d.empty + i, THREADS / 32);
    }
    mlp::mbar_init_fence();
  }
  __syncthreads();
}

// Where the backward keeps its per-block scratch (bwd_scratch_floats floats
// from `base`): the gates, features and tangent pre-gates, the colour and
// relight layer inputs in f32, then the weight-grad store. LOAD (the
// march's load entry): the tangent pre-gates, then the store; the other
// slots, which it does not use, point at the scratch's start.
struct BwdScratch {
  float* gates;
  float* feat;
  float* zt;
  float* cx;
  float* rx;
  unsigned char* store;   // dw_batch tiles of dw_tile_bytes
};

template <int PREC, bool LOAD = false>
__device__ __forceinline__ BwdScratch carve_bwd_scratch(const Params& p, float* base) {
  BwdScratch s;
  if constexpr (LOAD) {
    s.gates = s.feat = s.zt = s.cx = s.rx = base;
  } else {
    s.gates = base;
    s.feat = s.gates + size_t(p.n_sdf - 1) * GSLAB;
    s.zt = s.feat + GSLAB;
    s.cx = s.zt + size_t(p.n_sdf - 1) * GSLAB;
    s.rx = s.cx + size_t(p.n_color) * SLAB;
  }
  s.store = reinterpret_cast<unsigned char*>(base + bwd_f32_floats(p.n_sdf, p.n_color,
                                                                    p.n_relight, PREC, LOAD));
  return s;
}

// The batch bookkeeping of a block's backward: call after each tile's
// backward_tile (and after the caller has read the tile's outputs); slot
// is the tile's index in the batch. Flushes when the batch is full or the
// block's last tile is done (a ragged batch), and returns the next slot.
// LOAD: cr and n0, where the flush finds the batch's cr images.
template <int PREC, bool LOAD = false>
__device__ __forceinline__ int after_tile(const Params& p, Rings& st, const BwdScratch& s,
                                          int slot, bool last, float* P,
                                          const CrSrc& cr = CrSrc{}, int n0 = 0) {
  if (++slot < p.dw_batch && !last) return slot;
  dw_flush<PREC, LOAD>(p, st, s.store, dw_tile_bytes(shape_of(p)), slot, P, cr, n0);
  return 0;
}

__device__ __forceinline__ Save bwd_save(const Params& p, const BwdScratch& s, int slot) {
  return Save{s.cx, s.rx, s.store + slot * dw_tile_bytes(shape_of(p))};
}

template <class K>
cudaError_t max_blocks(K kernel, size_t smem, int* n_blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e == cudaSuccess) *n_blocks = sms * (per_sm > 0 ? per_sm : 1);
  return e;
}

Params make_params(const float* pts, const float* dirs, const float* w, const void* wimg,
                   long long n_pts, int n_sdf, int skip, int d0, float scale, int n_color,
                   int color_dv, int squeeze, int n_relight, int rl_dv, int y_in, int inv_sigmoid,
                   const long long* off, const long long* ioff) {
  Params p{};
  p.pts = pts;
  p.dirs = dirs;
  p.w = w;
  p.wimg = static_cast<const unsigned char*>(wimg);
  p.n_pts = n_pts;
  p.n_sdf = n_sdf;
  p.skip = skip;
  p.d0 = d0;
  p.scale = scale;
  p.n_color = n_color;
  p.color_dv = color_dv;
  p.squeeze = squeeze;
  p.n_relight = n_relight;
  p.rl_dv = rl_dv;
  p.y_in = y_in;
  p.inv_sigmoid = inv_sigmoid;
  for (int i = 0; i < N_OFF; ++i) {
    p.off[i] = off[i];
    p.ioff[i] = ioff[i];
  }
  return p;
}

bool bad_shape(int n_off, int n_sdf, int n_color, int n_relight) {
  return n_off != N_OFF || n_sdf < 2 || n_sdf - 1 > MAXL || n_color < 2 || n_color > MAXL ||
         n_relight > MAXL;
}

}  // namespace
