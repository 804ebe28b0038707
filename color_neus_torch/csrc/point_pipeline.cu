// Per-point pipeline, forward and backward: the Hopper counterparts of the
// TPU kernels color_neus_tpu/ops/pallas/point_pipeline.py::_fwd_kernel
// (its body is _mlp_forward, point_pipeline.py:568-674; launched by
// fused_point_pipeline_fwd, :699-713) and ::_bwd_kernel (:767; its body is
// _mlp_recompute + _mlp_pullback, :816-1338; custom_vjp _pipeline_core).
//
// What the forward computes, per point (pts p, view dir d), with every
// product in the TPU kernels' production arithmetic (bf16 operands, f32
// sums; point_pipeline_tile.cuh's note) and the rest in f32:
//   SDF forward   emb = PE(p * scale); softplus(beta=100) MLP with the skip
//                 input concat[h, emb]/sqrt(2); the last layer gives the raw
//                 sdf (column 0) and the 256 features (columns 1..256);
//                 sdf = raw / scale (times 1/scale, as the TPU kernel).
//   reverse sweep grad = d sdf / d p: the last layer's pullback is its weight
//                 row 0; every hidden layer's is (p * gate) @ W^T with the
//                 softplus gate g = 1 - exp(-100 softplus(a)) kept in f32
//                 (a bf16 gate breaks the 100 g (1 - g) factor); the skip
//                 layer splits p into the hidden part and the PE part, both
//                 times 1/sqrt(2); the PE pullback sums d emb / d p.
//   colour        [pts, grad, PE(d) (idr only), features] -> relu MLP ->
//                 sigmoid (squeeze_out): gc.
//   relight       (Color-NeuS) [pts, PE(d), grad] -> relu MLP with gc
//                 concatenated at layer y_in -> delta; relit =
//                 sigmoid(logit(clip(gc, 0, 1)) + delta) with the 1e-5
//                 clamps of the logit (inv_sigmoid), else
//                 clip(gc + sigmoid(delta) - 0.5, 0, 1). NeuS: relit = gc,
//                 delta = 0.
// Output per point: [sdf, grad(3), gc(3), relit(3), delta(3), 0, 0, 0].
//
// What the backward computes, per point, given the cotangents of those five
// outputs (gbar [n, 16] in the same lanes), in the same arithmetic:
//   recompute     the forward above, keeping every layer's input, the SDF
//                 gates and the features in the block's scratch;
//   relight       the relit VJP (logit with its clamps and the 0 < gc < 1
//                 mask, or the clip gate), then each layer: dW += x^T hbar,
//                 db += sum hbar, xbar = hbar W^T with the relu masks read
//                 from the stored inputs; the y_in layer hands its gc lanes
//                 to gc's cotangent; layer 0 gives pts, grad and the
//                 view-dir PE cotangents. NeuS: gc_tot = gc_hat + relit_hat.
//   colour        the squeeze sigmoid, the relu chain; layer 0 splits into
//                 the 256 features, pts, grad and the view-dir PE (idr).
//   SDF, second   <grad, grad_hat> is 1/scale times the derivative of the raw
//   order         sdf along grad_hat: one forward tangent stream v from
//                 v0 = scale * d emb/d x . grad_hat, z_l = v W_l,
//                 v = g_l z_l (skip: [v, v0]/sqrt(2)); the last layer's
//                 tangent cotangent is e0/scale (a rank-1 column-0 update of
//                 its weight grad; its ubar is a broadcast weight row); then
//                 value and tangent reversed together: abar = g hbar +
//                 (ubar z) 100 g (1 - g), zbar = g ubar, dW += X^T abar +
//                 U^T zbar, db += sum abar, hbar = abar W^T, ubar = zbar W^T,
//                 the skip split into hidden and PE parts times 1/sqrt(2).
//   PE pullback   pts_hat += scale * emb_hat . d emb/d x, plus the PE second
//                 derivative scale^2 * v0_hat . d2 emb/d x2 * grad_hat; the
//                 view-dir PE VJPs to dirs_hat.
// Outputs: pts_hat [n, 3], dirs_hat [n, 3], and per block a weight-grad
// partial in the packed layout (the gradient prefix of the weight buffer,
// the same offset table), which a second kernel sums over the blocks in
// index order: deterministic, no float atomics.
//
// Bound on the H100. Forward: at the Color-NeuS widths ~1.45 M MACs per
// point (SDF forward ~0.52 M, reverse ~0.46 M, colour ~0.26 M, relight
// ~0.21 M; chip_smoke.py counts them from the real widths) against 88 bytes
// of input/output per point: bound by operations, bf16 tensor-core MMA at
// 989 TFLOP/s. Backward: the recompute, then twice the colour and relight
// MACs (dW and xbar), the tangent stream (~0.46 M), the last layer (~0.13
// M) and four products per hidden SDF layer (~1.83 M), plus layer 0's
// second (lo) weight-grad pass: ~4.8 M MACs per point, against 112 bytes
// of input/output per point: bound by operations. What it keeps in device
// memory on the way (the gates and tangent pre-gates in f32, ~16 KB a
// point written and read, and the weight-grad operands in bf16, ~25 KB a
// point written and read two to five times) is the floor once the products
// stop dominating: ~7-10 GB at 131,072 points.
//
// Design. A block of 8 warps (two warpgroups) loops over tiles of points,
// so every scratch is sized by the grid, not by N: 128-point tiles in the
// forward kernels (rows 5 and 3), 64-point tiles in the backward kernels.
//   Forward (row 5, and the backward's recompute), forward_tile on Hopper's
//   wgmma and bulk copies. Its mma.sync predecessor (B read from L2 one
//   8-byte fragment per lane, 64 points a tile, ~2.8 MB of weights streamed
//   a tile) lost its time, by probe copies on the card (PERF.md §6), to the
//   synchronous products and their operand loads (~45%), the reverse
//   sweep's epilogue loads of the f32 gates (~20%), the softplus epilogue
//   (~17%, three quarters of it the IEEE divide) and the gate stores
//   (~8%); the weight stream itself did not set the pace. Now:
//   1. every 256-wide product runs on wgmma (m64nNk16, bf16 in, f32
//      accumulators in registers) with B from shared memory: the wrapper
//      packs each layer once per weights as its forward image (rows the
//      256 outputs, depth K) and its reverse image (rows the K inputs,
//      depth 256), 64-row x 64-k bf16 slabs, K-major with the 128-byte
//      swizzle (point_pipeline.py _pack_images), and thread 0 bulk-copies
//      them on mbarriers into a ring ahead of the products (wg_product):
//      in the forward kernels 3 stages of two consecutive slabs of a chunk
//      (16 KB: half the waits a product makes), in the recompute the
//      backward's 4 x 8 KB. A comes from registers: load_a's fragments of
//      the f32 activations, rounded to bf16 as they load (JAX's f32stash:
//      the stores stay f32), loaded before a barrier;
//   2. a forward block owns 128 points: its two warpgroups take 64 rows
//      each and all columns of every slab (wg_product's DUAL form, as the
//      backward's value and tangent streams share a slab), so each weight
//      slab is read from L2 once per 128 points, half the parent's bytes
//      per point; the recompute keeps the backward's 64-point tile (the
//      two warpgroups split each slab's columns), so the tile's rows are
//      a template parameter;
//   3. the products' f32 outputs are staged into X (their A is in
//      registers) and every epilogue is a SIMT pass over X that batches
//      its loads (forward_pass: bias, softplus and gate or relu;
//      reverse_pass: the skip scale and the next layer's gates, which
//      thread 0 asks into L2 while the product runs): an epilogue on the
//      accumulators, one dependent chain at a time on one block of 8
//      warps, cost more than the products (PERF.md §6); the gate and
//      feature stores to the block's device-memory scratch (8 KB of f32
//      gates a point, beyond shared memory; a bf16 gate breaks the 100 g
//      (1 - g) factor) are coalesced 16-byte stores; softplus100's log term
//      is scaled by a multiply (the IEEE divide's range check and slow
//      path gone, as in rows 1-2).
//   The 1- and 3-wide output layers stay SIMT FMAs with their operands
//   rounded to bf16, four rows a warp at a time. Budgets: shared memory
//   219,696 of 232,448 bytes (the ring 48 KB, X f32 [128][312] 160 KB, its
//   row stride padded so that load_a's reads hit 32 banks a half-warp, the
//   small buffers; the PE cotangents live in X's PE columns), one block of
//   8 warps per SM; registers: A's 12-76 packed registers plus a chunk's
//   32 accumulators under the 255 of one block per SM (chip_smoke.py phase
//   1 prints them, the spills and the blocks).
//   Backward (row 6; row 4 runs the same tile functions), on Hopper's
//   wgmma and bulk copies. The parent design (mma.sync from L2) lost its
//   time to four causes (PERF.md §6, the backward's step-0 split); what this one does
//   about each:
//   1. The weight grads made a device-memory round trip per tile (a
//      read-modify-write of the 4.2 MB gradient prefix, 42% of the time).
//      Now a tile's weight-grad operands go to a per-block store in bf16,
//      transposed so that the tile's 64 points are wgmma's K-major depth:
//      every 256-wide layer's input X^T ([K][64], written by the recompute)
//      and its output cotangents abar^T (and the tangent stream's U^T and
//      zbar^T: [256][64]). The operands are the ones the products rounded
//      to bf16 before, so the sums are over the same bf16 values; layer 0's
//      f32 PE and tangent seed go in as hi + lo bf16 pairs. After every
//      dw_batch tiles (8; fewer when the block has fewer), and after the
//      block's last, ragged batch, dw_flush runs each layer's weight grad
//      as one product of depth 64 x batch on wgmma (m64n256k16, f32
//      accumulators in registers, warpgroup h a 64-row block of K, both
//      operands bulk-copied from the store through a 3-stage ring of 48 KB
//      laid over X and Y) and adds it into the block's f32 partial once:
//      the round trip falls by the batch factor. No float atomics: the
//      partials are summed over the blocks in index order by
//      point_pipeline_reduce_kernel, and two identical calls are bitwise
//      equal. Bias sums stay per tile on the f32 values in shared memory;
//      the relu masks and the 3-wide layers read the f32 colour / relight
//      inputs.
//   2. B came from L2, one 8-byte fragment per lane, at one block per SM.
//      Now every 256-wide product of the backward (the relight, colour and
//      feature reverse products, the tangent stream, the SDF value and
//      tangent reverse products) runs on wgmma with B from shared memory:
//      the wrapper packs each weight block once per call, on the card, as
//      64-row x 64-k bf16 slabs in the K-major 128-byte-swizzled layout
//      (point_pipeline.py _pack_images), and thread 0 bulk-copies them into
//      a 4-stage ring (8 KB slabs) three slabs ahead of the products. A is
//      fed from registers (mma.m16n8k16's fragment, which wgmma's register
//      A shares): every thread loads its fragments of the f32 activations,
//      rounded to bf16, before a barrier, so the products' epilogues may
//      overwrite their input in place and no bf16 staging copy of A is
//      needed (the ring's 32 KB is what the shared memory has left). The
//      dW operands are K-major as stored, so no transpose bit is used. No
//      wgmma sits in a branch that depends on the thread: the warpgroups
//      split the columns by descriptor offsets, and every device function
//      of the backward is inlined (ptxas C7510 serialises wgmma across a
//      call).
//   3. Products and SIMT work took turns. The SDF reverse sweep's value
//      and tangent products share each weight slab: warpgroup 0 computes
//      the value stream's, warpgroup 1 the tangent's (m64n64 / m64n48 per
//      chunk), so the two run side by side; in the one-stream products the
//      two warpgroups take the two halves of each chunk (m64n32 / m64n24).
//      The next slabs' bulk copies overlap the current products, the
//      flush's run two stages ahead. The epilogues (gates, masks, bias
//      sums) are the parent's SIMT passes; they do not overlap the products
//      of the same tile (the next product depends on them).
//   4. Every layer input went to the scratch in f32 (~3.1 MB a tile): now
//      only the gates, tangent pre-gates and colour / relight inputs do;
//      the SDF layer and tangent inputs go as bf16 operands only.
//   Budgets: shared memory 228,944 of 232,448 bytes: the weight ring (32
//   KB) + X and Y (f32 [64][308], 77 KB each; the flush's stages lie over
//   them) + the PE cotangents, the gbar tile and the small buffers; the
//   tangent seed is recomputed where the skip layer needs it again instead
//   of being kept. Registers: the 64-76 packed A registers plus 16-32
//   accumulators of a product, 128 accumulators in the flush, under the 255
//   of one block per SM; 0 spills (chip_smoke.py phase 1; the chunk loop
//   stays rolled for it). The recompute (forward_tile<TILE, true>) runs the
//   forward's wgmma products through the same weight ring.

//
// MARCH_BWD_PRECISION (point_pipeline_tile.cuh's note): this file builds
// once per mode, the mode PP_PREC a template argument of the tile
// functions, its kernels suffixed (_bf16s, _f32s). bf16 is f32stash's
// design with bf16 stores. f32 runs the SDF chain's ~3.4 M backward (~1
// M forward) MACs a point in f32 as JAX's Precision.HIGHEST does: six bf16
// passes on wgmma (hp_product), each operand split into hi, mid and lo
// bf16 parts, A's in registers one k16 step at a time (its three parts of
// a whole K would not fit beside the accumulators), B's from weight images
// with one slab a k16 step (the step's three parts side by side) through
// the same ring; each step's passes sum into a fresh accumulator added
// into an f32 total, since the tensor cores truncate where they add; the
// outputs are staged in the tile's weight-grad slot (L2) until A is read
// for the last chunk, then put. Its weight grads take the f32stash route
// (the bf16 store and the flush) with every operand in three parts and six
// terms a stream, a part stored once for each term that reads it. Bound:
// the six passes at 989 TFLOP/s (rows 6 / 4 ~5.8 ms at 131,072 points; the
// SIMT design before it was bound at ~13.7 by the FP32 pipe). What it
// costs beyond f32stash: A split again per output chunk, a wait per k16
// step, the stage's L2 round trip, 4/3 of the bytes a step streams, and a
// weight-grad store ~4.6 times f32stash's (~7 MB a tile): PERF.md §6.

#include "point_pipeline_tile.cuh"

namespace {

// t.P3 / t.D3 = the points and view dirs base .. base + ROWS (zeros past
// n_pts).
template <int ROWS>
__device__ __forceinline__ void load_points(const Params& p, const Tile& t, long long base) {
  const int tid = threadIdx.x;
  if (tid < ROWS) {
    const long long i = base + tid;
    const bool ok = i < p.n_pts;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      t.P3[tid * 3 + j] = ok ? p.pts[3 * i + j] : 0.f;
      t.D3[tid * 3 + j] = ok ? p.dirs[3 * i + j] : 0.f;
    }
  }
  __syncthreads();
}

// The library's MARCH_BWD_PRECISION mode is PP_PREC (point_pipeline_tile.cuh);
// its kernels carry the mode's suffix (PP_NAME).
__global__ void __launch_bounds__(THREADS, 1) PP_NAME(point_pipeline_fwd_kernel)(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile t;
  Rings st;
  carve_fwd(t, st, smem);
  const int tid = threadIdx.x;
  float* gates = p.scratch + size_t(blockIdx.x) * fwd_scratch_floats(p.n_sdf);
  float* feat = gates + size_t(p.n_sdf - 1) * FWD_ROWS * HID;   // [FWD_ROWS][HID]
  const long long n_tiles = (p.n_pts + FWD_ROWS - 1) / FWD_ROWS;
  const Save none = fwd_save(feat);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * FWD_ROWS;
    load_points<FWD_ROWS>(p, t, base);
    forward_tile<FWD_ROWS, false, false, PP_PREC>(p, t, st, gates, feat, none);
    // ---- store [sdf, grad, gc, relit, delta, 0, 0, 0] ----
    for (int e = tid; e < FWD_ROWS * 16; e += THREADS) {
      const int r = e / 16, c = e % 16;
      const long long i = base + r;
      if (i >= p.n_pts) continue;
      float v = 0.f;
      if (c == 0) v = t.S1[r];
      else if (c < 4) v = t.G3[r * 3 + c - 1];
      else if (c < 7) v = t.GC[r * 3 + c - 4];
      else if (c < 10) v = t.RL[r * 3 + c - 7];
      else if (c < 13) v = t.DL[r * 3 + c - 10];
      p.out[i * 16 + c] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS, 1) PP_NAME(point_pipeline_bwd_kernel)(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile t;
  Rings st;
  carve_bwd(t, st, smem);
  const int tid = threadIdx.x;
  const BwdScratch s = carve_bwd_scratch<PP_PREC>(
      p, p.scratch + size_t(blockIdx.x) * bwd_scratch_floats(shape_of(p), p.dw_batch, PP_PREC));
  float* P = p.partial + size_t(blockIdx.x) * p.n_grad;
  const long long n_tiles = (p.n_pts + TILE - 1) / TILE;
  int slot = 0;   // the tile's place in the weight-grad batch
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * TILE;
    const Save sv = bwd_save(p, s, slot);
    load_points<TILE>(p, t, base);
    forward_tile<TILE, true, false, PP_PREC>(p, t, st, s.gates, s.feat, sv);
    for (int e = tid; e < TILE * 16; e += THREADS) {
      const long long i = base + e / 16;
      t.CT[e] = i < p.n_pts ? p.gbar[base * 16 + e] : 0.f;
    }
    __syncthreads();
    backward_tile<PP_PREC>(p, t, st, s.gates, s.zt, sv, P);
    if (tid < TILE && base + tid < p.n_pts) {
      const long long i = base + tid;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        p.pts_hat[3 * i + j] = t.PH[tid * 3 + j];
        p.dirs_hat[3 * i + j] = t.DH[tid * 3 + j];
      }
    }
    slot = after_tile<PP_PREC>(p, st, s, slot, tile + gridDim.x >= n_tiles, P);
  }
}

// out[i] = sum over the blocks b = 0, 1, ... of partial[b][i], in that order.
__global__ void point_pipeline_reduce_kernel(const float* __restrict__ partial,
                                             float* __restrict__ out, int n_blocks,
                                             long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[size_t(b) * n + i];
  out[i] = s;
}

}  // namespace

// Plain C interface for ctypes. The blocks a launch may use at once (SMs x
// resident blocks per SM): the wrapper sizes the scratch by it.
extern "C" int point_pipeline_fwd_max_blocks(int* n_blocks) {
  return int(max_blocks(PP_NAME(point_pipeline_fwd_kernel), SMEM_FWD, n_blocks));
}

extern "C" int point_pipeline_bwd_max_blocks(int* n_blocks) {
  return int(max_blocks(PP_NAME(point_pipeline_bwd_kernel), SMEM_BWD, n_blocks));
}

extern "C" long long point_pipeline_bwd_scratch_floats(int n_sdf, int skip, int n_color,
                                                       int n_relight, int y_in, int dw_batch) {
  return bwd_scratch_floats(Shape{n_sdf, skip, n_color, n_relight, y_in}, dw_batch, PP_PREC);
}

extern "C" long long point_pipeline_fwd_scratch_floats(int n_sdf) {
  return fwd_scratch_floats(n_sdf);
}

extern "C" int point_pipeline_fwd_rows() { return FWD_ROWS; }

// Each launch returns 0 or the CUDA error code of the attribute call or the
// launch; none synchronises. `w`: the packed f32 weights, `wimg`: the wgmma
// weight slabs (point_pipeline.py _pack_images), device pointers; `off` /
// `ioff`: host arrays of their offset tables. `scratch`: n_blocks x
// point_pipeline_fwd_scratch_floats floats.
extern "C" int point_pipeline_fwd_launch(
    const float* pts, const float* dirs, const float* w, const void* wimg, float* out,
    float* scratch, long long n_pts, int n_blocks, int n_sdf, int skip, int d0, float scale,
    int n_color, int color_dv, int squeeze, int n_relight, int rl_dv, int y_in, int inv_sigmoid,
    const long long* off, const long long* ioff, int n_off, void* stream) {
  if (n_pts <= 0) return 0;
  if (bad_shape(n_off, n_sdf, n_color, n_relight)) return int(cudaErrorInvalidValue);
  Params p = make_params(pts, dirs, w, wimg, n_pts, n_sdf, skip, d0, scale, n_color, color_dv,
                         squeeze, n_relight, rl_dv, y_in, inv_sigmoid, off, ioff);
  p.out = out;
  p.scratch = scratch;
  cudaError_t e = cudaFuncSetAttribute(PP_NAME(point_pipeline_fwd_kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(SMEM_FWD));
  if (e != cudaSuccess) return int(e);
  PP_NAME(point_pipeline_fwd_kernel)<<<n_blocks, THREADS, SMEM_FWD,
                                       static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// `partial` must hold n_blocks x n_grad zeros; `scratch` n_blocks x
// point_pipeline_bwd_scratch_floats(..., dw_batch) floats.
extern "C" int point_pipeline_bwd_launch(
    const float* pts, const float* dirs, const float* gbar, const float* w, const void* wimg,
    float* pts_hat, float* dirs_hat, float* partial, float* scratch, long long n_pts,
    int n_blocks, long long n_grad, int dw_batch, int n_sdf, int skip, int d0, float scale,
    int n_color, int color_dv, int squeeze, int n_relight, int rl_dv, int y_in, int inv_sigmoid,
    const long long* off, const long long* ioff, int n_off, void* stream) {
  if (n_pts <= 0) return 0;
  if (bad_shape(n_off, n_sdf, n_color, n_relight) || dw_batch < 1)
    return int(cudaErrorInvalidValue);
  Params p = make_params(pts, dirs, w, wimg, n_pts, n_sdf, skip, d0, scale, n_color, color_dv,
                         squeeze, n_relight, rl_dv, y_in, inv_sigmoid, off, ioff);
  p.dw_batch = dw_batch;
  p.scratch = scratch;
  p.gbar = gbar;
  p.pts_hat = pts_hat;
  p.dirs_hat = dirs_hat;
  p.partial = partial;
  p.n_grad = n_grad;
  cudaError_t e = cudaFuncSetAttribute(PP_NAME(point_pipeline_bwd_kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(SMEM_BWD));
  if (e != cudaSuccess) return int(e);
  PP_NAME(point_pipeline_bwd_kernel)<<<n_blocks, THREADS, SMEM_BWD,
                                       static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

extern "C" int point_pipeline_reduce_launch(const float* partial, float* out, int n_blocks,
                                            long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  point_pipeline_reduce_kernel<<<unsigned(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(partial, out, n_blocks, n);
  return int(cudaGetLastError());
}

extern "C" int point_pipeline_n_off() { return N_OFF; }

extern "C" int point_pipeline_prec() { return PP_PREC; }

extern "C" const char* point_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
