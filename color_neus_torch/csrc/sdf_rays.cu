// SDF placement sweep: the Hopper counterpart of the TPU kernel
// color_neus_tpu/ops/pallas/sdf_mlp.py::_sdf_rays_kernel (launched by
// make_fused_sdf_rays_fn, sdf_mlp.py:313-390).
//
// What it computes. Per point i of R*S, with ray r = i / S:
//   p = ro_r + rd_r * z_i                       (exact f32, no FMA contraction)
//   emb = PE(p * scale)                         (frequency-major, sin before cos;
//                                                phase in exact f32 in both modes)
//   h = 9-layer softplus(beta=100) MLP, skip input concat[h, emb]/sqrt(2)
//   out_i = h_0 * (1 / scale)                   (only row 0 of the last layer; the
//                                                reciprocal rounded to f32 on the host)
// The activation is softplus or relu (sweep_activation); the dot type is
// bf16 (weights and layer inputs rounded to bf16, products accumulated in
// f32, bias and activation in f32) or exact f32 (sweep_dtype).
// The TPU kernel's bf16 mode also rounds the ray origins and directions
// to bf16 inside its DEFAULT-precision phase dot (sdf_mlp.py:225-230);
// this kernel does not copy that: the phase is exact f32 in both modes.
// The softplus is the plain twin's form max(x, 0) + log1p(exp(-100|x|)) *
// 0.01 (softplus_sweep): an IEEE divide by 100 in its place takes the
// divide's out-of-line slow path whenever log1p(exp(-100|x|)) is denormal,
// 0.873 < |x| < 1.04, which the trained weights' pre-activations reach.
//
// Bound on the H100. 459,008 MACs per point at the default width against
// 20 bytes of input/output per point, ~45,000 operations per byte: far
// above the card's ~295 ops/byte balance, so the sweep is bound by
// operations: the bf16 tensor cores (989 TFLOP/s) in bf16 mode, the f32
// FMA pipe (67 TFLOP/s) in f32 mode, and in both the softplus epilogue's
// ~2,000 evaluations per point on the FP32 pipe and the special-function
// units (chip_smoke.py's bound counts their instructions from the SASS of
// a one-element probe, SDF_RAYS_PROBE below).
//
// Design. One block owns a tile of points and carries it through every
// layer; its activations never leave shared memory, only 20 bytes per
// point touch device memory. The weights (~0.9 MB bf16 / ~1.8 MB f32,
// L2-resident across the blocks of a launch) stream through shared memory
// as one sequence of 8 KB slabs over all layers: a ring of STAGES slabs
// filled by the TMA unit's bulk copies (thread 0 issues slab s + STAGES - 1
// while the block computes slab s), each completing on its stage's "full"
// mbarrier; every warp arrives on the stage's "empty" mbarrier when it has
// read the slab, and thread 0 waits for all of them before refilling it.
// So the next slabs' loads overlap the current products and each slab
// costs one barrier wait, never an L2 round trip per k-step.
//  * bf16: 128 points, 16 warps, one block per SM, a 16-stage ring. A slab
//    is one 16-row k-step of a [K, 256] layer block, packed by the wrapper
//    in mma.m16n8k16 B-fragment order, so the four n-tiles of columns
//    32w .. 32w + 32 are one contiguous kilobyte. Warp (m, w) computes
//    those columns of points 64m .. 64m + 64 with mma.sync bf16 (f32
//    accumulators; A fragments by ldmatrix from the bf16 activation tile),
//    then, after a barrier, applies bias + activation (and the skip's
//    1/sqrt(2)) to its own accumulators in registers and stores them,
//    rounded to bf16, back into the tile: no staging tile.
//  * f32: 64 points, 8 warps, 2 blocks per SM, a 4-stage ring. A slab is 8
//    rows of a row-major [K, 256] block. The activations sit transposed
//    ([k][point]), so a thread's 8 x 8 register tile (points 8w .. 8w + 8,
//    columns 4 lane .. + 4 and 128 + 4 lane .. + 4) reads its operands as
//    four 16-byte loads per k (the A pair a warp broadcast) for 64 exact
//    f32 FMAs, summed in k order; bias and activation in registers after a
//    barrier, into the same tile.
// The PE columns are padded 39 -> 48 and the layer before the skip 217 ->
// 256 with zero weight rows/columns, so every hidden activation is 256
// wide; the skip layer reads [h (256), emb (48)] = 304 columns. The PE
// of the skip input is written once, beside the columns the epilogues
// write. The tail tile is masked: rows past R*S read z = 0 and store
// nothing.
//
// Second entry, the grid SDF (sdf_points_launch): the Hopper counterpart of
// sdf_mlp.py::_sdf_mlp_kernel (make_fused_sdf_fn, sdf_mlp.py:237-304), the
// mesh extraction's per-voxel SDF. The same kernels with the points read
// from an [N, 3] array instead of built from rays (template POINTS),
// softplus only, in exact f32 (extract_precision 'f32', where the SDF error
// sets the vertex accuracy), bf16, or f32x3. Its bound is the sweep's:
// 459,008 MACs per point against 16 bytes of input/output, bound by
// operations.
//
// f32x3 (extract_precision 'f32x3', sdf_mlp.py::_sdf_layers with
// prec='f32x3'): each f32 layer input h and weight w is split into
// hi = bf16(x) and lo = bf16(x - hi), and the layer is hi.hi + hi.lo +
// lo.hi on the bf16 tensor cores, summed in f32 (only lo.lo is missing,
// ~2^-16 relative), then bias + softplus in f32. It is the bf16 kernel with
// two activation tiles (hi and lo, both written by the epilogue from the
// f32 result) and three mma.sync a fragment. Shared memory decides the
// shape: the two 128-point tiles take 156 KB, so the ring keeps 4 stages
// of 16 KB, each stage one k-step's hi and lo slabs side by side (one bulk
// copy): the 128-point tile keeps the weight bytes per point of the bf16
// kernel, where a 64-point tile would double them, and a k-step costs one
// barrier wait as before. The last layer's row is a SIMT dot over the hi
// and lo tiles and a hi and a lo weight row. Bound: three bf16 product
// passes against the bf16 kernel's softplus epilogue (per element one more
// rounding and a subtraction), so operations.

#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

#include "mlp_common.cuh"

namespace {

using mlp::EMB;
using mlp::HID;
using mlp::INV_SQRT2;
using mlp::THREADS;
using mlp::TILE;
using mlp::emb_value;

constexpr unsigned SLAB = 8192;          // bytes per slab: 16 bf16 rows or 8 f32 rows of 256
constexpr int KS_BF16 = 16, KS_F32 = 8;  // weight rows per slab
// bf16 activation tile: bf16 pairs (32-bit words), row stride 156 words
// (624 B): the 8 rows an A fragment or an epilogue store touches at once
// then start 28 words apart modulo the 32 banks, so its 32 lanes hit 32
// distinct banks.
constexpr int LDW = (HID + EMB + 8) / 2;
// f32 activation tile, transposed ([k][point]): row stride in floats
constexpr int LDT = TILE + 4;
constexpr int F32_STAGES = 4;            // the f32 kernel's ring
// The bf16 kernel: a tile of 128 points, two rows of 8 warps, warp
// (m, w) computing points 64 m .. + 64 (MT_BF16 m-tiles of 16), columns
// 32 w .. + 32; one block per SM, a 16-stage ring.
constexpr int PTS_BF16 = 128, MT_BF16 = 4, THREADS_BF16 = 2 * THREADS, BF16_STAGES = 16;
// f32x3: the same tile and warps, two tiles (hi, lo), a ring of 4 stages
// of one k-step's hi and lo slabs each
constexpr int X3_STAGES = 4;
constexpr unsigned SLAB_X3 = 2 * SLAB;

template <int STAGES, unsigned BYTES = SLAB>
__host__ __device__ constexpr size_t smem_ring() {
  return size_t(STAGES) * BYTES + 2 * STAGES * sizeof(unsigned long long);
}
constexpr size_t SMEM_BF16 = smem_ring<BF16_STAGES>() + size_t(PTS_BF16) * LDW * 4;
constexpr size_t SMEM_X3 = smem_ring<X3_STAGES, SLAB_X3>() + 2 * size_t(PTS_BF16) * LDW * 4;
constexpr size_t SMEM_F32 = smem_ring<F32_STAGES>() + size_t(HID + EMB) * LDT * 4;
static_assert(SMEM_X3 <= 232448, "f32x3: the two tiles and the ring exceed a block's shared memory");

// The dot types of a launch (the entries' `mode` argument)
enum Mode { MODE_F32 = 0, MODE_BF16 = 1, MODE_X3 = 2 };

struct Params {
  const float* rays_o;  // [R, 3]  (sweep)
  const float* rays_d;  // [R, 3]  (sweep)
  const float* z;       // [R * S] (sweep)
  const float* pts;     // [n_pts, 3] (grid SDF)
  const void* w;        // packed weights (bf16 fragment order or f32), see the wrapper
  const float* bias;    // [n_lin, HID]
  float* out;           // [R * S]
  int n_pts;
  int S;                // samples per ray (sweep; 1 for the grid SDF)
  int n_lin;
  int skip;             // index of the skip layer, -1 for none
  int d0;               // real PE width (3 + 6 * multires)
  float scale;
  float inv_scale;      // 1 / scale, rounded to f32
};

// softplus(beta = 100) as the plain twin computes it (ops/kernels/sdf_rays.py,
// _softplus100_stable): the log term scaled by a multiply, not divided by
// 100, and no contraction into an FMA.
__device__ __forceinline__ float softplus_sweep(float x) {
  return __fadd_rn(fmaxf(x, 0.f), __fmul_rn(log1pf(expf(-100.f * fabsf(x))), 0.01f));
}

template <bool RELU>
__device__ __forceinline__ float activate(float x) {
  return RELU ? fmaxf(x, 0.f) : softplus_sweep(x);
}

// The weight ring: slab s of the stream (every hidden layer's block in
// order, BYTES each) at src + s * BYTES, into stage s % STAGES.
template <int STAGES, unsigned BYTES = SLAB>
struct Ring {
  unsigned char* buf;            // [STAGES][BYTES]
  unsigned long long* full;      // [STAGES] one arrival + the copy's bytes
  unsigned long long* empty;     // [STAGES] one arrival per warp
  const unsigned char* src;
  int n;                         // slabs in the stream

  __device__ Ring(unsigned char* smem, const void* w, int n_slabs)
      : buf(smem),
        full(reinterpret_cast<unsigned long long*>(smem + size_t(STAGES) * BYTES)),
        empty(full + STAGES), src(static_cast<const unsigned char*>(w)), n(n_slabs) {}

  // Thread 0: slab s into its stage, once every warp has released the
  // slab that stage held before.
  __device__ __forceinline__ void issue(int s) const {
    if (s >= n) return;
    const int st = s % STAGES;
    if (s >= STAGES) mlp::mbar_wait(empty + st, unsigned(s / STAGES - 1) & 1u);
    mlp::bulk_load(buf + st * BYTES, src + size_t(s) * BYTES, BYTES, full + st);
  }

  // Thread 0, before the block's first barrier: the barriers, and the
  // first STAGES - 1 slabs in flight.
  __device__ void start() const {
    for (int i = 0; i < STAGES; ++i) {
      mlp::mbar_init(full + i, 1);
      mlp::mbar_init(empty + i, blockDim.x / 32);
    }
    mlp::mbar_init_fence();
    for (int s = 0; s < STAGES - 1; ++s) issue(s);
  }

  // Every thread, at step s: thread 0 keeps the ring STAGES - 1 slabs
  // ahead, then the warp waits (converged) until slab s has landed.
  __device__ __forceinline__ const unsigned char* acquire(int s) const {
    if (threadIdx.x == 0) issue(s + STAGES - 1);
    mlp::mbar_wait(full + s % STAGES, unsigned(s / STAGES) & 1u);
    __syncwarp();
    return buf + (s % STAGES) * BYTES;
  }

  // Every thread, after its warp's last read of slab s.
  __device__ __forceinline__ void release(int s) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mlp::mbar_arrive(empty + s % STAGES);
  }
};

// p * scale for the tile's PTS points into xs (point t at xs + t * ldx):
// p = ro + rd * z for the sweep, the given points for the grid SDF (POINTS).
template <bool POINTS, int PTS>
__device__ void load_points(const Params& p, int base, float* xs, int ldx) {
  const int t = threadIdx.x;
  if (t < PTS) {
    const int i = base + t;
    float x[3] = {0.f, 0.f, 0.f};
    if (i < p.n_pts) {
      if (POINTS) {
#pragma unroll
        for (int j = 0; j < 3; ++j) x[j] = __fmul_rn(p.pts[3 * size_t(i) + j], p.scale);
      } else {
        const int r = i / p.S;
        const float zz = p.z[i];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          x[j] = __fmul_rn(__fadd_rn(p.rays_o[3 * r + j], __fmul_rn(p.rays_d[3 * r + j], zz)),
                           p.scale);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) xs[t * ldx + j] = x[j];
  }
}

__device__ __forceinline__ int layer_k(const Params& p, int l) {
  return l == 0 ? EMB : (l == p.skip ? HID + EMB : HID);
}

// The two bf16 halves of a packed pair, as f32.
__device__ __forceinline__ float lo_bf16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 from the ring, epilogue on the accumulators
// ---------------------------------------------------------------------------

// The hi and lo bf16 parts of x (f32x3): hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi, unsigned& lo) {
  const float h0 = mlp::round_bf16(x0), h1 = mlp::round_bf16(x1);
  hi = mlp::pack_bf16(h0, h1);
  lo = mlp::pack_bf16(x0 - h0, x1 - h1);
}

// X3 (f32x3): two tiles, act (the hi parts) and act + TILE_WORDS (the lo
// parts), and a ring stage holding a k-step's hi slab then its lo slab.
template <bool RELU, bool POINTS, bool X3>
__global__ void __launch_bounds__(THREADS_BF16, 1) sdf_rays_bf16_kernel(Params p) {
  constexpr int PTS = PTS_BF16, MT = MT_BF16, NTHREADS = THREADS_BF16;
  constexpr int STAGES = X3 ? X3_STAGES : BF16_STAGES;
  constexpr unsigned STAGE_BYTES = X3 ? SLAB_X3 : SLAB;
  constexpr int TILE_WORDS = PTS * LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* act = reinterpret_cast<unsigned*>(smem + smem_ring<STAGES, STAGE_BYTES>());   // [PTS][LDW]
  unsigned* act_lo = act + TILE_WORDS;                                  // X3: [PTS][LDW]
  // the points in the row padding (words 152 .. 155, never read as operands)
  float* xs = reinterpret_cast<float*>(act + (HID + EMB) / 2);
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wn = (tid >> 5) & 7, m0 = 64 * (tid >> 8);        // columns 32 wn .., rows m0 ..
  const int base = blockIdx.x * PTS;
  int n_slabs = 0;
  for (int l = 0; l < p.n_lin - 1; ++l) n_slabs += layer_k(p, l) / KS_BF16;
  const Ring<STAGES, STAGE_BYTES> ring(smem, p.w, n_slabs);
  if (tid == 0) ring.start();

  load_points<POINTS, PTS>(p, base, xs, LDW);
  __syncthreads();
  // the PE: layer 0's input, and the skip layer's emb / sqrt(2) beside the
  // 256 columns the epilogues write
  for (int e = tid; e < PTS * (EMB / 2); e += NTHREADS) {
    const int r = e / (EMB / 2), c = 2 * (e % (EMB / 2));
    const float e0 = emb_value(xs + r * LDW, c, p.d0), e1 = emb_value(xs + r * LDW, c + 1, p.d0);
    if constexpr (X3) {
      split_pair(e0, e1, act[r * LDW + c / 2], act_lo[r * LDW + c / 2]);
      if (p.skip >= 0)
        split_pair(e0 * INV_SQRT2, e1 * INV_SQRT2, act[r * LDW + (HID + c) / 2],
                   act_lo[r * LDW + (HID + c) / 2]);
    } else {
      act[r * LDW + c / 2] = mlp::pack_bf16(e0, e1);
      if (p.skip >= 0)
        act[r * LDW + (HID + c) / 2] = mlp::pack_bf16(e0 * INV_SQRT2, e1 * INV_SQRT2);
    }
  }
  __syncthreads();

  int s = 0;
  for (int l = 0; l < p.n_lin - 1; ++l) {
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    const int nks = layer_k(p, l) / KS_BF16;
    for (int ks = 0; ks < nks; ++ks, ++s) {
      // n-tiles 4 wn .. 4 wn + 3: 32 lanes x 8 B each, contiguous
      const uint2* B = reinterpret_cast<const uint2*>(ring.acquire(s)) + wn * 128 + lane;
      uint2 b[4], blo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = B[32 * j];
        if constexpr (X3) blo[j] = B[SLAB / 8 + 32 * j];   // the lo slab, SLAB bytes on
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // A fragment (a0 / a2 rows g, a1 / a3 rows g + 8; a2 / a3 eight
        // columns on) in one ldmatrix: lane l points at row l % 16 of the
        // m-tile, columns 8 (l / 16) .. + 8 of the k-step
        const int off = (m0 + 16 * i + (lane & 15)) * LDW + 8 * ks + 4 * (lane >> 4);
        unsigned a[4];
        mlp::ldmatrix_x4(a, act + off);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mlp::mma_bf16(acc[i][j], a[0], a[1], a[2], a[3], b[j].x, b[j].y);
        if constexpr (X3) {
          unsigned al[4];
          mlp::ldmatrix_x4(al, act_lo + off);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mlp::mma_bf16(acc[i][j], a[0], a[1], a[2], a[3], blo[j].x, blo[j].y);
            mlp::mma_bf16(acc[i][j], al[0], al[1], al[2], al[3], b[j].x, b[j].y);
          }
        }
      }
      ring.release(s);
    }
    __syncthreads();  // every warp has read the layer's input
    // epilogue: accumulator q of tile (i, j) is row m0 + 16 i + g + 8 (q / 2),
    // column 32 wn + 8 j + 2 t + q % 2; the pair (q, q + 1) is one word
    const float* bl = p.bias + l * HID;
    const float post = (l + 1 == p.skip) ? INV_SQRT2 : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * wn + 8 * j + 2 * t;
      const float b0 = bl[c], b1 = bl[c + 1];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int w = (m0 + 16 * i + g + 8 * h) * LDW + c / 2;
          const float v0 = activate<RELU>(acc[i][j][2 * h] + b0) * post;
          const float v1 = activate<RELU>(acc[i][j][2 * h + 1] + b1) * post;
          if constexpr (X3)
            split_pair(v0, v1, act[w], act_lo[w]);
          else
            act[w] = mlp::pack_bf16(v0, v1);
        }
    }
    __syncthreads();
  }

  // last layer, output row 0 only: a SIMT dot over the bf16 tile, warp per
  // row (X3: the hi and lo tiles against the hi and lo rows, hi.hi + hi.lo
  // + lo.hi)
  const unsigned* wl =
      static_cast<const unsigned*>(p.w) + size_t(n_slabs) * (STAGE_BYTES / 4);
  const float bias = p.bias[(p.n_lin - 1) * HID];
  for (int r = tid >> 5; r < PTS; r += NTHREADS / 32) {
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < HID / 64; ++m) {
      const unsigned x = act[r * LDW + lane + 32 * m], w = wl[lane + 32 * m];
      sum = fmaf(lo_bf16(x), lo_bf16(w), sum);
      sum = fmaf(hi_bf16(x), hi_bf16(w), sum);
      if constexpr (X3) {
        const unsigned xl = act_lo[r * LDW + lane + 32 * m], wlo = wl[HID / 2 + lane + 32 * m];
        sum = fmaf(lo_bf16(x), lo_bf16(wlo), sum);
        sum = fmaf(hi_bf16(x), hi_bf16(wlo), sum);
        sum = fmaf(lo_bf16(xl), lo_bf16(w), sum);
        sum = fmaf(hi_bf16(xl), hi_bf16(w), sum);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0 && base + r < p.n_pts) p.out[base + r] = (sum + bias) * p.inv_scale;
  }
}

// ---------------------------------------------------------------------------
// f32: exact FMAs, 8 x 8 register tiles fed by 16-byte shared-memory loads
// ---------------------------------------------------------------------------

template <bool RELU, bool POINTS>
__global__ void __launch_bounds__(THREADS, 2) sdf_rays_f32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // [HID + EMB][LDT], transposed
  float* act = reinterpret_cast<float*>(smem + smem_ring<F32_STAGES>());
  float* xs = act + EMB * LDT;          // [TILE][3] in rows layer 0 does not read
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int base = blockIdx.x * TILE;
  int n_slabs = 0;
  for (int l = 0; l < p.n_lin - 1; ++l) n_slabs += layer_k(p, l) / KS_F32;
  const Ring<F32_STAGES> ring(smem, p.w, n_slabs);
  if (tid == 0) ring.start();

  load_points<POINTS, TILE>(p, base, xs, 3);
  __syncthreads();
  for (int e = tid; e < TILE * EMB; e += THREADS) {
    const int c = e / TILE, r = e % TILE;
    const float v = emb_value(xs + r * 3, c, p.d0);
    act[c * LDT + r] = v;
    if (p.skip >= 0) act[(HID + c) * LDT + r] = v * INV_SQRT2;
  }
  __syncthreads();

  // thread (warp, lane): points 8 warp + i, columns col(j) = 4 lane + j
  // (j < 4) and 128 + 4 lane + j - 4
  int s = 0;
  for (int l = 0; l < p.n_lin - 1; ++l) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const int nkb = layer_k(p, l) / KS_F32;
    for (int kb = 0; kb < nkb; ++kb, ++s) {
      const float* W = reinterpret_cast<const float*>(ring.acquire(s));
      const float* X = act + kb * KS_F32 * LDT + 8 * warp;
#pragma unroll
      for (int kk = 0; kk < KS_F32; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(X + kk * LDT);
        const float4 x1 = *reinterpret_cast<const float4*>(X + kk * LDT + 4);
        const float4 w0 = *reinterpret_cast<const float4*>(W + kk * HID + 4 * lane);
        const float4 w1 = *reinterpret_cast<const float4*>(W + kk * HID + 128 + 4 * lane);
        const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float b[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      ring.release(s);
    }
    __syncthreads();  // every thread has read the layer's input
    const float* bl = p.bias + l * HID;
    const float post = (l + 1 == p.skip) ? INV_SQRT2 : 1.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 0 : 128 - 4) + 4 * lane + j;
      const float b = bl[c];
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = activate<RELU>(acc[i][j] + b) * post;
      float4* d = reinterpret_cast<float4*>(act + c * LDT + 8 * warp);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
  }

  // last layer, output row 0 only: thread (q, r) sums k in [64 q, 64 q + 64)
  // of point r, the four partials meet in the (now idle) ring buffer
  const float* wl = static_cast<const float*>(p.w) + size_t(n_slabs) * (SLAB / 4);
  float* part = reinterpret_cast<float*>(smem);
  {
    const int r = tid % TILE, q = tid / TILE;
    float sum = 0.f;
    for (int k = 64 * q; k < 64 * q + 64; ++k) sum = fmaf(act[k * LDT + r], wl[k], sum);
    part[q * TILE + r] = sum;
  }
  __syncthreads();
  if (tid < TILE && base + tid < p.n_pts) {
    const float sum =
        (part[tid] + part[TILE + tid]) + (part[2 * TILE + tid] + part[3 * TILE + tid]);
    p.out[base + tid] = (sum + p.bias[(p.n_lin - 1) * HID]) * p.inv_scale;
  }
}

// The kernel of a launch, its block, its dynamic shared memory and its
// points per block.
struct Choice {
  void (*kern)(Params);
  int threads;
  size_t smem;
  int pts;
};

// f32x3 exists for the grid SDF only (mode MODE_X3 with points).
Choice choose(int mode, bool relu, bool points) {
  if (mode == MODE_F32)
    return {points ? sdf_rays_f32_kernel<false, true>
                   : relu ? sdf_rays_f32_kernel<true, false> : sdf_rays_f32_kernel<false, false>,
            THREADS, SMEM_F32, TILE};
  if (mode == MODE_X3)
    return {sdf_rays_bf16_kernel<false, true, true>, THREADS_BF16, SMEM_X3, PTS_BF16};
  return {points ? sdf_rays_bf16_kernel<false, true, false>
                 : relu ? sdf_rays_bf16_kernel<true, false, false>
                        : sdf_rays_bf16_kernel<false, false, false>,
          THREADS_BF16, SMEM_BF16, PTS_BF16};
}

int launch(Params p, int mode, bool relu, bool points, cudaStream_t st) {
  if (p.n_pts <= 0) return 0;
  if (mode < MODE_F32 || mode > MODE_X3 || (mode == MODE_X3 && (relu || !points)))
    return int(cudaErrorInvalidValue);
  p.inv_scale = 1.f / p.scale;
  const Choice c = choose(mode, relu, points);
  cudaError_t e = cudaFuncSetAttribute(c.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(c.smem));
  if (e != cudaSuccess) return int(e);
  c.kern<<<dim3(unsigned((p.n_pts + c.pts - 1) / c.pts)), c.threads, c.smem, st>>>(p);
  return int(cudaGetLastError());
}

// int point indices: the entries reject more points than this
constexpr long long MAX_PTS = 0x7fffffffLL - 2 * PTS_BF16;

}  // namespace

// Plain C interface for ctypes. Each returns 0 or the CUDA error code of the
// attribute call or the launch; neither synchronises.
extern "C" int sdf_rays_launch(const float* rays_o, const float* rays_d, const float* z,
                               const void* w, const float* bias, float* out,
                               long long n_pts, int S, int n_lin, int skip, int d0,
                               float scale, int bf16, int relu, void* stream) {
  if (n_pts > MAX_PTS) return int(cudaErrorInvalidValue);
  Params p{rays_o, rays_d, z, nullptr, w, bias, out, int(n_pts), S, n_lin, skip, d0, scale, 0.f};
  return launch(p, bf16 ? MODE_BF16 : MODE_F32, relu, false, static_cast<cudaStream_t>(stream));
}

// The grid SDF (softplus only): out[i] = sdf(pts[i]) for n_pts points, in
// mode 0 (f32), 1 (bf16) or 2 (f32x3).
extern "C" int sdf_points_launch(const float* pts, const void* w, const float* bias, float* out,
                                 long long n_pts, int n_lin, int skip, int d0, float scale,
                                 int mode, void* stream) {
  if (n_pts > MAX_PTS) return int(cudaErrorInvalidValue);
  Params p{nullptr, nullptr, nullptr, pts, w, bias, out, int(n_pts), 1, n_lin, skip, d0, scale,
           0.f};
  return launch(p, mode, false, true, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of a kernel variant (mode as sdf_points_launch's),
// or -1 on an error.
extern "C" int sdf_rays_blocks_per_sm(int mode, int relu, int points) {
  if (mode < MODE_F32 || mode > MODE_X3) return -1;
  const Choice c = choose(mode, relu, points);
  if (cudaFuncSetAttribute(c.kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(c.smem)) !=
      cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kern, c.threads, c.smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

extern "C" const char* sdf_rays_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef SDF_RAYS_PROBE
// Instruction probes, never launched: chip_smoke.py builds them alone
// (nvcc -DSDF_RAYS_PROBE -cubin) and counts in their SASS what one element
// of the epilogue issues (bias add, activation, the skip's scale), less the
// copy probe. One element per thread, straight-line, the kernels' own
// device functions.
template <bool RELU>
__global__ void sdf_epilogue_probe(const float* x, const float* b, float* y, float post) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = activate<RELU>(x[i] + b[i]) * post;
}
template __global__ void sdf_epilogue_probe<false>(const float*, const float*, float*, float);
template __global__ void sdf_epilogue_probe<true>(const float*, const float*, float*, float);
__global__ void sdf_copy_probe(const float* x, const float* b, float* y, float post) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = x[i];
}
#endif  // SDF_RAYS_PROBE
