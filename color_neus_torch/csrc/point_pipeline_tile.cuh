// The tile-level device code of the per-point pipeline: the forward of one
// 64-point tile (forward_tile, with every layer input kept when SAVE) and the
// pullback of its five outputs (backward_tile), the shared-memory tile and
// scratch layouts they use, and the host helpers of the kernels built on
// them. point_pipeline.cu (kernel rows 5 and 6) and ray_march.cu (rows 3
// and 4) include it; the design and the bound are in point_pipeline.cu's
// note. Both tile functions read and write only the tile: the caller fills
// its points, view dirs (P3, D3) and, for the backward, the cotangents (CT)
// of the five outputs, and reads the outputs (S1, G3, GC, RL, DL) or the
// point and dir cotangents (PH, DH) back.
//
// The arithmetic is the TPU kernels' production arithmetic (JAX bf16 = not
// interpret, MARCH_BWD_PRECISION f32stash): every product rounds its two
// operands to bf16 and sums in f32 (the 256-wide ones on the tensor cores,
// tile_product and dw_accum; the 1- and 3-wide ones as SIMT FMAs,
// narrow_layer and narrow_back); the activations, gates and stores stay
// f32; layer 0's weight grad takes its f32 operands (the PE and the tangent
// seed) as hi + lo bf16 pairs, and the last layer's rank-1 tangent term is
// summed in f32.
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
using mlp::mma_bf16;
using mlp::pack_bf16;
using mlp::round_bf16;
using mlp::softplus100;

constexpr int LDX = HID + EMB + 4;       // activation row stride: [h 256 | small 48] + pad
constexpr int LDS = HID + EMB;           // row stride of a layer input stored in the scratch
constexpr int MAXL = 16;                 // max layers per network
// slots of the offset tables: `off` holds element offsets into the packed
// f32 weights (the gradient buffers use the same table; its WT slots are
// unused), `boff` offsets in 8-byte units into the bf16 weight blocks in
// mma fragment order (the W and WT slots of the 256-wide layers)
constexpr int W_SDF = 0, WT_SDF = MAXL, B_SDF = 2 * MAXL, W_COL = 3 * MAXL, B_COL = 4 * MAXL,
              W_REL = 5 * MAXL, B_REL = 6 * MAXL, WT_COL = 7 * MAXL, WT_REL = 8 * MAXL,
              W_LAST = 9 * MAXL, B_LAST = W_LAST + 1, W_FEAT = W_LAST + 2, B_FEAT = W_LAST + 3,
              WT_FEAT = W_LAST + 4, N_OFF = W_LAST + 5;

struct Params {
  const float* pts;    // [n, 3]
  const float* dirs;   // [n, 3]
  const float* w;      // packed f32 weights, see off
  const uint2* wb;     // bf16 weight blocks in mma fragment order, see boff
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
  long long boff[N_OFF];
  // backward only
  const float* gbar;   // [n, 16] cotangents in the forward's output lanes
  float* pts_hat;      // [n, 3]
  float* dirs_hat;     // [n, 3]
  float* partial;      // [gridDim.x][n_grad] weight-grad partials, zeroed
  long long n_grad;
};

constexpr size_t SMEM_FWD = (size_t(TILE) * LDX + size_t(TILE) * EMB + 6 * TILE * 3 + TILE) * 4;
constexpr size_t SMEM_BWD =
    SMEM_FWD + (size_t(TILE) * LDX + 2 * size_t(TILE) * EMB + TILE * 16 + 5 * TILE * 3) * 4;

struct Tile {
  float* X;    // [TILE][LDX] activations (value stream)
  float* EG;   // [TILE][EMB] PE cotangent (forward: of the grad sweep; backward: emb_hat)
  float* P3;   // [TILE][3] points
  float* D3;   // [TILE][3] view dirs
  float* G3;   // [TILE][3] grad
  float* GC;   // [TILE][3] global colour
  float* DL;   // [TILE][3] delta
  float* RL;   // [TILE][3] relit
  float* S1;   // [TILE] sdf
  // backward only
  float* Y;    // [TILE][LDX] the tangent stream and its cotangents
  float* VH;   // [TILE][EMB] v0_hat (also stages view-dir PE cotangents)
  float* V0;   // [TILE][EMB] the tangent seed v0
  float* CT;   // [TILE][16] the cotangents gbar
  float* PH;   // [TILE][3] pts_hat
  float* DH;   // [TILE][3] dirs_hat
  float* GH;   // [TILE][3] the total grad cotangent
  float* CG;   // [TILE][3] the total gc cotangent
  float* HB;   // [TILE][3] the cotangent of a 3-wide layer output
};

// Where the backward's recompute keeps each layer's input ([TILE][LDS]
// slabs of the block's scratch).
struct Save {
  float* sx;   // [n_sdf] SDF layer inputs
  float* cx;   // [n_color] colour layer inputs
  float* rx;   // [n_relight] relight layer inputs
};

constexpr size_t SLAB = size_t(TILE) * LDS;
constexpr size_t GSLAB = size_t(TILE) * HID;

enum Epi { EPI_NONE = 0, EPI_RELU = 1, EPI_SOFTPLUS = 2 };

// ------------------------------------------------------------------------
// Tensor-core products (mma.sync m16n8k16, bf16 operands, f32 accumulators)
// ------------------------------------------------------------------------
//
// A weight block B [K][N] (K a multiple of 16, N of 8) sits in the bf16
// buffer in fragment order (point_pipeline.py's _frag): for each k-step ks
// of 16 rows and n-tile nt of 8 columns, 32 lanes x 4 bf16, lane 4 g + t
// holding B[16 ks + 2 t + {0, 1, 8, 9}][8 nt + g], its two B registers. A
// warp's B fragment is one coalesced 8-byte read per lane, from L2.

// The A fragment of rows m0 .. m0 + 16, columns k0 .. k0 + 16 of an f32
// tile in shared memory (row stride lda), rounded to bf16 as it loads:
// a0 / a2 rows g, a1 / a3 rows g + 8; a0 / a1 columns 2t, 2t + 1, a2 / a3
// eight further.
__device__ __forceinline__ void load_a(const float* A, int lda, int m0, int k0,
                                       unsigned (&a)[4]) {
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

// acc[i][j][q] = sum_{k < K} bf16(A[row][k]) B[k][col] for the warp's MT x NT
// tiles: row m0 + 16 i + g + 8 (q / 2), col 8 (nt0 + j) + 2 t + q % 2. A: the
// tile in shared memory (row stride LDX); B: a fragment-ordered block of
// n_tiles n-tiles.
template <int MT, int NT>
__device__ __forceinline__ void mma_tile(const float* A, int K, const uint2* __restrict__ B,
                                         int n_tiles, int m0, int nt0,
                                         float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < K / 16; ++ks) {
    uint2 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = __ldg(B + (size_t(ks) * n_tiles + nt0 + j) * 32 + lane);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      unsigned a[4];
      load_a(A, LDX, m0 + 16 * i, 16 * ks, a);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[0], a[1], a[2], a[3], b[j].x, b[j].y);
    }
  }
}

// put(row, col, acc) for every element of mma_tile's accumulators.
template <int MT, int NT, class F>
__device__ __forceinline__ void each_out(const float (&acc)[MT][NT][4], int m0, int nt0, F&& put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        put(m0 + 16 * i + g + 8 * (q >> 1), 8 * (nt0 + j) + 2 * t + (q & 1), acc[i][j][q]);
}

// The [TILE, N] product bf16(A[:, :K]) @ B (B: a fragment-ordered [K][N]
// block, N = 48, 256 or 304), then put(r, c, v) for every output after a
// barrier, so put may overwrite A; a barrier after. N = 256: warp w owns
// columns 32 w .. 32 w + 32 of all 64 rows (4 x 4 tiles); N = 48: warp w
// owns rows 16 (w % 4) .. + 16, columns 24 (w / 4) .. + 24 (1 x 3 tiles);
// N = 304 is both, the 48 after the 256.
template <int N, class F>
__device__ void tile_product(const float* A, int K, const uint2* __restrict__ B, F&& put) {
  static_assert(N == EMB || N == HID || N == HID + EMB, "tile_product: N");
  const int warp = threadIdx.x >> 5;
  constexpr int NTOT = N / 8;
  const int ms = 16 * (warp & 3), ns = (N == EMB ? 0 : HID / 8) + 3 * (warp >> 2);
  if constexpr (N == EMB) {
    float acc[1][3][4];
    mma_tile<1, 3>(A, K, B, NTOT, ms, ns, acc);
    __syncthreads();
    each_out(acc, ms, ns, put);
  } else {
    float acc[4][4][4];
    mma_tile<4, 4>(A, K, B, NTOT, 0, 4 * warp, acc);
    if constexpr (N == HID + EMB) {
      float acc2[1][3][4];
      mma_tile<1, 3>(A, K, B, NTOT, ms, ns, acc2);
      __syncthreads();
      each_out(acc2, ms, ns, put);
    } else {
      __syncthreads();
    }
    each_out(acc, 0, 4 * warp, put);
  }
  __syncthreads();
}

// tile_product for an output width N chosen at run time.
template <class F>
__device__ void product_any(const float* A, int K, const uint2* __restrict__ B, int N, F&& put) {
  if (N == EMB) tile_product<EMB>(A, K, B, put);
  else if (N == HID) tile_product<HID>(A, K, B, put);
  else tile_product<HID + EMB>(A, K, B, put);
}

// dst[:, :256] = epi(X[:, :K] @ W + b): W a fragment-ordered [K, 256]
// block. EPI_SOFTPLUS also stores the gate to `gates` ([TILE][HID]) and
// scales the value by `post`. dst may be X itself.
template <int EPI>
__device__ void wide_layer(float* X, int K, const uint2* __restrict__ W,
                           const float* __restrict__ b, float post, float* gates,
                           float* dst, int ld) {
  tile_product<HID>(X, K, W, [&](int r, int c, float acc) {
    const float a = acc + b[c];
    float v;
    if (EPI == EPI_SOFTPLUS) {
      const float sp = softplus100(a);
      gates[r * HID + c] = 1.f - expf(-100.f * sp);
      v = sp * post;
    } else if (EPI == EPI_RELU) {
      v = fmaxf(a, 0.f);
    } else {
      v = a;
    }
    dst[r * ld + c] = v;
  });
}

// out[r][j] = bf16(X[r, :K]) . bf16(W[j, :K]) + b[j] for j < n_out (W: f32
// row-major [n_out, K]), summed in f32.
__device__ void narrow_layer(const float* X, int K, int n_out, const float* __restrict__ W,
                             const float* __restrict__ b, float* out, int ld_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    for (int j = 0; j < n_out; ++j) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32)
        s = fmaf(round_bf16(X[r * LDX + k]), round_bf16(__ldg(W + j * K + k)), s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) out[r * ld_out + j] = s + b[j];
    }
  }
  __syncthreads();
}

// One reverse layer: X[:, :256] holds q_l = d raw / d (layer l output) times
// its gate; p = q_l @ W_l^T (WT: the fragment-ordered [256, K] transpose)
// is the cotangent of layer l's input. Its hidden part, times 1/sqrt(2) at
// the skip layer and times the gate of layer l - 1, becomes q_{l-1} in X;
// its PE part (the skip layer's last 48 columns, or all of layer 0's) adds
// to EG.
__device__ void reverse_layer(const Tile& t, const uint2* __restrict__ WT, int K, bool is_skip,
                              const float* gates_prev) {
  product_any(t.X, HID, WT, K, [&](int r, int c, float v) {
    if (K == EMB) {
      t.EG[r * EMB + c] += v;
    } else if (c < HID) {
      const float p = is_skip ? v * INV_SQRT2 : v;
      t.X[r * LDX + c] = p * gates_prev[r * HID + c];
    } else {
      t.EG[r * EMB + c - HID] += v * INV_SQRT2;
    }
  });
}

// X[:, col0 : col0 + EMB] = [pts, grad, PE(dirs) (dv columns), 0 ...]
__device__ void write_small(const Tile& t, int col0, int dv) {
  for (int e = threadIdx.x; e < TILE * EMB; e += THREADS) {
    const int r = e / EMB, c = e % EMB;
    float v;
    if (c < 3) v = t.P3[r * 3 + c];
    else if (c < 6) v = t.G3[r * 3 + c - 3];
    else v = (c - 6 < dv) ? emb_value(t.D3 + r * 3, c - 6, dv) : 0.f;
    t.X[r * LDX + col0 + c] = v;
  }
}

// dst[:, :K] = src[:, :K] (a layer input, kept for the backward). Only
// reads src, so it needs no barrier before the layer that reads src too.
__device__ void save_cols(const float* src, int K, float* dst) {
  for (int e = threadIdx.x; e < TILE * K; e += THREADS) {
    const int r = e / K, c = e % K;
    dst[r * LDS + c] = src[r * LDX + c];
  }
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void pe_row(const Params& p, const Tile& t, int r, float* x) {
#pragma unroll
  for (int j = 0; j < 3; ++j) x[j] = __fmul_rn(t.P3[r * 3 + j], p.scale);
}

// The input width of SDF layer l (l < n_sdf - 1).
__device__ __forceinline__ int sdf_k(const Params& p, int l) {
  return l == 0 ? EMB : (l == p.skip ? HID + EMB : HID);
}

// The forward of the tile whose points and view dirs the caller has put in
// t.P3 / t.D3 (zeros for a padding point; a barrier after), leaving sdf,
// grad, gc, relit and delta in t.S1/G3/GC/RL/DL and the gates and features
// in the block's scratch. SAVE also keeps every layer's input (sv).
template <bool SAVE>
__device__ void forward_tile(const Params& p, const Tile& t, float* gates, float* feat,
                             const Save& sv) {
  const int tid = threadIdx.x;
  const float* W = p.w;
  const uint2* WB = p.wb;
  // SDF PE: X[:, :48] = PE(p * scale)
  for (int e = tid; e < TILE * EMB; e += THREADS) {
    const int r = e / EMB, c = e % EMB;
    float x[3];
    pe_row(p, t, r, x);
    t.X[r * LDX + c] = emb_value(x, c, p.d0);
  }
  __syncthreads();

  // ---- SDF forward, gates to the scratch ----
  for (int l = 0; l < p.n_sdf - 1; ++l) {
    const int K = sdf_k(p, l);
    const bool pre_skip = l + 1 == p.skip;
    if (SAVE) save_cols(t.X, K, sv.sx + l * SLAB);
    wide_layer<EPI_SOFTPLUS>(t.X, K, WB + p.boff[W_SDF + l], W + p.off[B_SDF + l],
                             pre_skip ? INV_SQRT2 : 1.f, gates + l * GSLAB, t.X, LDX);
    if (pre_skip) {
      for (int e = tid; e < TILE * EMB; e += THREADS) {
        const int r = e / EMB, c = e % EMB;
        float x[3];
        pe_row(p, t, r, x);
        t.X[r * LDX + HID + c] = emb_value(x, c, p.d0) * INV_SQRT2;
      }
      __syncthreads();
    }
  }
  // last layer: raw sdf (row 0) and the features (rows 1..256)
  if (SAVE) save_cols(t.X, HID, sv.sx + (p.n_sdf - 1) * SLAB);
  narrow_layer(t.X, HID, 1, W + p.off[W_LAST], W + p.off[B_LAST], t.S1, 1);
  wide_layer<EPI_NONE>(t.X, HID, WB + p.boff[W_FEAT], W + p.off[B_FEAT], 1.f, nullptr, feat,
                       HID);

  // ---- reverse sweep: q = W_last[0, :] (in bf16) * gate of the last hidden layer ----
  const float* wl = W + p.off[W_LAST];
  const float* g_last = gates + size_t(p.n_sdf - 2) * GSLAB;
  for (int e = tid; e < TILE * HID; e += THREADS) {
    const int r = e / HID, c = e % HID;
    t.X[r * LDX + c] = round_bf16(wl[c]) * g_last[r * HID + c];
  }
  for (int e = tid; e < TILE * EMB; e += THREADS) t.EG[e] = 0.f;
  __syncthreads();
  for (int l = p.n_sdf - 2; l >= 0; --l)
    reverse_layer(t, WB + p.boff[WT_SDF + l], sdf_k(p, l), l == p.skip,
                  l > 0 ? gates + size_t(l - 1) * GSLAB : nullptr);
  // PE pullback: grad_j = sum_c EG_c d emb_c / d (p_j scale) (the scale
  // of the PE and the 1/scale of the sdf cancel)
  if (tid < TILE) {
    float x[3], g[3] = {0.f, 0.f, 0.f};
    pe_row(p, t, tid, x);
    for (int c = 0; c < p.d0; ++c) {
      int j;
      const float s = mlp::emb_slope(x, c, p.d0, &j);
      g[j] = fmaf(t.EG[tid * EMB + c], s, g[j]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) t.G3[tid * 3 + j] = g[j];
    t.S1[tid] *= 1.f / p.scale;
  }
  __syncthreads();

  // ---- colour: X = [features | pts, grad, PE(dirs)] ----
  for (int e = tid; e < TILE * HID; e += THREADS) {
    const int r = e / HID, c = e % HID;
    t.X[r * LDX + c] = feat[r * HID + c];
  }
  write_small(t, HID, p.color_dv);
  __syncthreads();
  for (int l = 0; l < p.n_color - 1; ++l) {
    const int K = l == 0 ? HID + EMB : HID;
    if (SAVE) save_cols(t.X, K, sv.cx + l * SLAB);
    wide_layer<EPI_RELU>(t.X, K, WB + p.boff[W_COL + l], W + p.off[B_COL + l], 1.f, nullptr,
                         t.X, LDX);
  }
  if (SAVE) save_cols(t.X, HID, sv.cx + (p.n_color - 1) * SLAB);
  narrow_layer(t.X, HID, 3, W + p.off[W_COL + p.n_color - 1], W + p.off[B_COL + p.n_color - 1],
               t.GC, 3);
  if (p.squeeze)
    for (int e = tid; e < TILE * 3; e += THREADS) t.GC[e] = sigmoidf_(t.GC[e]);
  __syncthreads();

  // ---- relight: X = [pts, grad, PE(dirs) | ... | gc] ----
  if (p.n_relight > 0) {
    write_small(t, 0, p.rl_dv);
    for (int e = tid; e < TILE * EMB; e += THREADS) {
      const int r = e / EMB, c = e % EMB;
      t.X[r * LDX + HID + c] = c < 3 ? t.GC[r * 3 + c] : 0.f;
    }
    __syncthreads();
    for (int l = 0; l < p.n_relight - 1; ++l) {
      const int K = l == 0 ? EMB : (l == p.y_in ? HID + EMB : HID);
      if (SAVE) save_cols(t.X, K, sv.rx + l * SLAB);
      wide_layer<EPI_RELU>(t.X, K, WB + p.boff[W_REL + l], W + p.off[B_REL + l], 1.f, nullptr,
                           t.X, LDX);
    }
    const int last = p.n_relight - 1;
    const int K = last == p.y_in ? HID + EMB : HID;
    if (SAVE) save_cols(t.X, K, sv.rx + last * SLAB);
    narrow_layer(t.X, K, 3, W + p.off[W_REL + last], W + p.off[B_REL + last], t.DL, 3);
    for (int e = tid; e < TILE * 3; e += THREADS) {
      const float gc = t.GC[e], d = t.DL[e];
      if (p.inv_sigmoid) {
        const float gcc = fminf(fmaxf(gc, 0.f), 1.f);
        const float logit = logf(fmaxf(gcc, 1e-5f) / fmaxf(1.f - gcc, 1e-5f));
        t.RL[e] = sigmoidf_(logit + d);
      } else {
        t.RL[e] = fminf(fmaxf(gc + sigmoidf_(d) - 0.5f, 0.f), 1.f);
      }
    }
  } else {
    for (int e = tid; e < TILE * 3; e += THREADS) {
      t.RL[e] = t.GC[e];
      t.DL[e] = 0.f;
    }
  }
  __syncthreads();
}

__device__ void carve_fwd(Tile& t, unsigned char* smem) {
  t.X = reinterpret_cast<float*>(smem);
  t.EG = t.X + TILE * LDX;
  t.P3 = t.EG + TILE * EMB;
  t.D3 = t.P3 + TILE * 3;
  t.G3 = t.D3 + TILE * 3;
  t.GC = t.G3 + TILE * 3;
  t.DL = t.GC + TILE * 3;
  t.RL = t.DL + TILE * 3;
  t.S1 = t.RL + TILE * 3;
}

// ------------------------------------------------------------------------
// Backward
// ------------------------------------------------------------------------

// P[k][c] += sum_r S[r][k] A[r][c] (+ S2[r][k] A2[r][c]) for k < K (a
// multiple of 16), c < 256: a layer's weight grad over the tile, added into
// the block's partial (row-major [K, 256], the packed [in, out] layout). S,
// S2: stored layer inputs in the scratch ([TILE][LDS]); A, A2: output
// cotangents in shared memory (row stride LDX). On the tensor cores with M
// = k, N = c and the 64 points as depth, both operands rounded to bf16;
// SPLIT takes S and S2 as hi + lo bf16 pairs (two passes, layer 0). Per
// 64-row chunk of k, warp w owns rows 32 (w % 2) .. + 32 (2 m-tiles) and
// columns 64 (w / 2) .. + 64 (8 n-tiles).
template <bool TWO, bool SPLIT>
__device__ void dw_accum(const float* S, const float* A, const float* S2, const float* A2, int K,
                         float* P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c0 = 64 * (warp >> 1);
  for (int k0 = 0; k0 < K; k0 += 64) {
    const int kw = k0 + 32 * (warp & 1);
    const int mt = min(2, (K - kw) / 16);   // m-tiles of the warp in range
    if (mt <= 0) continue;
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    for (int src = 0; src < (TWO ? 2 : 1); ++src) {
      const float* Sx = src ? S2 : S;
      const float* Ax = src ? A2 : A;
      for (int r0 = 0; r0 < TILE; r0 += 16) {
        // B: k rows (points) r0 + 2t + {0, 1, 8, 9}, column (output) c0 + 8 j + g
        unsigned b[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* col = Ax + (r0 + 2 * t) * LDX + c0 + 8 * j + g;
          b[j][0] = pack_bf16(col[0], col[LDX]);
          b[j][1] = pack_bf16(col[8 * LDX], col[9 * LDX]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= mt) break;
          // A: rows (inputs) kw + 16 i + g (+ 8), columns (points) r0 + 2t + {0, 1, 8, 9}
          const float* s = Sx + (r0 + 2 * t) * LDS + kw + 16 * i + g;
          const float v[8] = {s[0], s[LDS], s[8], s[LDS + 8],
                              s[8 * LDS], s[9 * LDS], s[8 * LDS + 8], s[9 * LDS + 8]};
          unsigned a[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) a[h] = pack_bf16(v[2 * h], v[2 * h + 1]);
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_bf16(acc[i][j], a[0], a[1], a[2], a[3], b[j][0], b[j][1]);
          if (SPLIT) {
#pragma unroll
            for (int h = 0; h < 4; ++h)
              a[h] = pack_bf16(v[2 * h] - round_bf16(v[2 * h]),
                               v[2 * h + 1] - round_bf16(v[2 * h + 1]));
#pragma unroll
            for (int j = 0; j < 8; ++j)
              mma_bf16(acc[i][j], a[0], a[1], a[2], a[3], b[j][0], b[j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= mt) break;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          P[size_t(kw + 16 * i + g + 8 * (q >> 1)) * HID + c0 + 8 * j + 2 * t + (q & 1)] +=
              acc[i][j][q];
    }
  }
}

// P[c] += sum_r A[r][c] for c < 256: a bias grad over the tile.
__device__ void bias_accum(const float* A, float* P) {
  const int c = threadIdx.x;   // THREADS == HID
  float s = 0.f;
  for (int r = 0; r < TILE; ++r) s += A[r * LDX + c];
  P[c] += s;
}

// The reverse of a 3-wide output layer (W row-major [3, K] in f32, input S
// in the scratch), operands in bf16, sums in f32: dW += HB^T S, db += sum
// HB, X[:, :K] = HB @ W.
__device__ void narrow_back(const Tile& t, const float* S, const float* __restrict__ W, int K,
                            float* Pw, float* Pb) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 3 * K; e += THREADS) {
    const int j = e / K, k = e % K;
    float s = 0.f;
    for (int r = 0; r < TILE; ++r)
      s = fmaf(round_bf16(t.HB[r * 3 + j]), round_bf16(S[r * LDS + k]), s);
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

// DH[r] += the view-dir PE VJP of the cotangents staged in VH[r][:dv].
__device__ void dirs_pe_vjp(const Tile& t, int dv) {
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

// The block's backward scratch, floats: [n_sdf - 1] gates, features and
// [n_sdf - 1] tangent pre-gates as [TILE][HID] slabs, then [n_sdf] SDF
// layer inputs, [n_sdf - 1] tangent inputs, [n_color] colour and
// [n_relight] relight layer inputs as [TILE][LDS] slabs.
__host__ __device__ long long bwd_scratch_floats(int n_sdf, int n_color, int n_relight) {
  return (2LL * (n_sdf - 1) + 1) * GSLAB + (2LL * n_sdf - 1 + n_color + n_relight) * SLAB;
}

// The pullback of the tile forward_tile<true> has just run, given the
// cotangents of its five outputs in t.CT (the caller's, zeros for a padding
// point; a barrier after): the point and view-dir cotangents to t.PH / t.DH,
// the weight grads added into the block's partial P.
__device__ void backward_tile(const Params& p, const Tile& t, float* gates, float* zt,
                              const Save& sv, float* us, float* P) {
  const int tid = threadIdx.x;
  const float* W = p.w;
  const uint2* WB = p.wb;
  const long long* off = p.off;
  const long long* boff = p.boff;
  const float inv_scale = 1.f / p.scale;

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
    const float* rxl = sv.rx + last * SLAB;
    narrow_back(t, rxl, W + off[W_REL + last], KL, P + off[W_REL + last], P + off[B_REL + last]);
    for (int e = tid; e < TILE * HID; e += THREADS) {
      const int r = e / HID, c = e % HID;
      if (rxl[r * LDS + c] <= 0.f) t.X[r * LDX + c] = 0.f;   // the relu before `last`
      if (last == p.y_in && c < 3) t.CG[r * 3 + c] += t.X[r * LDX + HID + c];
    }
    __syncthreads();
    for (int l = last - 1; l >= 0; --l) {
      const int K = l == 0 ? EMB : (l == p.y_in ? HID + EMB : HID);
      const float* rx = sv.rx + l * SLAB;
      dw_accum<false, false>(rx, t.X, nullptr, nullptr, K, P + off[W_REL + l]);
      bias_accum(t.X, P + off[B_REL + l]);
      product_any(t.X, HID, WB + boff[WT_REL + l], K, [&](int r, int c, float v) {
        if (l == 0) {   // [pts, grad, PE(dirs)]
          if (c < 3) t.PH[r * 3 + c] += v;
          else if (c < 6) t.GH[r * 3 + c - 3] += v;
          else t.VH[r * EMB + c - 6] = v;
        } else if (c < HID) {
          t.X[r * LDX + c] = rx[r * LDS + c] > 0.f ? v : 0.f;
        } else if (c < HID + 3) {   // the y_in layer's gc lanes
          t.CG[r * 3 + c - HID] += v;
        }
      });
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
    const float* cxl = sv.cx + last * SLAB;
    narrow_back(t, cxl, W + off[W_COL + last], HID, P + off[W_COL + last],
                P + off[B_COL + last]);
    for (int e = tid; e < TILE * HID; e += THREADS) {
      const int r = e / HID, c = e % HID;
      if (cxl[r * LDS + c] <= 0.f) t.X[r * LDX + c] = 0.f;
    }
    __syncthreads();
    for (int l = last - 1; l >= 0; --l) {
      const int K = l == 0 ? HID + EMB : HID;
      const float* cx = sv.cx + l * SLAB;
      dw_accum<false, false>(cx, t.X, nullptr, nullptr, K, P + off[W_COL + l]);
      bias_accum(t.X, P + off[B_COL + l]);
      product_any(t.X, HID, WB + boff[WT_COL + l], K, [&](int r, int c, float v) {
        if (l > 0) {
          t.X[r * LDX + c] = cx[r * LDS + c] > 0.f ? v : 0.f;
        } else if (c < HID) {   // [features | pts, grad, PE(dirs)]
          t.X[r * LDX + c] = v;
        } else if (c < HID + 3) {
          t.PH[r * 3 + c - HID] += v;
        } else if (c < HID + 6) {
          t.GH[r * 3 + c - HID - 3] += v;
        } else {
          t.VH[r * EMB + c - HID - 6] = v;
        }
      });
    }
    if (p.color_dv > 0) dirs_pe_vjp(t, p.color_dv);
  }
  // X[:, :256] = feat_hat

  // ---- SDF tangent stream along grad_hat: Y = v0 = scale d emb/d x . grad_hat ----
  for (int e = tid; e < TILE * EMB; e += THREADS) {
    const int r = e / EMB, c = e % EMB;
    float x[3];
    pe_row(p, t, r, x);
    int j;
    const float s = mlp::emb_slope(x, c, p.d0, &j);
    const float v = p.scale * s * t.GH[r * 3 + j];
    t.V0[e] = v;
    t.Y[r * LDX + c] = v;
  }
  __syncthreads();
  for (int l = 0; l < p.n_sdf - 1; ++l) {
    const int K = sdf_k(p, l);
    const bool pre_skip = l + 1 == p.skip;
    save_cols(t.Y, K, us + l * SLAB);
    const float* g = gates + l * GSLAB;
    float* z = zt + l * GSLAB;
    tile_product<HID>(t.Y, K, WB + boff[W_SDF + l], [&](int r, int c, float acc) {
      z[r * HID + c] = acc;
      const float v = g[r * HID + c] * acc;
      t.Y[r * LDX + c] = pre_skip ? v * INV_SQRT2 : v;
    });
    if (pre_skip) {
      for (int e = tid; e < TILE * EMB; e += THREADS)
        t.Y[(e / EMB) * LDX + HID + e % EMB] = t.V0[e] * INV_SQRT2;
      __syncthreads();
    }
  }

  // ---- the last SDF layer: ybar = [sdf_hat / scale, feat_hat], tangent
  // cotangent e0 / scale, uL = Y[:, :256] ----
  {
    const int L1 = p.n_sdf - 1;
    const float* sx = sv.sx + L1 * SLAB;
    {
      // the sdf row: bf16 products, and the rank-1 tangent term in f32
      const int k = tid;   // THREADS == HID
      float s = 0.f, u = 0.f;
      for (int r = 0; r < TILE; ++r) {
        s = fmaf(round_bf16(t.CT[r * 16] * inv_scale), round_bf16(sx[r * LDS + k]), s);
        u += t.Y[r * LDX + k];
      }
      P[off[W_LAST] + k] += s + inv_scale * u;
      if (tid == 0) {
        float sb = 0.f;
        for (int r = 0; r < TILE; ++r) sb += t.CT[r * 16] * inv_scale;
        P[off[B_LAST]] += sb;
      }
    }
    dw_accum<false, false>(sx, t.X, nullptr, nullptr, HID, P + off[W_FEAT]);
    bias_accum(t.X, P + off[B_FEAT]);
    const float* wl = W + off[W_LAST];
    // the tangent cotangent: JAX's bf16 weight row times 1/scale cast to
    // bf16, rounded to bf16
    const float inv_scale_bf = round_bf16(inv_scale);
    tile_product<HID>(t.X, HID, WB + boff[WT_FEAT], [&](int r, int c, float v) {
      const float w = round_bf16(wl[c]);
      t.X[r * LDX + c] = fmaf(round_bf16(t.CT[r * 16] * inv_scale), w, v);
      t.Y[r * LDX + c] = round_bf16(w * inv_scale_bf);
    });
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
    for (int e = tid; e < TILE * HID; e += THREADS) {
      const int r = e / HID, c = e % HID;
      const float gg = g[e], hb = t.X[r * LDX + c], ub = t.Y[r * LDX + c];
      t.X[r * LDX + c] = gg * hb + (ub * z[e]) * (100.f * gg * (1.f - gg));
      t.Y[r * LDX + c] = gg * ub;
    }
    __syncthreads();
    if (l == 0)
      dw_accum<true, true>(sv.sx, t.X, us, t.Y, K, P + off[W_SDF]);
    else
      dw_accum<true, false>(sv.sx + l * SLAB, t.X, us + l * SLAB, t.Y, K, P + off[W_SDF + l]);
    bias_accum(t.X, P + off[B_SDF + l]);
    const uint2* WT = WB + boff[WT_SDF + l];
    // hbar and ubar of layer l's input: the hidden part stays in X / Y, the
    // PE part (the skip layer's last 48 columns, or all of layer 0's) adds
    // to emb_hat / v0_hat
    product_any(t.X, HID, WT, K, [&](int r, int c, float v) {
      if (l == 0) t.EG[r * EMB + c] += v;
      else if (c < HID) t.X[r * LDX + c] = is_skip ? v * INV_SQRT2 : v;
      else t.EG[r * EMB + c - HID] += v * INV_SQRT2;
    });
    product_any(t.Y, HID, WT, K, [&](int r, int c, float v) {
      if (l == 0) t.VH[r * EMB + c] += v;
      else if (c < HID) t.Y[r * LDX + c] = is_skip ? v * INV_SQRT2 : v;
      else t.VH[r * EMB + c - HID] += v * INV_SQRT2;
    });
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

// The backward's shared-memory tile: the forward's, then the backward's
// buffers (SMEM_BWD bytes in all).
__device__ void carve_bwd(Tile& t, unsigned char* smem) {
  carve_fwd(t, smem);
  t.Y = t.S1 + TILE;
  t.VH = t.Y + TILE * LDX;
  t.V0 = t.VH + TILE * EMB;
  t.CT = t.V0 + TILE * EMB;
  t.PH = t.CT + TILE * 16;
  t.DH = t.PH + TILE * 3;
  t.GH = t.DH + TILE * 3;
  t.CG = t.GH + TILE * 3;
  t.HB = t.CG + TILE * 3;
}

// Where the backward keeps its per-block scratch (bwd_scratch_floats floats
// from `base`): the gates, features and tangent pre-gates, the stored layer
// inputs.
struct BwdScratch {
  float* gates;
  float* feat;
  float* zt;
  float* us;
  Save sv;
};

__device__ BwdScratch carve_bwd_scratch(const Params& p, float* base) {
  BwdScratch s;
  s.gates = base;
  s.feat = s.gates + size_t(p.n_sdf - 1) * GSLAB;
  s.zt = s.feat + GSLAB;
  s.sv.sx = s.zt + size_t(p.n_sdf - 1) * GSLAB;
  s.us = s.sv.sx + size_t(p.n_sdf) * SLAB;
  s.sv.cx = s.us + size_t(p.n_sdf - 1) * SLAB;
  s.sv.rx = s.sv.cx + size_t(p.n_color) * SLAB;
  return s;
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

Params make_params(const float* pts, const float* dirs, const float* w, const void* wb,
                   long long n_pts, int n_sdf, int skip, int d0, float scale, int n_color,
                   int color_dv, int squeeze, int n_relight, int rl_dv, int y_in, int inv_sigmoid,
                   const long long* off, const long long* boff) {
  Params p{};
  p.pts = pts;
  p.dirs = dirs;
  p.w = w;
  p.wb = static_cast<const uint2*>(wb);
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
    p.boff[i] = boff[i];
  }
  return p;
}

bool bad_shape(int n_off, int n_sdf, int n_color, int n_relight) {
  return n_off != N_OFF || n_sdf < 2 || n_sdf - 1 > MAXL || n_color < 2 || n_color > MAXL ||
         n_relight > MAXL;
}

}  // namespace
