// Per-point pipeline forward: the Hopper counterpart of the TPU kernel
// color_neus_tpu/ops/pallas/point_pipeline.py::_fwd_kernel (its body is
// _mlp_forward, point_pipeline.py:568-674; launched by
// fused_point_pipeline_fwd, :699-713).
//
// What it computes, per point (pts p, view dir d), in exact f32:
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
// Bound on the H100. At the Color-NeuS widths ~1.45 M MACs per point
// (SDF forward ~0.52 M, reverse ~0.46 M, colour ~0.26 M, relight ~0.21 M;
// chip_smoke.py counts them from the real widths) against 88 bytes of
// input/output per point: bound by operations, f32 FMA at 67 TFLOP/s.
//
// Design (simple first, exact f32; the bf16 / wgmma redesign is a later
// change). One block of 8 warps owns a tile of 64 points; each thread keeps
// an 8x8 (or 8x2, 8x10) register tile of a layer's output and runs exact
// f32 FMAs over one shared-memory activation buffer [64, 308], in place.
// Weights (~5.9 MB f32, packed by the wrapper) stay in device memory,
// L2-resident across the launch. Where the gates live: the 8 hidden
// layers' gates are 8 KB per point in f32, 512 KB for a 64-point tile,
// beyond the 227 KB of shared memory a block can have (a 16-point tile
// would fit but read every weight 4x as often from L2). So each block owns
// a slice of a device-memory scratch (the wrapper allocates it) for its
// tile's gates and features, written once and read once per point (16 KB
// of traffic per point, ~0.7 ms at 131,072 points, below the FMA time);
// blocks loop over tiles, so the scratch is sized by the grid, not by N.
// The activation buffer (79 KB) plus the PE-cotangent tile keep two blocks
// per SM.

#include <cuda_runtime.h>

#include "mlp_common.cuh"

namespace {

using mlp::EMB;
using mlp::HID;
using mlp::INV_SQRT2;
using mlp::THREADS;
using mlp::TILE;
using mlp::emb_value;
using mlp::softplus100;

constexpr int LDX = HID + EMB + 4;       // activation row stride: [h 256 | small 48] + pad
constexpr int MAXL = 16;                 // max layers per network
// slots of the offset table (element offsets into the packed f32 weights)
constexpr int W_SDF = 0, WT_SDF = MAXL, B_SDF = 2 * MAXL, W_COL = 3 * MAXL, B_COL = 4 * MAXL,
              W_REL = 5 * MAXL, B_REL = 6 * MAXL, W_LAST = 7 * MAXL, B_LAST = W_LAST + 1,
              W_FEAT = W_LAST + 2, B_FEAT = W_LAST + 3, N_OFF = W_LAST + 4;

struct Params {
  const float* pts;    // [n, 3]
  const float* dirs;   // [n, 3]
  const float* w;      // packed weights, see off
  float* out;          // [n, 16]
  float* scratch;      // [gridDim.x][n_sdf - 1 gates + 1 features][TILE][HID]
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
};

constexpr size_t SMEM = (size_t(TILE) * LDX + size_t(TILE) * EMB + 6 * TILE * 3 + TILE) * 4;

struct Tile {
  float* X;    // [TILE][LDX] activations
  float* EG;   // [TILE][EMB] PE cotangent
  float* P3;   // [TILE][3] points
  float* D3;   // [TILE][3] view dirs
  float* G3;   // [TILE][3] grad
  float* GC;   // [TILE][3] global colour
  float* DL;   // [TILE][3] delta
  float* RL;   // [TILE][3] relit
  float* S1;   // [TILE] sdf
};

enum Epi { EPI_NONE = 0, EPI_RELU = 1, EPI_SOFTPLUS = 2 };

// dst[:, :256] = epi(X[:, :K] @ W + b): W row-major [K, 256]. EPI_SOFTPLUS
// also stores the gate to `gates` ([TILE][HID]) and scales the value by
// `post`. dst may be X itself: every thread has read X before any writes.
template <int EPI>
__device__ void wide_layer(float* X, int K, const float* __restrict__ W,
                           const float* __restrict__ b, float post, float* gates,
                           float* dst, int ld) {
  float acc[8][8];
  mlp::tile_matmul_f32<8>(X, LDX, K, W, acc);
  __syncthreads();
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = rg * 8 + i, c = cg + 32 * j;
      const float a = acc[i][j] + b[c];
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
    }
  __syncthreads();
}

// out[r][j] = X[r, :K] . W[j, :K] + b[j] for j < n_out (W row-major [n_out, K]).
__device__ void narrow_layer(const float* X, int K, int n_out, const float* __restrict__ W,
                             const float* __restrict__ b, float* out, int ld_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < TILE; r += THREADS / 32) {
    for (int j = 0; j < n_out; ++j) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s = fmaf(X[r * LDX + k], __ldg(W + j * K + k), s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) out[r * ld_out + j] = s + b[j];
    }
  }
  __syncthreads();
}

// One reverse layer: X[:, :256] holds q_l = d raw / d (layer l output) times
// its gate; p = q_l @ W_l^T (WT row-major [256, 32 JN]) is the cotangent of
// layer l's input. Its hidden part, times 1/sqrt(2) at the skip layer and
// times the gate of layer l - 1, becomes q_{l-1} in X; its PE part (the skip
// layer's last 48 columns, or all of layer 0's) adds to EG.
template <int JN>
__device__ void reverse_layer(const Tile& t, const float* __restrict__ WT, bool is_skip,
                              bool is_first, const float* gates_prev) {
  float acc[8][JN];
  mlp::tile_matmul_f32<JN>(t.X, LDX, HID, WT, acc);
  __syncthreads();
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int r = rg * 8 + i, c = cg + 32 * j;
      const float v = acc[i][j];
      if (is_first) {
        if (c < EMB) t.EG[r * EMB + c] += v;
      } else if (c < HID) {
        const float p = is_skip ? v * INV_SQRT2 : v;
        t.X[r * LDX + c] = p * gates_prev[r * HID + c];
      } else if (c < HID + EMB) {
        t.EG[r * EMB + c - HID] += v * INV_SQRT2;
      }
    }
  __syncthreads();
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

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(THREADS, 2) point_pipeline_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile t;
  t.X = reinterpret_cast<float*>(smem);
  t.EG = t.X + TILE * LDX;
  t.P3 = t.EG + TILE * EMB;
  t.D3 = t.P3 + TILE * 3;
  t.G3 = t.D3 + TILE * 3;
  t.GC = t.G3 + TILE * 3;
  t.DL = t.GC + TILE * 3;
  t.RL = t.DL + TILE * 3;
  t.S1 = t.RL + TILE * 3;
  const int tid = threadIdx.x;
  const float* W = p.w;
  const size_t slab = size_t(TILE) * HID;
  float* gates = p.scratch + size_t(blockIdx.x) * p.n_sdf * slab;  // [n_sdf - 1][TILE][HID]
  float* feat = gates + size_t(p.n_sdf - 1) * slab;                // [TILE][HID]
  const long long n_tiles = (p.n_pts + TILE - 1) / TILE;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * TILE;
    if (tid < TILE) {
      const long long i = base + tid;
      const bool ok = i < p.n_pts;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        t.P3[tid * 3 + j] = ok ? p.pts[3 * i + j] : 0.f;
        t.D3[tid * 3 + j] = ok ? p.dirs[3 * i + j] : 0.f;
      }
    }
    __syncthreads();
    // SDF PE: X[:, :48] = PE(p * scale)
    for (int e = tid; e < TILE * EMB; e += THREADS) {
      const int r = e / EMB, c = e % EMB;
      float x[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) x[j] = __fmul_rn(t.P3[r * 3 + j], p.scale);
      t.X[r * LDX + c] = emb_value(x, c, p.d0);
    }
    __syncthreads();

    // ---- SDF forward, gates to the scratch ----
    for (int l = 0; l < p.n_sdf - 1; ++l) {
      const int K = l == 0 ? EMB : (l == p.skip ? HID + EMB : HID);
      const bool pre_skip = l + 1 == p.skip;
      wide_layer<EPI_SOFTPLUS>(t.X, K, W + p.off[W_SDF + l], W + p.off[B_SDF + l],
                               pre_skip ? INV_SQRT2 : 1.f, gates + l * slab, t.X, LDX);
      if (pre_skip) {
        for (int e = tid; e < TILE * EMB; e += THREADS) {
          const int r = e / EMB, c = e % EMB;
          float x[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) x[j] = __fmul_rn(t.P3[r * 3 + j], p.scale);
          t.X[r * LDX + HID + c] = emb_value(x, c, p.d0) * INV_SQRT2;
        }
        __syncthreads();
      }
    }
    // last layer: raw sdf (row 0) and the features (rows 1..256)
    narrow_layer(t.X, HID, 1, W + p.off[W_LAST], W + p.off[B_LAST], t.S1, 1);
    wide_layer<EPI_NONE>(t.X, HID, W + p.off[W_FEAT], W + p.off[B_FEAT], 1.f, nullptr, feat, HID);

    // ---- reverse sweep: q = W_last[0, :] * gate of the last hidden layer ----
    const float* wl = W + p.off[W_LAST];
    const float* g_last = gates + size_t(p.n_sdf - 2) * slab;
    for (int e = tid; e < TILE * HID; e += THREADS) {
      const int r = e / HID, c = e % HID;
      t.X[r * LDX + c] = wl[c] * g_last[r * HID + c];
    }
    for (int e = tid; e < TILE * EMB; e += THREADS) t.EG[e] = 0.f;
    __syncthreads();
    for (int l = p.n_sdf - 2; l >= 0; --l) {
      const float* WT = W + p.off[WT_SDF + l];
      const float* gp = l > 0 ? gates + size_t(l - 1) * slab : nullptr;
      if (l == 0) reverse_layer<2>(t, WT, false, true, gp);
      else if (l == p.skip) reverse_layer<10>(t, WT, true, false, gp);
      else reverse_layer<8>(t, WT, false, false, gp);
    }
    // PE pullback: grad_j = sum_c EG_c d emb_c / d (p_j scale) (the scale
    // of the PE and the 1/scale of the sdf cancel)
    if (tid < TILE) {
      float x[3], g[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 3; ++j) x[j] = __fmul_rn(t.P3[tid * 3 + j], p.scale);
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
    for (int l = 0; l < p.n_color - 1; ++l)
      wide_layer<EPI_RELU>(t.X, l == 0 ? HID + EMB : HID, W + p.off[W_COL + l],
                           W + p.off[B_COL + l], 1.f, nullptr, t.X, LDX);
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
        wide_layer<EPI_RELU>(t.X, K, W + p.off[W_REL + l], W + p.off[B_REL + l], 1.f, nullptr,
                             t.X, LDX);
      }
      const int last = p.n_relight - 1;
      narrow_layer(t.X, last == p.y_in ? HID + EMB : HID, 3, W + p.off[W_REL + last],
                   W + p.off[B_REL + last], t.DL, 3);
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

    // ---- store [sdf, grad, gc, relit, delta, 0, 0, 0] ----
    for (int e = tid; e < TILE * 16; e += THREADS) {
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

}  // namespace

// Plain C interface for ctypes. The blocks the launch may use at once
// (SMs x resident blocks per SM): the wrapper sizes the scratch by it.
extern "C" int point_pipeline_max_blocks(int* n_blocks) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(point_pipeline_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, point_pipeline_fwd_kernel,
                                                      THREADS, SMEM);
  if (e != cudaSuccess) return int(e);
  *n_blocks = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// Returns 0 or the CUDA error code of the attribute call or the launch;
// never synchronises. `off` is a host array of the offset table.
extern "C" int point_pipeline_fwd_launch(
    const float* pts, const float* dirs, const float* w, float* out, float* scratch,
    long long n_pts, int n_blocks, int n_sdf, int skip, int d0, float scale, int n_color,
    int color_dv, int squeeze, int n_relight, int rl_dv, int y_in, int inv_sigmoid,
    const long long* off, int n_off, void* stream) {
  if (n_pts <= 0) return 0;
  if (n_off != N_OFF || n_sdf - 1 > MAXL || n_color > MAXL || n_relight > MAXL)
    return int(cudaErrorInvalidValue);
  Params p{pts, dirs, w, out, scratch, n_pts, n_sdf, skip, d0, scale, n_color, color_dv,
           squeeze, n_relight, rl_dv, y_in, inv_sigmoid, {}};
  for (int i = 0; i < N_OFF; ++i) p.off[i] = off[i];
  cudaError_t e = cudaFuncSetAttribute(point_pipeline_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (e != cudaSuccess) return int(e);
  point_pipeline_fwd_kernel<<<n_blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

extern "C" int point_pipeline_n_off() { return N_OFF; }

extern "C" const char* point_pipeline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
