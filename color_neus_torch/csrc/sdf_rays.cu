// SDF placement sweep: the Hopper counterpart of the TPU kernel
// color_neus_tpu/ops/pallas/sdf_mlp.py::_sdf_rays_kernel (launched by
// make_fused_sdf_rays_fn, sdf_mlp.py:313-390).
//
// What it computes. Per point i of R*S, with ray r = i / S:
//   p = ro_r + rd_r * z_i                       (exact f32, no FMA contraction)
//   emb = PE(p * scale)                         (frequency-major, sin before cos;
//                                                phase in exact f32 in both modes)
//   h = 9-layer softplus(beta=100) MLP, skip input concat[h, emb]/sqrt(2)
//   out_i = h_0 / scale                         (only row 0 of the last layer)
// The activation is softplus or relu (sweep_activation); the dot type is
// bf16 (weights and layer inputs rounded to bf16, products accumulated in
// f32, bias and activation in f32) or exact f32 (sweep_dtype).
// The TPU kernel's bf16 mode also rounds the ray origins and directions
// to bf16 inside its DEFAULT-precision phase dot (sdf_mlp.py:225-230);
// this kernel does not copy that: the phase is exact f32 in both modes.
//
// Bound on the H100. 459,008 MACs per point at the default width against
// 20 bytes of input/output per point, ~45,000 operations per byte: far
// above the card's ~295 ops/byte balance, so the sweep is bound by
// operations: the bf16 tensor cores (989 TFLOP/s) in bf16 mode, f32 FMA
// (67 TFLOP/s) in f32 mode. The ~2,000 softplus evaluations per point
// (exp + log1p on the special-function units) are a second limit close to
// the tensor-core one.
//
// Design (simple first, made fast in a later change). One block of 8
// warps owns a tile of 64 points and carries it through every layer; its
// activations never leave shared memory, only 20 bytes per point touch
// device memory. Weights (~0.9 MB bf16 / ~1.8 MB f32, packed [in, out] by
// the wrapper) are read from global memory, where they stay L2-resident
// across the blocks of a launch.
//  * bf16: warp w computes columns [32w, 32w+32) of the [64, 256] layer
//    output with WMMA 16x16x16 bf16 tensor-core tiles (B fragments straight
//    from L2, A fragments from the bf16 activation tile), stores the f32
//    accumulators to a staging tile, and the block applies bias +
//    activation in f32 and rounds the next layer's input to bf16.
//  * f32: each thread keeps an 8x8 register tile of the layer output and
//    runs exact f32 FMAs (no TF32), then applies bias + activation in place.
// The PE columns are padded 39 -> 48 and the layer before the skip 217 ->
// 256 with zero weight rows/columns, so every hidden activation is 256
// wide; the skip layer reads [h (256), emb (48)] = 304 columns. The tail
// tile is masked: rows past R*S read z = 0 and store nothing.
//
// Second entry, the grid SDF (sdf_points_launch): the Hopper counterpart of
// sdf_mlp.py::_sdf_mlp_kernel (make_fused_sdf_fn, sdf_mlp.py:237-304), the
// mesh extraction's per-voxel SDF. The same kernels with the points read
// from an [N, 3] array instead of built from rays (template POINTS),
// softplus only, in exact f32 (extract_precision 'f32', where the SDF error
// sets the vertex accuracy) or bf16. Its bound is the sweep's: 459,008 MACs
// per point against 16 bytes of input/output, bound by operations.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "mlp_common.cuh"

using namespace nvcuda;

namespace {

using mlp::EMB;
using mlp::HID;
using mlp::INV_SQRT2;
using mlp::THREADS;
using mlp::TILE;
using mlp::emb_value;
using mlp::softplus100;

// Row strides padded so consecutive rows start 16 B apart modulo the 128 B
// of the 32 shared-memory banks: the 8 rows a WMMA fragment load reads at
// once then hit distinct banks (an unpadded 256/304-wide row would put them
// all on the same 4 banks). Fragment base pointers stay 32 B aligned.
constexpr int LDA_H = HID + EMB + 8;     // bf16 activation row stride (624 B)
constexpr int LDS = HID + 4;             // f32 staging row stride (1040 B)
constexpr int LDA_F = HID + EMB + 4;     // f32 activation row stride
constexpr size_t SMEM_BF16 = size_t(TILE) * LDA_H * 2 + size_t(TILE) * LDS * 4 + TILE * 3 * 4;
constexpr size_t SMEM_F32 = size_t(TILE) * LDA_F * 4 + TILE * 3 * 4;

struct Params {
  const float* rays_o;  // [R, 3]  (sweep)
  const float* rays_d;  // [R, 3]  (sweep)
  const float* z;       // [R * S] (sweep)
  const float* pts;     // [n_pts, 3] (grid SDF)
  const void* w;        // packed weights (bf16 or f32), see the wrapper
  const float* bias;    // [n_lin, HID]
  float* out;           // [R * S]
  long long n_pts;
  int S;                // samples per ray (sweep; 1 for the grid SDF)
  int n_lin;
  int skip;             // index of the skip layer, -1 for none
  int d0;               // real PE width (3 + 6 * multires)
  float scale;
};

template <bool RELU>
__device__ __forceinline__ float activate(float x) {
  return RELU ? fmaxf(x, 0.f) : softplus100(x);
}

// p * scale for the tile's points into xs[TILE][3]: p = ro + rd * z for the
// sweep, the given points for the grid SDF (POINTS).
template <bool POINTS>
__device__ void load_points(const Params& p, long long base, float* xs) {
  const int t = threadIdx.x;
  if (t < TILE) {
    const long long i = base + t;
    float x[3] = {0.f, 0.f, 0.f};
    if (i < p.n_pts) {
      if (POINTS) {
#pragma unroll
        for (int j = 0; j < 3; ++j) x[j] = __fmul_rn(p.pts[3 * i + j], p.scale);
      } else {
        const long long r = i / p.S;
        const float zz = p.z[i];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          x[j] = __fmul_rn(__fadd_rn(p.rays_o[3 * r + j], __fmul_rn(p.rays_d[3 * r + j], zz)),
                           p.scale);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) xs[t * 3 + j] = x[j];
  }
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T to_operand(float v);
template <>
__device__ __forceinline__ float to_operand<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_operand<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// act[:, col0 : col0+EMB] = operand(emb * mult)
template <typename T, int LD>
__device__ void write_emb(T* act, const float* xs, int col0, float mult, int d0) {
  for (int e = threadIdx.x; e < TILE * EMB; e += THREADS) {
    const int r = e / EMB, c = e % EMB;
    act[r * LD + col0 + c] = to_operand<T>(emb_value(xs + r * 3, c, d0) * mult);
  }
}

// Last layer, output row 0 only: out = (act[r, :HID] . w + b) / scale.
template <typename T, int LD>
__device__ void final_layer(const Params& p, const T* act, const T* w, long long base) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float b = p.bias[(p.n_lin - 1) * HID];
  for (int r = warp; r < TILE; r += THREADS / 32) {
    float s = 0.f;
    for (int k = lane; k < HID; k += 32)
      s = fmaf(as_float(act[r * LD + k]), as_float(w[k]), s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && base + r < p.n_pts) p.out[base + r] = (s + b) / p.scale;
  }
}

__device__ __forceinline__ int layer_k(const Params& p, int l) {
  return l == 0 ? EMB : (l == p.skip ? HID + EMB : HID);
}

template <bool RELU, bool POINTS>
__global__ void __launch_bounds__(THREADS, 2) sdf_rays_bf16_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);          // [TILE][LDA_H]
  float* stage = reinterpret_cast<float*>(smem + size_t(TILE) * LDA_H * 2);  // [TILE][LDS]
  float* xs = stage + TILE * LDS;                                        // [TILE][3]
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(p.w);

  load_points<POINTS>(p, base, xs);
  __syncthreads();
  write_emb<__nv_bfloat16, LDA_H>(act, xs, 0, 1.f, p.d0);
  __syncthreads();

  size_t off = 0;
  for (int l = 0; l < p.n_lin - 1; ++l) {
    const int K = layer_k(p, l);
    const __nv_bfloat16* Wl = W + off;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::fill_fragment(acc[i][0], 0.f);
      wmma::fill_fragment(acc[i][1], 0.f);
    }
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b0, b1;
      wmma::load_matrix_sync(b0, Wl + size_t(k0) * HID + warp * 32, HID);
      wmma::load_matrix_sync(b1, Wl + size_t(k0) * HID + warp * 32 + 16, HID);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, act + i * 16 * LDA_H + k0, LDA_H);
        wmma::mma_sync(acc[i][0], a, b0, acc[i][0]);
        wmma::mma_sync(acc[i][1], a, b1, acc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(stage + i * 16 * LDS + warp * 32, acc[i][0], LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(stage + i * 16 * LDS + warp * 32 + 16, acc[i][1], LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();  // every warp has read act and written stage
    const float* bl = p.bias + l * HID;
    const float post = (l + 1 == p.skip) ? INV_SQRT2 : 1.f;
    for (int e = tid; e < TILE * HID; e += THREADS) {
      const int r = e / HID, c = e % HID;
      const float v = activate<RELU>(stage[r * LDS + c] + bl[c]);
      act[r * LDA_H + c] = __float2bfloat16_rn(v * post);
    }
    if (l + 1 == p.skip) write_emb<__nv_bfloat16, LDA_H>(act, xs, HID, INV_SQRT2, p.d0);
    __syncthreads();
    off += size_t(K) * HID;
  }
  final_layer<__nv_bfloat16, LDA_H>(p, act, W + off, base);
}

template <bool RELU, bool POINTS>
__global__ void __launch_bounds__(THREADS, 2) sdf_rays_f32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);  // [TILE][LDA_F]
  float* xs = act + TILE * LDA_F;               // [TILE][3]
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;  // columns cg + 32 j, rows 8 rg + i
  const long long base = (long long)blockIdx.x * TILE;
  const float* W = static_cast<const float*>(p.w);

  load_points<POINTS>(p, base, xs);
  __syncthreads();
  write_emb<float, LDA_F>(act, xs, 0, 1.f, p.d0);
  __syncthreads();

  size_t off = 0;
  for (int l = 0; l < p.n_lin - 1; ++l) {
    const int K = layer_k(p, l);
    const float* Wl = W + off;
    float acc[8][8];
    mlp::tile_matmul_f32<8>(act, LDA_F, K, Wl, acc);
    __syncthreads();  // every thread has read act
    const float* bl = p.bias + l * HID;
    const float post = (l + 1 == p.skip) ? INV_SQRT2 : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 32 * j;
        act[(rg * 8 + i) * LDA_F + c] = activate<RELU>(acc[i][j] + bl[c]) * post;
      }
    if (l + 1 == p.skip) write_emb<float, LDA_F>(act, xs, HID, INV_SQRT2, p.d0);
    __syncthreads();
    off += size_t(K) * HID;
  }
  final_layer<float, LDA_F>(p, act, W + off, base);
}

}  // namespace

namespace {

int launch(const Params& p, bool bf16, bool relu, bool points, cudaStream_t st) {
  if (p.n_pts <= 0) return 0;
  const dim3 grid(unsigned((p.n_pts + TILE - 1) / TILE));
  void (*kern)(Params);
  size_t smem;
  if (bf16) {
    kern = points ? sdf_rays_bf16_kernel<false, true>
                  : relu ? sdf_rays_bf16_kernel<true, false>
                         : sdf_rays_bf16_kernel<false, false>;
    smem = SMEM_BF16;
  } else {
    kern = points ? sdf_rays_f32_kernel<false, true>
                  : relu ? sdf_rays_f32_kernel<true, false>
                         : sdf_rays_f32_kernel<false, false>;
    smem = SMEM_F32;
  }
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<grid, THREADS, smem, st>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each returns 0 or the CUDA error code of the
// attribute call or the launch; neither synchronises.
extern "C" int sdf_rays_launch(const float* rays_o, const float* rays_d, const float* z,
                               const void* w, const float* bias, float* out,
                               long long n_pts, int S, int n_lin, int skip, int d0,
                               float scale, int bf16, int relu, void* stream) {
  Params p{rays_o, rays_d, z, nullptr, w, bias, out, n_pts, S, n_lin, skip, d0, scale};
  return launch(p, bf16, relu, false, static_cast<cudaStream_t>(stream));
}

// The grid SDF (softplus only): out[i] = sdf(pts[i]) for n_pts points.
extern "C" int sdf_points_launch(const float* pts, const void* w, const float* bias, float* out,
                                 long long n_pts, int n_lin, int skip, int d0, float scale,
                                 int bf16, void* stream) {
  Params p{nullptr, nullptr, nullptr, pts, w, bias, out, n_pts, 1, n_lin, skip, d0, scale};
  return launch(p, bf16, false, true, static_cast<cudaStream_t>(stream));
}

extern "C" const char* sdf_rays_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
