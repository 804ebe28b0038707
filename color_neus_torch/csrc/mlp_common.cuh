// Device code shared by the port's MLP kernels (sdf_rays.cu: the placement
// sweep and the grid SDF; point_pipeline.cu and ray_march.cu: the per-point
// pipeline; mlp_chain.cu: the chain microbenchmark): the positional
// encoding and its derivatives, the softplus(beta=100), the exact f32
// register-tiled layer product over a 64-point tile, and the bf16
// tensor-core instruction with its operand packing.
#pragma once

#include <cuda_runtime.h>
#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace mlp {

constexpr int HID = 256;                 // hidden width (the only one supported)
constexpr int EMB = 48;                  // PE width padded to a multiple of 16
constexpr int TILE = 64;                 // points per block
constexpr int THREADS = 256;             // 8 warps
constexpr float INV_SQRT2 = 0.70710678118654752f;

__device__ __forceinline__ float softplus100(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-100.f * fabsf(x))) / 100.f;
}

// Column c of PE(x): [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]; 0 past d0.
// x is the already scaled point (the SDF's x * scale, or a raw view dir).
__device__ __forceinline__ float emb_value(const float* x, int c, int d0) {
  if (c < 3) return x[c];
  if (c >= d0) return 0.f;
  const int q = c - 3, k = q / 6, m = q % 6;
  const float ph = x[m % 3] * float(1 << k);  // power-of-two scale: exact
  return m < 3 ? sinf(ph) : cosf(ph);
}

// d emb_c / d x_j times the frequency, for the PE's pullback: the column's
// coordinate j, and the factor 2^k cos(ph) (sin column), -2^k sin(ph) (cos
// column) or 1 (raw column); 0 past d0.
__device__ __forceinline__ float emb_slope(const float* x, int c, int d0, int* j) {
  if (c < 3) { *j = c; return 1.f; }
  *j = 0;
  if (c >= d0) return 0.f;
  const int q = c - 3, k = q / 6, m = q % 6;
  *j = m % 3;
  const float f = float(1 << k);
  const float ph = x[m % 3] * f;
  return m < 3 ? f * cosf(ph) : -f * sinf(ph);
}

// d^2 emb_c / d x_j^2 of the column's coordinate j (the PE's second
// derivative, for the backward's tangent seed): 0 for a raw column,
// -4^k sin(ph) (sin column) or -4^k cos(ph) (cos column); 0 past d0.
__device__ __forceinline__ float emb_curvature(const float* x, int c, int d0) {
  if (c < 3 || c >= d0) return 0.f;
  const int q = c - 3, k = q / 6, m = q % 6;
  const float f = float(1 << k);
  const float ph = x[m % 3] * f;
  return m < 3 ? -f * f * sinf(ph) : -f * f * cosf(ph);
}

// acc[i][j] = sum_{k < K} act[(8 rg + i) * lda + k] * W[k * 32 JN + cg + 32 j]
// with rg = warp, cg = lane: the [TILE, 32 JN] product of the tile's
// activations (shared memory, row stride lda) and a row-major [K, 32 JN]
// f32 weight block (device memory, L2-resident across the launch), in exact
// f32 FMAs summed in k order. Activation reads are warp broadcasts; weight
// reads are coalesced.
template <int JN>
__device__ __forceinline__ void tile_matmul_f32(const float* act, int lda, int K,
                                                const float* __restrict__ W,
                                                float (&acc)[8][JN]) {
  const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[8], w[JN];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = act[(rg * 8 + i) * lda + k];
#pragma unroll
    for (int j = 0; j < JN; ++j) w[j] = __ldg(W + size_t(k) * (32 * JN) + cg + 32 * j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// Two f32 values rounded to bf16 (to nearest, ties to even) in one 32-bit
// register: lo in the low half, as an mma fragment pairs the lower index.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<unsigned*>(&v);
}

// x rounded to bf16 (to nearest, ties to even), back in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += A B over one m16n8k16 tile: bf16 operands, f32 accumulators
// (fragment layouts: PTX ISA, mma.m16n8k16 for .bf16). The CPU rehearsal
// of the sources (tests/cuda_emu) supplies mma_m16n8k16_bf16 in software.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
#ifdef __CUDACC__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
#else
  mma_m16n8k16_bf16(d, a0, a1, a2, a3, b0, b1);
#endif
}

}  // namespace mlp
