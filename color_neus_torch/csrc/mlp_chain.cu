// The MLP-chain microbenchmark: the Hopper counterparts of the two TPU
// kernels of tools/mlp_microbench.py.
//   mlp_chain_launch          replaces chain_kernel (:121; run :133, call :137)
//   mlp_chain_deferred_launch replaces chain_kernel_deferred (:103; run_deferred
//                             :165, call :169)
//
// What they compute. x [N, 256] f32, W [256, 256] f32 ([in, out]):
//   chain:    L times x <- act(x @ W), one W for every layer, act one of the
//             nine variants of the tool (template ACT, dispatched from an
//             int); products in bf16 (W rounded to bf16 once, each layer's
//             input cast to bf16, f32 accumulation) or in exact f32 FMAs (no
//             TF32); the activation in f32; out [N, 256] f32.
//   deferred: the bf16 chain with the sp-only softplus; each layer's gate
//             1 - exp(-100 sp) is rebuilt from the previous layer's kept f32
//             output one layer later: acc += gate * gate_w; out = x + acc.
// The gated variants keep their gate as sp + g * gate_w; the tool hard-codes
// gate_w = 1e-30, here it is an argument so that a check can run it at 1.
// Built without --use_fast_math: expf / log1pf / the divide stay IEEE, and
// the gate's product cannot fold away.
//
// Bound on the H100, at the tool's shape (N = 1,048,576 rows, L = 25):
// the products are 2 N 256^2 L = 3.44e12 flop, 3.5 ms at the bf16 tensor
// cores' 989 TFLOP/s (51 ms in f32 at 67 TFLOP/s); the bytes, x read once
// and out written once, 2.1 GB, 0.64 ms at 3.35 TB/s. So the products bound
// the bare chain. The epilogue is a second bound: 6.7e9 activated elements,
// each FP32-pipe instruction per element ~0.2 ms (132 SMs x 128 lanes at
// ~1.98 GHz) and each special-function (MUFU) instruction ~1.6 ms (16 per
// SM); exp + log1p + a divide weigh as much as the products.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work).
// Rows are independent and every layer reads the same W, so a block owns a
// tile of rows and runs all L layers on it: only x in and out leave device
// memory. Blocks are persistent (at most the SM count times the occupancy)
// and walk the tiles, so W is staged once per block.
//  * bf16: W^T in dynamic shared memory as bf16 (128 KB, rows padded to 264
//    so that the fragment loads of 8 rows x 4 lanes hit 32 distinct banks),
//    and the tile's bf16 layer input beside it. 8 warps; warp w computes
//    output columns [32 w, 32 w + 32) of all the tile's rows with
//    mma.sync m16n8k16 bf16 (f32 accumulators in registers), then applies
//    the activation to its accumulators in f32 and writes them back as the
//    next layer's bf16 input (or, after the last layer, to out in f32).
//    Tiles of 64 rows (169 KB of shared memory: one block per SM); the
//    deferred chain keeps prev_sp and acc in registers beside the
//    accumulators, so it takes 32-row tiles to stay clear of spills.
//  * f32: W (256 KB) does not fit in shared memory; it is read through L2
//    by mlp::tile_matmul_f32 (64-row tile, an 8x8 register tile per
//    thread, exact FFMA in k order), the tile's f32 activations in shared
//    memory.
// The ragged last tile reads zeros and stores nothing past N.

#include <cuda_runtime.h>

#include "mlp_common.cuh"

namespace {

constexpr int WD = 256;                  // the chain's width
constexpr int THREADS = 256;             // 8 warps
constexpr int TR = 64;                   // rows per tile: bf16 and f32 chains
constexpr int TR_DEF = 32;               // rows per tile: the deferred chain
constexpr int LDB = WD + 8;              // bf16 row stride of W^T and the input tile
constexpr int LDF = WD + 4;              // f32 row stride of the input tile
constexpr size_t SMEM_W = size_t(WD) * LDB * 2;
constexpr size_t SMEM_BF16 = SMEM_W + size_t(TR) * LDB * 2;
constexpr size_t SMEM_DEF = SMEM_W + size_t(TR_DEF) * LDB * 2;
constexpr size_t SMEM_F32 = size_t(TR) * LDF * 4;

// the tool's variants, in its order (ops/kernels/mlp_chain.py ACTIVATIONS)
enum Act { NONE, RELU, SOFTPLUS, SIGMOID, SP_GATE, SHARED, EXPM1_GATE, RECIP_APPROX,
           RECIP_NEWTON, N_ACT };

struct Chain {
  const float* x;   // [n, 256]
  const float* w;   // [256, 256], [in, out]
  float* out;       // [n, 256]
  long long n;
  int L;
  float gw;         // the gate's weight
};

// the approximate reciprocal of the TPU's pl.reciprocal(approx=True): the
// card's rcp.approx (the CPU rehearsal divides)
__device__ __forceinline__ float rcp_approx(float d) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
#else
  return 1.f / d;
#endif
}

// fields.py softplus beta=100 form: where(100 x > 30, x, log1p(exp(100 x)) * 0.01)
__device__ __forceinline__ float softplus_where(float x) {
  const float bx = x * 100.f;
  return bx > 30.f ? x : log1pf(expf(bx)) * 0.01f;
}

__device__ __forceinline__ float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }

// the shared-exp softplus: max(x, 0) + log1p(exp(-100 |x|)) * 0.01
__device__ __forceinline__ float shared_sp(float x, float* e) {
  *e = expf(-100.f * fabsf(x));
  return fmaxf(x, 0.f) + log1pf(*e) * 0.01f;
}

template <int A>
__device__ __forceinline__ float activate(float x, float gw) {
  if (A == NONE) return x;
  if (A == RELU) return fmaxf(x, 0.f);
  if (A == SOFTPLUS) return softplus_where(x);
  if (A == SIGMOID) return sigmoid_(x);
  if (A == SP_GATE) return softplus_where(x) + sigmoid_(x * 100.f) * gw;
  float e;
  const float sp = shared_sp(x, &e);
  if (A == EXPM1_GATE) return sp + (1.f - expf(-100.f * sp)) * gw;
  const float d = 1.f + e;
  float r;
  if (A == SHARED) {
    r = 1.f / d;
  } else {
    r = rcp_approx(d);
    if (A == RECIP_NEWTON) r = r * (2.f - d * r);
  }
  return sp + (x >= 0.f ? r : 1.f - r) * gw;
}

// One element of the deferred chain's layer l, accumulator a: from l = 1 the
// gate of the previous layer's kept sp joins the gates' sum, then this
// layer's sp is kept.
__device__ __forceinline__ void deferred_step(float a, float& prev, float& gsum, float gw, int l) {
  const float gate = l > 0 ? (1.f - expf(-100.f * prev)) * gw : 0.f;
  gsum = l > 1 ? gsum + gate : gate;
  float e;
  prev = shared_sp(a, &e);
}

__host__ __device__ long long n_tiles(long long n, int rows) { return (n + rows - 1) / rows; }

// ---- f32 products: mlp::tile_matmul_f32 over a 64-row tile ----

template <int A>
__global__ void __launch_bounds__(THREADS, 2) chain_f32_kernel(Chain c) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);  // [TR][LDF]
  const int tid = threadIdx.x, cg = tid & 31, rg = tid >> 5;  // columns cg + 32 j, rows 8 rg + i
  for (long long tile = blockIdx.x; tile < n_tiles(c.n, TR); tile += gridDim.x) {
    const long long r0 = tile * TR;
    for (int e = tid; e < TR * WD; e += THREADS) {
      const int r = e / WD, k = e % WD;
      act[r * LDF + k] = r0 + r < c.n ? c.x[(r0 + r) * WD + k] : 0.f;
    }
    __syncthreads();
    for (int l = 0; l < c.L; ++l) {
      float acc[8][8];
      mlp::tile_matmul_f32<8>(act, LDF, WD, c.w, acc);
      __syncthreads();  // every thread has read act
      const bool last = l + 1 == c.L;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rg * 8 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = activate<A>(acc[i][j], c.gw);
          if (!last) act[r * LDF + cg + 32 * j] = v;
          else if (r0 + r < c.n) c.out[(r0 + r) * WD + cg + 32 * j] = v;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

#if defined(__CUDACC__) && !defined(MLP_CHAIN_PROBE)
// The tensor-core chains and the launches compile only under nvcc; the CPU
// rehearsal (tests/test_torch_mlp_chain_emulated.py) compiles the rest.
namespace {

using mlp::mma_bf16;
using mlp::pack_bf16;

// W^T as bf16 into wt[n][k] (row stride LDB), two k per 32-bit store.
__device__ void stage_w(const float* __restrict__ w, unsigned* wt) {
  for (int e = threadIdx.x; e < (WD / 2) * WD; e += THREADS) {
    const int kk = e / WD, n = e % WD;
    wt[n * (LDB / 2) + kk] = pack_bf16(w[(2 * kk) * WD + n], w[(2 * kk + 1) * WD + n]);
  }
}

// Rows r0 .. r0 + ROWS of x as bf16 into in[r][k] (row stride LDB); zeros past n.
template <int ROWS>
__device__ void load_tile(const Chain& c, long long r0, unsigned* in) {
  const float2* x2 = reinterpret_cast<const float2*>(c.x);
  for (int e = threadIdx.x; e < ROWS * (WD / 2); e += THREADS) {
    const int r = e / (WD / 2), k2 = e % (WD / 2);
    const float2 v = r0 + r < c.n ? x2[(r0 + r) * (WD / 2) + k2] : make_float2(0.f, 0.f);
    in[r * (LDB / 2) + k2] = pack_bf16(v.x, v.y);
  }
}

// acc[i][j][.] = in[16 i .. 16 i + 16, :] @ W[:, n0 + 8 j .. n0 + 8 j + 8] for
// the warp's columns n0 = 32 warp, with the m16n8k16 fragment layouts
// (g = lane / 4, t = lane % 4): A regs rows g / g + 8, k pairs 2t / 2t + 8;
// B regs column g, k pairs 2t / 2t + 8; C rows g / g + 8, columns 2t, 2t + 1.
template <int MT>
__device__ __forceinline__ void tile_mma(const unsigned* in, const unsigned* wt,
                                         float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll 2
  for (int k2 = 0; k2 < WD / 2; k2 += 8) {   // k2 = k0 / 2, 16 k per step
    unsigned b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned* row = wt + (n0 + 8 * j + g) * (LDB / 2) + k2 + t;
      b[j][0] = row[0];
      b[j][1] = row[4];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const unsigned* r_lo = in + (16 * i + g) * (LDB / 2) + k2 + t;
      const unsigned* r_hi = r_lo + 8 * (LDB / 2);
      const unsigned a0 = r_lo[0], a1 = r_hi[0], a2 = r_lo[4], a3 = r_hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
    }
  }
}

// Fragment element q of (i, j): row 16 i + g + 8 (q / 2), column n0 + 8 j + 2 t + q % 2.
template <int MT>
__device__ __forceinline__ void store_bf16(unsigned* in, const float (&v)[MT][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col2 = (n0 + 8 * j) / 2 + t;
      in[(16 * i + g) * (LDB / 2) + col2] = pack_bf16(v[i][j][0], v[i][j][1]);
      in[(16 * i + g + 8) * (LDB / 2) + col2] = pack_bf16(v[i][j][2], v[i][j][3]);
    }
}

template <int MT>
__device__ __forceinline__ void store_out(const Chain& c, long long r0, const float (&v)[MT][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = r0 + 16 * i + g + 8 * h;
        if (r < c.n)
          *reinterpret_cast<float2*>(c.out + r * WD + n0 + 8 * j + 2 * t) =
              make_float2(v[i][j][2 * h], v[i][j][2 * h + 1]);
      }
}

template <int A>
__global__ void __launch_bounds__(THREADS, 1) chain_bf16_kernel(Chain c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* wt = reinterpret_cast<unsigned*>(smem);              // [WD][LDB] bf16
  unsigned* in = reinterpret_cast<unsigned*>(smem + SMEM_W);     // [TR][LDB] bf16
  constexpr int MT = TR / 16;
  stage_w(c.w, wt);
  for (long long tile = blockIdx.x; tile < n_tiles(c.n, TR); tile += gridDim.x) {
    const long long r0 = tile * TR;
    load_tile<TR>(c, r0, in);
    __syncthreads();
    for (int l = 0; l < c.L; ++l) {
      float acc[MT][4][4];
      tile_mma<MT>(in, wt, acc);
      __syncthreads();  // every warp has read the layer's input
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = activate<A>(acc[i][j][q], c.gw);
      if (l + 1 < c.L) {
        store_bf16<MT>(in, acc);
        __syncthreads();
      } else {
        store_out<MT>(c, r0, acc);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) chain_deferred_kernel(Chain c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* wt = reinterpret_cast<unsigned*>(smem);
  unsigned* in = reinterpret_cast<unsigned*>(smem + SMEM_W);     // [TR_DEF][LDB] bf16
  constexpr int MT = TR_DEF / 16;
  stage_w(c.w, wt);
  for (long long tile = blockIdx.x; tile < n_tiles(c.n, TR_DEF); tile += gridDim.x) {
    const long long r0 = tile * TR_DEF;
    load_tile<TR_DEF>(c, r0, in);
    __syncthreads();
    float prev[MT][4][4], gsum[MT][4][4];   // the kept f32 sp, the gates' sum
    for (int l = 0; l < c.L; ++l) {
      float acc[MT][4][4];
      tile_mma<MT>(in, wt, acc);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            deferred_step(acc[i][j][q], prev[i][j][q], gsum[i][j][q], c.gw, l);
      if (l + 1 < c.L) {
        store_bf16<MT>(in, prev);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) prev[i][j][q] += gsum[i][j][q];
    store_out<MT>(c, r0, prev);
  }
}

using Kern = void (*)(Chain);

template <int A>
Kern pick(bool bf16) {
  return bf16 ? chain_bf16_kernel<A> : chain_f32_kernel<A>;
}

Kern chain_kernel_for(int act, bool bf16) {
  switch (act) {
    case NONE: return pick<NONE>(bf16);
    case RELU: return pick<RELU>(bf16);
    case SOFTPLUS: return pick<SOFTPLUS>(bf16);
    case SIGMOID: return pick<SIGMOID>(bf16);
    case SP_GATE: return pick<SP_GATE>(bf16);
    case SHARED: return pick<SHARED>(bf16);
    case EXPM1_GATE: return pick<EXPM1_GATE>(bf16);
    case RECIP_APPROX: return pick<RECIP_APPROX>(bf16);
    case RECIP_NEWTON: return pick<RECIP_NEWTON>(bf16);
    default: return nullptr;
  }
}

// Persistent grid: at most the SM count times the blocks an SM holds.
int launch(Kern kern, const Chain& c, int rows, size_t smem, cudaStream_t st) {
  if (c.n <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return int(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return int(e);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const long long tiles = n_tiles(c.n, rows);
  const long long cap = (long long)sms * per_sm;
  kern<<<unsigned(tiles < cap ? tiles : cap), THREADS, smem, st>>>(c);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each returns 0 or the CUDA error code of the
// set-up or the launch; neither synchronises.
extern "C" int mlp_chain_launch(const float* x, const float* w, float* out, long long n, int L,
                                int act, int bf16, float gate_w, void* stream) {
  const Kern kern = chain_kernel_for(act, bf16 != 0);
  if (kern == nullptr || L < 1) return int(cudaErrorInvalidValue);
  const Chain c{x, w, out, n, L, gate_w};
  return launch(kern, c, TR, bf16 ? SMEM_BF16 : SMEM_F32, static_cast<cudaStream_t>(stream));
}

extern "C" int mlp_chain_deferred_launch(const float* x, const float* w, float* out, long long n,
                                         int L, float gate_w, void* stream) {
  if (L < 1) return int(cudaErrorInvalidValue);
  const Chain c{x, w, out, n, L, gate_w};
  return launch(chain_deferred_kernel, c, TR_DEF, SMEM_DEF, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mlp_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__ && !MLP_CHAIN_PROBE

#ifdef MLP_CHAIN_PROBE
// Instruction probes, never launched: chip_smoke.py builds them alone
// (nvcc -DMLP_CHAIN_PROBE -cubin) and counts in their SASS what one element
// of each epilogue issues on its common path. One element per thread,
// straight-line, the same device functions as the chains, so the count is
// not blurred by the chains' unrolled copies, peeled first layers or
// once-per-tile code.
template <int A>
__global__ void mlp_chain_act_probe(const float* x, float* y, float gw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = activate<A>(x[i], gw);
}
template __global__ void mlp_chain_act_probe<NONE>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<RELU>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<SOFTPLUS>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<SIGMOID>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<SP_GATE>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<SHARED>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<EXPM1_GATE>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<RECIP_APPROX>(const float*, float*, float);
template __global__ void mlp_chain_act_probe<RECIP_NEWTON>(const float*, float*, float);

// the deferred layer with l read at run time, as the chain's loop has it
__global__ void mlp_chain_deferred_probe(const float* a, float* prev, float* gsum, float gw,
                                         int l) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  deferred_step(a[i], prev[i], gsum[i], gw, l);
}
#endif  // MLP_CHAIN_PROBE
