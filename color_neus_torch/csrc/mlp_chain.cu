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
// Design. Rows are independent and every layer reads the same W, so a
// tile of 64 rows runs all L layers on chip: only x in and out leave
// device memory. Blocks are persistent (one per SM) and walk their tiles.
//  * bf16 chains (mlp_chain_launch with bf16 = 1; mlp_chain_deferred_launch)
//    on wgmma. The causes the mma.sync design had, and what this does:
//    - W on chip in wgmma's layout, fetched asynchronously: the wrapper
//      packs W once per call into the byte image a wgmma B descriptor
//      reads (bf16 W^T, K-major, four 64-k blocks of 256 rows x 128 bytes,
//      the 128-byte swizzle: ops/kernels/mlp_chain.py pack_w_image); each
//      block fetches the 128 KB image with 8 bulk copies on one mbarrier
//      (mlp::bulk_load), no convert-and-transpose loop.
//    - Products on wgmma: m64n128k16 bf16 -> f32, each layer as two
//      halves of 128 columns, 16 k-steps each, A and B from shared memory.
//      A is the tile's bf16 layer input in the same swizzled layout (four
//      8 KB k blocks), written by the epilogue; A from registers (the D ->
//      A fragment identity, as FA3 feeds P) would spare those stores, but
//      64 packed A registers beside the accumulators and the kept half
//      leave no room under the 168 registers of 3 warpgroups, nor beside
//      the deferred chain's sums.
//    - Epilogue overlapping products (the chain): three consumer
//      warpgroups (384 threads, no producer: W is fetched once), each on
//      its own 64-row tile, in ping-pong: named barriers 1-3 pass the turn
//      to issue products round the warpgroups, so while one warpgroup's
//      products run the others apply the activation to their 64
//      accumulators in registers. Half 0's activated output waits packed
//      in 32 registers until half 1's products have read the tile, then
//      both are written in place.
//    - Budgets: 64 accumulators + 32 kept a thread under the 168 registers
//      that 384 threads leave (the m64n256 form's 128 accumulators spilled
//      in the gated variants at 2 warpgroups). Shared memory: W 128 KB + 3
//      x 32 KB of A tiles (+ 1 KB of alignment slack), 225 KB of the 227;
//      x is read straight from device memory into the A tile (16-byte
//      loads, coalesced, once per 25 layers), with no f32 staging buffer.
//      The epilogue, not the products, sets the pace: its expf / log1pf
//      and the where's and the divide's branches run element after element,
//      so warps, not instruction-level parallelism, hide their latency, and
//      the shared memory allows three tiles in flight.
//    - The deferred chain keeps its gates' f32 sum, one per output element:
//      128 registers a thread if a warpgroup owned a tile, which left no
//      room (255 registers and spills, measured). Its two warpgroups share
//      one tile instead, warpgroup h its columns 128 h .. 128 h + 128 (64
//      accumulators and 64 sums a thread, no spills), and meet before the
//      next layer's input is written in place; its products do not overlap
//      its epilogue. The gate of layer l's kept sp joins the sum in layer
//      l's own epilogue (for l < L - 1), where the mma.sync design added it
//      one layer later from a kept copy: the same f32 values added in the
//      same order (gate(sp_0) + gate(sp_1) + ... + gate(sp_{L-2}), then
//      sp_{L-1} + gsum), so the output is bitwise the same, and no copy of
//      sp is carried across the products.
//    - The epilogue's arithmetic is the same device functions (activate<A>,
//      deferred_step), IEEE expf / log1pf / divide, no --use_fast_math.
//    - No branch around the products: a warpgroup whose tile lies wholly
//      past N runs on zeros and stores nothing (ptxas serialises wgmma in a
//      possibly divergent path, waiting for each one).
//  * f32 (bf16 = 0): W (256 KB) does not fit in shared memory; it is read
//    through L2 by mlp::tile_matmul_f32 (64-row tile, an 8x8 register
//    tile per thread, exact FFMA in k order), the tile's f32 activations
//    in shared memory, 2 blocks of 8 warps per SM.
// The ragged last tile reads zeros and stores nothing past N.

#include <cuda_runtime.h>

#include "mlp_common.cuh"

namespace {

constexpr int WD = 256;                  // the chain's width
constexpr int THREADS = 256;             // the f32 chain's 8 warps
constexpr int TR = 64;                   // rows per tile
constexpr int LDF = WD + 4;              // f32 row stride of the f32 chain's tile
constexpr int KB = 64;                   // k per 128-byte-swizzled block
constexpr int W_KBLOCK = WD * 128;       // bytes of one k block of the W image (32 KB)
constexpr int A_KBLOCK = TR * 128;       // bytes of one k block of an A tile (8 KB)
constexpr int W_IMAGE = WD * WD * 2;     // the packed W image (128 KB)
constexpr int ALIGN = 1024;              // the swizzle's atom: descriptors need it
constexpr size_t SMEM_F32 = size_t(TR) * LDF * 4;

// the tool's variants, in its order (ops/kernels/mlp_chain.py ACTIVATIONS)
enum Act { NONE, RELU, SOFTPLUS, SIGMOID, SP_GATE, SHARED, EXPM1_GATE, RECIP_APPROX,
           RECIP_NEWTON, N_ACT };

struct Chain {
  const float* x;   // [n, 256]
  const float* w;   // [256, 256], [in, out] (f32 chain)
  const void* wimg; // the packed bf16 W image (bf16 chains)
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

// One element of the deferred chain's layer l of L, accumulator a: this
// layer's sp is kept, and for l < L - 1 its gate joins the gates' sum (the
// first one starts it), as the next layer's epilogue would add it.
__device__ __forceinline__ void deferred_step(float a, float& sp, float& gsum, float gw, int l,
                                              int L) {
  float e;
  sp = shared_sp(a, &e);
  if (l + 1 < L) {
    const float gate = (1.f - expf(-100.f * sp)) * gw;
    gsum = l > 0 ? gsum + gate : gate;
  }
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

#ifndef MLP_CHAIN_PROBE
namespace {

using mlp::pack_bf16;

constexpr int WG_THREADS = 128;          // a warpgroup

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  const unsigned mis = unsigned(__cvta_generic_to_shared(smem)) & (ALIGN - 1);
  return smem + ((ALIGN - mis) & (ALIGN - 1));
}

// Thread 0 fetches the W image into w_s with 8 bulk copies on *bar; every
// thread waits for it before its first product (mlp::mbar_wait(bar, 0)).
__device__ __forceinline__ void fetch_w(const Chain& c, unsigned char* w_s,
                                        unsigned long long* bar) {
  if (threadIdx.x == 0) {
    mlp::mbar_init(bar, 8);
    mlp::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < 8; ++i)
      mlp::bulk_load(w_s + i * (W_IMAGE / 8),
                     static_cast<const unsigned char*>(c.wimg) + i * (W_IMAGE / 8), W_IMAGE / 8,
                     bar);
}

// The chain: 3 warpgroups a block, each on its own 64-row tile, 4 k blocks
// (32 KB) of A tile each; the deferred chain: 2 warpgroups on one tile,
// one half of its columns each. One block per SM either way.
constexpr int NWG = 3;
constexpr int CHAIN_THREADS = NWG * WG_THREADS, DEF_THREADS = 2 * WG_THREADS;
constexpr size_t SMEM_CHAIN = ALIGN + W_IMAGE + size_t(NWG) * 4 * A_KBLOCK + 16;
constexpr size_t SMEM_DEF = ALIGN + W_IMAGE + size_t(4) * A_KBLOCK + 16;

// Rows r0 .. r0 + 64 of x as bf16 into an A tile (k block b at a + 8 KB b),
// zeros past n, by `threads` threads from thread t: one 16-byte load of 4
// columns per thread and step, neighbouring threads on neighbouring columns.
__device__ __forceinline__ void load_x(const Chain& c, long long r0, unsigned char* a, int t,
                                       int threads) {
  const float4* x4 = reinterpret_cast<const float4*>(c.x);
#pragma unroll 4
  for (int idx = t; idx < TR * WD / 4; idx += threads) {
    const int r = idx / (WD / 4), k = 4 * (idx % (WD / 4));
    const float4 v = r0 + r < c.n ? x4[(r0 + r) * (WD / 4) + k / 4] : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<uint2*>(a + (k / KB) * A_KBLOCK + mlp::sw128_offset(r, k % KB)) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The warpgroup's products of 128 columns of a layer: acc = A W[:, n0 ..
// n0 + 128] over 16 k-steps of m64n128k16, A's k block b at a + 8 KB b.
__device__ __forceinline__ void half_products(float (&acc)[64], const unsigned char* a,
                                              const unsigned char* w_s, int n0) {
  mlp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WD / 16; ++kk) {
    const unsigned long long da = mlp::wgmma_desc(a + (kk / 4) * A_KBLOCK + (kk % 4) * 32);
    const unsigned long long db =
        mlp::wgmma_desc(w_s + (kk / 4) * W_KBLOCK + n0 * 128 + (kk % 4) * 32);
    mlp::wgmma_m64n128k16_bf16(acc, da, db, kk > 0);
  }
  mlp::wgmma_commit();
}

// The turn to issue products passes round the chain's warpgroups (barrier
// 1 + wg: warpgroup wg's turn, 128 waiting + 128 passing threads);
// warpgroup 0 takes the first, which the last one passes before its loop.
// The last warpgroup does not pass after the block's final issue, so each
// barrier sees as many arrivals as waits.
__device__ __forceinline__ void turn_wait(int wg) { mlp::bar_sync(1 + wg, 2 * WG_THREADS); }
__device__ __forceinline__ void turn_pass(int wg, bool last) {
  if (!(wg == NWG - 1 && last)) mlp::bar_arrive(1 + (wg + 1) % NWG, 2 * WG_THREADS);
}

// The activated accumulators of a half as bf16 pairs: pk[2 j + h] holds
// row g + 8 h, columns 8 j + 2 q and 8 j + 2 q + 1 of the fragment.
__device__ __forceinline__ void pack_half(const float (&v)[64], unsigned (&pk)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pk[2 * j] = pack_bf16(v[4 * j], v[4 * j + 1]);
    pk[2 * j + 1] = pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

// Columns 64 J .. 64 J + 64 of a packed half (8 n8 groups from group 8 J)
// into one k block of the next layer's A tile; conflict-free: the 32 lanes
// hit 8 rows x 4 words, the chunk XORed by the row.
template <int J>
__device__ __forceinline__ void store_kblock(unsigned char* blk, const unsigned (&pk)[32]) {
  const int t = threadIdx.x & (WG_THREADS - 1), r = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = 8 * J + jj;
    *reinterpret_cast<unsigned*>(blk + mlp::sw128_offset(r, 8 * jj + 2 * q)) = pk[2 * j];
    *reinterpret_cast<unsigned*>(blk + mlp::sw128_offset(r + 8, 8 * jj + 2 * q)) = pk[2 * j + 1];
  }
}

// The half's 128 columns from n0, rows r0 .. r0 + 64 of out (f32).
__device__ __forceinline__ void store_out(const Chain& c, long long r0, int n0,
                                          const float (&v)[64]) {
  const int t = threadIdx.x & (WG_THREADS - 1), q = t & 3;
  const long long r = r0 + 16 * (t >> 5) + ((t & 31) >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < c.n)
        *reinterpret_cast<float2*>(c.out + (r + 8 * h) * WD + n0 + 8 * j + 2 * q) =
            make_float2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
}

// Shared-memory writes into an A tile made visible to the next wgmma, then
// barrier id over n threads (the chain's warpgroup wg: its own, 1 + NWG +
// wg).
__device__ __forceinline__ void a_tile_ready(int id, int n) {
  mlp::fence_proxy_async();
  mlp::bar_sync(id, n);
}

// The chain, activation A. Warpgroup wg of a block owns tile NWG p + wg of
// each group p of NWG tiles the block walks; each layer runs as two halves
// of 128 columns, half 0's output waiting in 32 registers until half 1's
// products are done, then the next layer's input written in place.
template <int A>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) chain_bf16_kernel(Chain c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w_s = aligned_smem(smem);
  const int wg = threadIdx.x / WG_THREADS;
  unsigned char* const a = w_s + W_IMAGE + wg * 4 * A_KBLOCK;
  auto* bar = reinterpret_cast<unsigned long long*>(w_s + W_IMAGE + NWG * 4 * A_KBLOCK);
  fetch_w(c, w_s, bar);
  mlp::mbar_wait(bar, 0);
  if (wg == NWG - 1) mlp::bar_arrive(1, 2 * WG_THREADS);   // warpgroup 0 takes the first turn
  const long long groups = n_tiles(c.n, NWG * TR);
  for (long long p = blockIdx.x; p < groups; p += gridDim.x) {
    const bool last_group = p + gridDim.x >= groups;
    load_x(c, (NWG * p + wg) * TR, a, threadIdx.x & (WG_THREADS - 1), WG_THREADS);
    a_tile_ready(1 + NWG + wg, WG_THREADS);
    for (int l = 0; l < c.L; ++l) {
      const bool last_layer = l + 1 == c.L;
      unsigned pk0[32];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float acc[64];
        turn_wait(wg);
        half_products(acc, a, w_s, 128 * h);
        turn_pass(wg, last_group && last_layer && h == 1);
        mlp::wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = activate<A>(acc[i], c.gw);
        if (last_layer) {
          store_out(c, (NWG * p + wg) * TR, 128 * h, acc);
        } else if (h == 0) {
          pack_half(acc, pk0);
        } else {   // both halves' products done: the next layer's input in place
          unsigned pk1[32];
          pack_half(acc, pk1);
          store_kblock<0>(a, pk0);
          store_kblock<1>(a + A_KBLOCK, pk0);
          store_kblock<0>(a + 2 * A_KBLOCK, pk1);
          store_kblock<1>(a + 3 * A_KBLOCK, pk1);
          a_tile_ready(1 + NWG + wg, WG_THREADS);
        }
      }
    }
  }
}

// The deferred chain. Its gates' f32 sum, one per output element, would
// take 128 registers a thread beside the accumulators if a warpgroup
// owned a tile; here the block's two warpgroups share one 64-row tile,
// warpgroup h its columns 128 h .. 128 h + 128 (64 accumulators and 64
// sums a thread). Both meet on barrier 1 before the next layer's input is
// written in place (both halves' products done) and after it.
__global__ void __launch_bounds__(DEF_THREADS, 1) chain_deferred_kernel(Chain c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w_s = aligned_smem(smem);
  const int h = threadIdx.x / WG_THREADS;
  unsigned char* const a = w_s + W_IMAGE;
  auto* bar = reinterpret_cast<unsigned long long*>(w_s + W_IMAGE + 4 * A_KBLOCK);
  fetch_w(c, w_s, bar);
  mlp::mbar_wait(bar, 0);
  for (long long tile = blockIdx.x; tile < n_tiles(c.n, TR); tile += gridDim.x) {
    mlp::bar_sync(1, DEF_THREADS);   // the previous tile's products are done
    load_x(c, tile * TR, a, threadIdx.x, DEF_THREADS);
    a_tile_ready(1, DEF_THREADS);
    float gsum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) gsum[i] = 0.f;
    for (int l = 0; l < c.L; ++l) {
      float acc[64];
      half_products(acc, a, w_s, 128 * h);
      mlp::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) deferred_step(acc[i], acc[i], gsum[i], c.gw, l, c.L);
      if (l + 1 == c.L) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += gsum[i];
        store_out(c, tile * TR, 128 * h, acc);
      } else {
        unsigned pk[32];
        pack_half(acc, pk);
        mlp::bar_sync(1, DEF_THREADS);   // both halves' products done
        store_kblock<0>(a + 2 * h * A_KBLOCK, pk);
        store_kblock<1>(a + (2 * h + 1) * A_KBLOCK, pk);
        a_tile_ready(1, DEF_THREADS);
      }
    }
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

// Persistent grid: at most the SM count times the blocks an SM holds; a
// block walks units of `rows` rows (a bf16 chain block: a group of tiles).
int launch(Kern kern, const Chain& c, int rows, size_t smem, int threads, cudaStream_t st) {
  if (c.n <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return int(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return int(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return int(e);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const long long tiles = n_tiles(c.n, rows);
  const long long cap = (long long)sms * per_sm;
  kern<<<unsigned(tiles < cap ? tiles : cap), threads, smem, st>>>(c);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Each returns 0 or the CUDA error code of the
// set-up or the launch; neither synchronises.
// w: W [256, 256] f32 (the f32 chain); wimg: W's packed bf16 image (the
// bf16 chains; ops/kernels/mlp_chain.py pack_w_image), 16-byte aligned.
extern "C" int mlp_chain_launch(const float* x, const float* w, const void* wimg, float* out,
                                long long n, int L, int act, int bf16, float gate_w,
                                void* stream) {
  const Kern kern = chain_kernel_for(act, bf16 != 0);
  if (kern == nullptr || L < 1) return int(cudaErrorInvalidValue);
  const Chain c{x, w, wimg, out, n, L, gate_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch(kern, c, NWG * TR, SMEM_CHAIN, CHAIN_THREADS, st)
              : launch(kern, c, TR, SMEM_F32, THREADS, st);
}

extern "C" int mlp_chain_deferred_launch(const float* x, const void* wimg, float* out,
                                         long long n, int L, float gate_w, void* stream) {
  if (L < 1) return int(cudaErrorInvalidValue);
  const Chain c{x, nullptr, wimg, out, n, L, gate_w};
  return launch(chain_deferred_kernel, c, TR, SMEM_DEF, DEF_THREADS,
                static_cast<cudaStream_t>(stream));
}

extern "C" const char* mlp_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // !MLP_CHAIN_PROBE

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

// the deferred layer with l and L read at run time, as the chain's loop has them
__global__ void mlp_chain_deferred_probe(const float* a, float* sp, float* gsum, float gw, int l,
                                         int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  deferred_step(a[i], sp[i], gsum[i], gw, l, L);
}
#endif  // MLP_CHAIN_PROBE
