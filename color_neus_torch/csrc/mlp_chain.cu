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
//             input cast to bf16, f32 accumulation) or in f32 as JAX's f32
//             dot computes it (Precision.HIGHEST: six bf16 passes over
//             hi / mid / lo parts of both operands, f32 accumulation); the
//             activation in f32; out [N, 256] f32.
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
// cores' 989 TFLOP/s (f32: 20.8 ms as six passes, 51 ms as SIMT FFMA at 67
// TFLOP/s); the bytes, x read once
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
//  * f32 (bf16 = 0) on wgmma: JAX's f32 product as six bf16 passes
//    (mlp_common.cuh hp_part, load_a3, and unbias_truncated's nudge, as
//    rows 3-6 sum in MARCH_BWD_PRECISION f32). Its three-part W image
//    (512 KB: a k16 step's hi, mid and lo at 32-byte offsets of a 128-byte
//    row, then 16 zero k) does not fit in shared memory, so it streams from
//    L2 in 16 KB slabs, once per layer per block. What holds it back and
//    what this does:
//    - L2 bytes: a slab serves 1.5 flop a byte per row it meets; two
//      warpgroups, each on its own 64-row tile, share every slab (128
//      rows: 107 GB a call at the tool's shape), through a 5-stage ring
//      thread 0 keeps 3 slabs ahead.
//    - A's parts: built in registers per k16 step from the f32 tile
//      (load_a3), once per step for both 128-column chunks: each layer runs
//      k outer, its 256 outputs in 128 registers a thread until the last
//      step, then written to the tile in place (no stage: a warp reads and
//      writes only its own 16 rows) and activated from there.
//    - The wait: the two warpgroups take turns to issue (named barriers),
//      so one's six m64n128k16 passes run while the other waits for its
//      own and nudges them into its totals.
//    - The nudge: unbias_truncated_ffma, three instructions an output
//      where unbias_truncated takes seven (these instructions set the
//      pace: the nudge alone cost 4.7 of 48 ms in a 64-column design).
//    - Budgets: 2 warpgroups, 254 registers (128 totals, 64
//      accumulators, 12 A parts), no spills; shared memory 2 tiles of 64 x
//      264 f32 + 5 x 16 KB + 1 KB of alignment slack, 216 KB of the 227.
//    The epilogue is the bf16 chains' activate<A>.
// The ragged last tile reads zeros and stores nothing past N.

#include <cuda_runtime.h>

#include "mlp_common.cuh"

namespace {

constexpr int WD = 256;                  // the chain's width
constexpr int TR = 64;                   // rows per tile
constexpr int KB = 64;                   // k per 128-byte-swizzled block
constexpr int W_KBLOCK = WD * 128;       // bytes of one k block of the W image (32 KB)
constexpr int A_KBLOCK = TR * 128;       // bytes of one k block of an A tile (8 KB)
constexpr int W_IMAGE = WD * WD * 2;     // the packed W image (128 KB)
constexpr int ALIGN = 1024;              // the swizzle's atom: descriptors need it

// the tool's variants, in its order (ops/kernels/mlp_chain.py ACTIVATIONS)
enum Act { NONE, RELU, SOFTPLUS, SIGMOID, SP_GATE, SHARED, EXPM1_GATE, RECIP_APPROX,
           RECIP_NEWTON, N_ACT };

struct Chain {
  const float* x;   // [n, 256]
  const void* wimg; // W's packed image: bf16 (the bf16 chains) or three-part (the f32 chain)
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

// ---- the f32 chain: every product as six bf16 wgmma passes ----
// Two warpgroups a block, each on its own 64-row tile of f32 activations
// in shared memory (row stride LDA3), share every weight slab: 128 rows a
// slab. A slab is one k16 step of 128 output columns (a chunk), its
// 128-byte rows holding that step's hi, mid and lo parts of W^T (16 KB;
// the image, ops/kernels/mlp_chain.py pack_w3_image, orders a layer's
// slabs step after step, a step's two chunks together). Each layer walks k
// outer: per k16 step the warp builds A's three parts in registers from
// its 16 rows of the tile (mlp::load_a3); each chunk's six passes
// (mlp::hp_part's order, m64n128k16) go into a fresh accumulator, whose
// sum, nudged (mlp::unbias_truncated_ffma), joins that chunk's f32 total.
// The two chunks' totals (128 registers a thread) hold the layer's outputs
// until its last step, then go into the tile in place (each warp reads,
// with load_a3, and writes, in the accumulator fragment, only its own 16
// rows: a __syncwarp orders them) and are activated from there. The two
// warpgroups take turns to issue (named barriers 1 and 2, as the bf16
// chain's three): while one's passes run, the other waits for its own and
// nudges them in. The slabs come through a ring of F32_STAGES stages, one
// slab each, that thread 0 keeps F32_AHEAD slabs ahead: once its passes on
// slab v are issued it refills the stage of slab v - F32_LAG, which both
// warpgroups have released by then unless the other one lags more than
// F32_LAG - 1 slabs.
constexpr int F32_WG = 2;                       // warpgroups a block, a 64-row tile each
constexpr int F32_THREADS = F32_WG * WG_THREADS;
constexpr int LDA3 = WD + 8;                    // the tile's row stride: load_a3 conflict-free
constexpr int CW = 128;                         // a chunk's columns
constexpr int SLAB3 = CW * 128;                 // a slab: a chunk x a k16 step's three parts
constexpr int CHUNKS = WD / CW, STEPS = WD / 16;
constexpr int LAYER_SLABS = CHUNKS * STEPS;     // a layer's image: 32 slabs, 512 KB
constexpr int F32_STAGES = 5, F32_LAG = 2, F32_AHEAD = F32_STAGES - F32_LAG;
constexpr size_t SMEM_F32 = ALIGN + size_t(F32_STAGES) * SLAB3 +
                            size_t(F32_WG) * TR * LDA3 * 4 + 2 * F32_STAGES * 8;

struct Ring3 {
  unsigned char* buf;           // F32_STAGES x SLAB3
  unsigned long long* full;     // a stage's slab has landed (thread 0's copy)
  unsigned long long* empty;    // every warp has released the stage (8 arrivals)
  const unsigned char* img;     // the three-part W image, LAYER_SLABS slabs
  unsigned total;               // the slabs the block takes
};

// Thread 0: slab v of the block's sequence (slab v % LAYER_SLABS of the
// image) into its stage, once every warp released the slab before it there.
__device__ __forceinline__ void ring3_issue(const Ring3& r, unsigned v) {
  if (v >= r.total) return;
  const unsigned st = v % F32_STAGES;
  if (v >= F32_STAGES) mlp::mbar_wait(r.empty + st, (v / F32_STAGES - 1) & 1u);
  mlp::bulk_load(r.buf + st * SLAB3, r.img + size_t(v % LAYER_SLABS) * SLAB3, SLAB3,
                 r.full + st);
}

// Every thread: until slab v has landed; its stage.
__device__ __forceinline__ const unsigned char* ring3_take(const Ring3& r, unsigned v) {
  mlp::mbar_wait(r.full + v % F32_STAGES, (v / F32_STAGES) & 1u);
  __syncwarp();
  return r.buf + (v % F32_STAGES) * SLAB3;
}

// Every thread, once its warpgroup's passes on slab v have completed.
__device__ __forceinline__ void ring3_release(const Ring3& r, unsigned v) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mlp::mbar_arrive(r.empty + v % F32_STAGES);
}

// The turn to issue passes between the two warpgroups (barrier 1 + wg:
// warpgroup wg's turn, 128 waiting + 128 passing threads); warpgroup 1
// gives warpgroup 0 the first and does not pass after its block's final
// issue, so each barrier sees as many arrivals as waits.
__device__ __forceinline__ void f32_turn_wait(int wg) { mlp::bar_sync(1 + wg, 2 * WG_THREADS); }
__device__ __forceinline__ void f32_turn_pass(int wg, bool last) {
  if (!(wg == F32_WG - 1 && last)) mlp::bar_arrive(1 + (wg + 1) % F32_WG, 2 * WG_THREADS);
}

// One layer's products over the warpgroup's tile: tot[c] = act @ W[:, 128 c
// .. 128 c + 128] (the warp's rows 16 warp .. 16 warp + 16, in the
// accumulator fragment), from slabs v .. v + LAYER_SLABS of the ring;
// last: the block's last layer (its final turn).
__device__ __forceinline__ void layer_products(const Ring3& r, unsigned v, const float* act,
                                               int wg, int warp, bool last,
                                               float (&tot)[CHUNKS][CW / 2]) {
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) tot[c][i] = 0.f;
#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    unsigned a[3][4];
    mlp::load_a3(act, LDA3, 16 * warp, 16 * s, a);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const unsigned u = v + CHUNKS * s + c;
      const unsigned char* slab = ring3_take(r, u);
      float acc[CW / 2];
      f32_turn_wait(wg);
      mlp::wgmma_fence();
#pragma unroll
      for (int i = 0; i < 6; ++i)
        mlp::wgmma_rs_bf16<CW>(acc, a[mlp::hp_part(i, 0)],
                               mlp::wgmma_desc(slab + 32 * mlp::hp_part(i, 1)), i > 0);
      mlp::wgmma_commit();
      f32_turn_pass(wg, last && s + 1 == STEPS && c + 1 == CHUNKS);
      // after the issue: the refill's wait for the other warpgroup's
      // release then overlaps these passes instead of holding them back
      if (threadIdx.x == 0) ring3_issue(r, u + F32_AHEAD);
      mlp::wgmma_wait_all();
      ring3_release(r, u);
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) tot[c][i] += mlp::unbias_truncated_ffma(acc[i]);
    }
  }
}

// The f32 chain, activation A. Warpgroup wg of a block owns tile F32_WG p
// + wg of each group p of F32_WG tiles the block walks; its warp w loads,
// computes and stores rows 16 w .. 16 w + 16 of it. A tile wholly past n
// runs on zeros and stores nothing (no branch around the products).
template <int A>
__global__ void __launch_bounds__(F32_THREADS, 1) chain_f32_kernel(Chain c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const ring = aligned_smem(smem);
  float* const tiles = reinterpret_cast<float*>(ring + F32_STAGES * SLAB3);
  auto* const bars = reinterpret_cast<unsigned long long*>(tiles + F32_WG * TR * LDA3);
  const int tid = threadIdx.x, wg = tid / WG_THREADS, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  float* const act = tiles + wg * TR * LDA3;   // the warpgroup's tile
  const long long groups = n_tiles(c.n, F32_WG * TR);
  const long long mine = blockIdx.x < groups ? (groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const Ring3 r{ring, bars, bars + F32_STAGES, static_cast<const unsigned char*>(c.wimg),
                unsigned(mine) * unsigned(c.L) * LAYER_SLABS};
  if (tid == 0) {
    for (int i = 0; i < F32_STAGES; ++i) {
      mlp::mbar_init(r.full + i, 1);
      mlp::mbar_init(r.empty + i, F32_THREADS / 32);
    }
    mlp::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int v = 0; v < F32_AHEAD; ++v) ring3_issue(r, v);
  if (wg == F32_WG - 1) mlp::bar_arrive(1, 2 * WG_THREADS);   // warpgroup 0 takes the first turn
  unsigned v = 0;
  for (long long p = blockIdx.x; p < groups; p += gridDim.x) {
    const bool last_group = p + gridDim.x >= groups;
    const long long r0 = (F32_WG * p + wg) * TR + 16 * warp;   // the warp's first row
    const float4* x4 = reinterpret_cast<const float4*>(c.x);
    float4* const out4 = reinterpret_cast<float4*>(c.out);
#pragma unroll 4
    for (int i = lane; i < 16 * WD / 4; i += 32) {
      const int rr = i / (WD / 4), k = 4 * (i % (WD / 4));
      const float4 val = r0 + rr < c.n ? x4[(r0 + rr) * (WD / 4) + k / 4]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(act + (16 * warp + rr) * LDA3 + k) = val;
    }
    __syncwarp();
    for (int l = 0; l < c.L; ++l, v += LAYER_SLABS) {
      const bool last = l + 1 == c.L;
      float tot[CHUNKS][CW / 2];
      layer_products(r, v, act, wg, warp, last_group && last, tot);
      // the sums into the warp's rows of the tile (every read of them done),
      // then activated row-major from there: no activation beside the 128
      // totals in registers, and the last layer's stores are coalesced
#pragma unroll
      for (int ch = 0; ch < CHUNKS; ++ch)
#pragma unroll
        for (int j = 0; j < CW / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(act + (16 * warp + g + 8 * h) * LDA3 + CW * ch + 8 * j +
                                       2 * q) =
                make_float2(tot[ch][4 * j + 2 * h], tot[ch][4 * j + 2 * h + 1]);
      __syncwarp();
      if (A != NONE || last) {
#pragma unroll 4
        for (int i = lane; i < 16 * WD / 4; i += 32) {
          const int rr = i / (WD / 4), k = 4 * (i % (WD / 4));
          float4* const at = reinterpret_cast<float4*>(act + (16 * warp + rr) * LDA3 + k);
          float4 o = *at;
          o = make_float4(activate<A>(o.x, c.gw), activate<A>(o.y, c.gw),
                          activate<A>(o.z, c.gw), activate<A>(o.w, c.gw));
          if (!last) *at = o;
          else if (r0 + rr < c.n) out4[(r0 + rr) * (WD / 4) + k / 4] = o;
        }
        __syncwarp();
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

// A chain kernel's block: rows a block walks at a time, dynamic shared
// memory, threads.
struct Shape {
  int rows;
  size_t smem;
  int threads;
};
constexpr Shape CHAIN_SHAPE{NWG * TR, SMEM_CHAIN, CHAIN_THREADS},
    F32_SHAPE{F32_WG * TR, SMEM_F32, F32_THREADS}, DEF_SHAPE{TR, SMEM_DEF, DEF_THREADS};

// The blocks of kern an SM holds (after allowing its shared memory), or a
// negative CUDA error code.
template <class K>
int blocks_per_sm(K kern, const Shape& sh) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(sh.smem));
  if (e != cudaSuccess) return -int(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, sh.threads, sh.smem);
  return e != cudaSuccess ? -int(e) : per_sm;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return int(e);
}

// Persistent grid: at most the SM count times the blocks an SM holds; a
// block walks units of sh.rows rows (a group of tiles, or a tile).
int launch(Kern kern, const Chain& c, const Shape& sh, cudaStream_t st) {
  if (c.n <= 0) return 0;
  const int per_sm = blocks_per_sm(kern, sh);
  if (per_sm < 0) return -per_sm;
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const long long tiles = n_tiles(c.n, sh.rows);
  const long long cap = (long long)sms * per_sm;
  kern<<<unsigned(tiles < cap ? tiles : cap), sh.threads, sh.smem, st>>>(c);
  return int(cudaGetLastError());
}

// ---- probes of the card, for chip_smoke.py phase 9 ----

// One m64n128k16 bf16 product on one warpgroup, d = c + a b: the tensor
// cores' rounding, read against float64. a [64][16] and b [128][16] (B^T)
// as bf16 bits, c and d [64][128] f32, all row-major.
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_probe_kernel(const unsigned short* a, const unsigned short* b, const float* c,
                       float* d) {
  __shared__ __align__(1024) unsigned char a_s[64 * 128];
  __shared__ __align__(1024) unsigned char b_s[128 * 128];
  const int t = threadIdx.x, w = t >> 5, g = (t & 31) >> 2, q = t & 3;
  for (int i = t; i < 64 * 16; i += WG_THREADS)
    *reinterpret_cast<unsigned short*>(a_s + mlp::sw128_offset(i / 16, i % 16)) = a[i];
  for (int i = t; i < 128 * 16; i += WG_THREADS)
    *reinterpret_cast<unsigned short*>(b_s + mlp::sw128_offset(i / 16, i % 16)) = b[i];
  mlp::fence_proxy_async();
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i)
    acc[i] = c[(16 * w + g + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * q + (i & 1)];
  mlp::wgmma_fence();
  mlp::wgmma_m64n128k16_bf16(acc, mlp::wgmma_desc(a_s), mlp::wgmma_desc(b_s), 1);
  mlp::wgmma_commit();
  mlp::wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i)
    d[(16 * w + g + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * q + (i & 1)] = acc[i];
}

// The f32 chain's ring alone: each block takes `slabs` slabs through
// Ring3 (its stages, lookahead and releases) with no products, from its
// own copy (block b: copy b % copies) of a LAYER_SLABS-slab image. Its
// time prices the slabs' way from L2 into shared memory.
__global__ void __launch_bounds__(F32_THREADS, 1)
    ring_probe_kernel(const unsigned char* img, int copies, unsigned slabs) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const ring = aligned_smem(smem);
  auto* const bars = reinterpret_cast<unsigned long long*>(ring + F32_STAGES * SLAB3);
  const Ring3 r{ring, bars, bars + F32_STAGES,
                img + size_t(blockIdx.x % copies) * LAYER_SLABS * SLAB3, slabs};
  if (threadIdx.x == 0) {
    for (int i = 0; i < F32_STAGES; ++i) {
      mlp::mbar_init(r.full + i, 1);
      mlp::mbar_init(r.empty + i, F32_THREADS / 32);
    }
    mlp::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int v = 0; v < F32_AHEAD; ++v) ring3_issue(r, v);
  for (unsigned u = 0; u < slabs; ++u) {
    if (threadIdx.x == 0) ring3_issue(r, u + F32_AHEAD);
    ring3_take(r, u);
    ring3_release(r, u);
  }
}

}  // namespace

// Plain C interface for ctypes. Each returns 0 or the CUDA error code of the
// set-up or the launch; none synchronises.
// wimg: W's packed image, 16-byte aligned: bf16 for the bf16 chains
// (ops/kernels/mlp_chain.py pack_w_image), three-part for the f32 chain
// (pack_w3_image).
extern "C" int mlp_chain_launch(const float* x, const void* wimg, float* out, long long n, int L,
                                int act, int bf16, float gate_w, void* stream) {
  const Kern kern = chain_kernel_for(act, bf16 != 0);
  if (kern == nullptr || L < 1) return int(cudaErrorInvalidValue);
  const Chain c{x, wimg, out, n, L, gate_w};
  return launch(kern, c, bf16 ? CHAIN_SHAPE : F32_SHAPE, static_cast<cudaStream_t>(stream));
}

extern "C" int mlp_chain_deferred_launch(const float* x, const void* wimg, float* out,
                                         long long n, int L, float gate_w, void* stream) {
  if (L < 1) return int(cudaErrorInvalidValue);
  const Chain c{x, wimg, out, n, L, gate_w};
  return launch(chain_deferred_kernel, c, DEF_SHAPE, static_cast<cudaStream_t>(stream));
}

// The blocks an SM holds of the chain kernel of `act` (bf16 or f32; act -1:
// the deferred chain), or a negative CUDA error code.
extern "C" int mlp_chain_blocks_per_sm(int act, int bf16) {
  if (act < 0) return blocks_per_sm(chain_deferred_kernel, DEF_SHAPE);
  const Kern kern = chain_kernel_for(act, bf16 != 0);
  if (kern == nullptr) return -int(cudaErrorInvalidValue);
  return blocks_per_sm(kern, bf16 ? CHAIN_SHAPE : F32_SHAPE);
}

extern "C" int mlp_wgmma_probe_launch(const void* a, const void* b, const float* c, float* d,
                                      void* stream) {
  wgmma_probe_kernel<<<1, WG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(a), static_cast<const unsigned short*>(b), c, d);
  return int(cudaGetLastError());
}

// The f32 chain's slab, bytes.
extern "C" int mlp_chain_f32_slab_bytes() { return SLAB3; }

// blocks blocks (at most one an SM), each taking `slabs` slabs from copy
// b % copies of the image at img (copies x 512 KB).
extern "C" int mlp_ring_probe_launch(const void* img, int copies, unsigned slabs, int blocks,
                                     void* stream) {
  const Shape sh{0, SMEM_F32, F32_THREADS};   // the chain's, so one block an SM as the chain
  if (copies < 1 || blocks < 1) return int(cudaErrorInvalidValue);
  const int per_sm = blocks_per_sm(ring_probe_kernel, sh);
  if (per_sm < 0) return -per_sm;
  ring_probe_kernel<<<blocks, sh.threads, sh.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(img), copies, slabs);
  return int(cudaGetLastError());
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
