// A CPU stand-in for the part of the CUDA runtime the port's kernels use
// (point pipeline, ray march, MLP chain, SDF sweep and grid SDF), so that
// the *_emulated tests can compile csrc/point_pipeline.cu,
// csrc/ray_march.cu, csrc/mlp_chain.cu and csrc/sdf_rays.cu with a host C++
// compiler and run them: the test starts one std::thread
// per CUDA thread of a block, __syncthreads is a barrier over them,
// __shfl_xor_sync exchanges through an array between two barriers (every
// thread of the block calls it the same number of times), and the launch
// syntax <<<...>>> is stripped from the source.
//
// The bf16 tensor-core product mma.sync.m16n8k16 (mlp::mma_bf16 calls
// mma_m16n8k16_bf16 here) follows the PTX fragment layouts: each lane
// deposits its A and B registers, the 32 lanes of its warp meet at a
// barrier, and each lane then computes its own four accumulators from the
// deposits, summing the 16 products in k order in f32. Deposits alternate
// between two buffers, so one barrier per instruction suffices; the
// barrier is the warp's own (as mma.sync is a warp's instruction), a
// spin that yields. The bf16 conversions round to nearest, ties to even.
//
// The bulk copy into shared memory (mlp::bulk_load) is a memcpy done at
// once, followed by an arrival on its mbarrier; the mbarrier is a real
// counting barrier over the emulated threads (its 64-bit word holds the
// expected and the pending arrivals and the count of completed phases), so
// a slab that is overwritten before every warp has released it, or read
// from the wrong stage, shows in the results.
//
// The warpgroup product wgmma.mma_async m64nNk16 bf16 -> f32 (mlp::wgmma_*)
// decodes its shared-memory descriptors as the hardware does (start
// address, SBO, the 128-byte swizzle applied to address bits 4-6 from bits
// 7-9; only that layout is taken) relative to emu_smem_base, the block's
// shared memory, and each thread computes its own accumulators (the PTX
// fragment layout) at issue, summing the 16 products in k order in f32
// (compiled with EMU_WGMMA_TRUNCATE: exactly, then truncated to f32 toward
// zero, the card's tensor cores' rounding as emu_truncate models it).
// wgmma.fence and wait_group are meetings of the warpgroup's 128 threads
// (wait_group: no thread writes an operand before every warp has read
// it), commit_group nothing. Named barriers (bar.sync / bar.arrive id, n)
// count real arrivals, so a turn passed once too often or too rarely
// deadlocks or races here as on the card.
#pragma once
#include <math.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <thread>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(a, b)
#define __shared__
#define __align__(n)
#define __restrict__

struct emu_dim3 { unsigned x, y, z; };
extern thread_local emu_dim3 threadIdx;
extern emu_dim3 blockIdx, blockDim, gridDim;
extern std::barrier<>* emu_barrier;
extern float emu_shuffle[];   // one slot per thread of the block

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  emu_shuffle[threadIdx.x] = v;
  emu_barrier->arrive_and_wait();
  const float r = emu_shuffle[threadIdx.x ^ lane_mask];
  emu_barrier->arrive_and_wait();
  return r;
}

// ---- bf16 ----
struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline uint16_t emu_bf16_bits(float f) {   // round to nearest, ties to even
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return uint16_t((u >> 16) | 0x40u);   // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return uint16_t(u >> 16);
}
inline float emu_bf16_float(uint32_t bits) {
  const uint32_t u = bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {emu_bf16_bits(f)}; }
inline float __bfloat162float(__nv_bfloat16 h) { return emu_bf16_float(h.bits); }
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {{emu_bf16_bits(lo)}, {emu_bf16_bits(hi)}};
}

// ---- mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 ----
struct EmuWarpBarrier {
  std::atomic<int> count{0};
  std::atomic<int> phase{0};
};
inline EmuWarpBarrier emu_warp_barrier[32];
inline unsigned emu_mma_regs[2][32][32][6];   // [buffer][warp][lane][a0..a3, b0, b1]
inline thread_local unsigned emu_mma_buffer = 0;

inline void emu_warp_sync() {
  EmuWarpBarrier& b = emu_warp_barrier[threadIdx.x >> 5];
  const int phase = b.phase.load(std::memory_order_acquire);
  if (b.count.fetch_add(1, std::memory_order_acq_rel) == 31) {
    b.count.store(0, std::memory_order_relaxed);
    b.phase.store(phase + 1, std::memory_order_release);
  } else {
    while (b.phase.load(std::memory_order_acquire) == phase) std::this_thread::yield();
  }
}

// Half h (0: low) of register `reg` of lane `lane`, as a float.
inline float emu_mma_elem(unsigned (*regs)[6], int lane, int reg, int h) {
  return emu_bf16_float((regs[lane][reg] >> (16 * h)) & 0xffffu);
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_sync(); }

inline void mma_m16n8k16_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                              unsigned b0, unsigned b1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned (*regs)[6] = emu_mma_regs[emu_mma_buffer][warp];
  emu_mma_buffer ^= 1u;
  const unsigned mine[6] = {a0, a1, a2, a3, b0, b1};
  memcpy(regs[lane], mine, sizeof(mine));
  emu_warp_sync();
  for (int q = 0; q < 4; ++q) {
    const int row = g + 8 * (q >> 1), col = 2 * t + (q & 1);
    float acc = d[q];
    for (int k = 0; k < 16; ++k) {
      // A[row][k]: lane 4 (row % 8) + (k % 8) / 2, register a0 + (row >= 8) + 2 (k >= 8);
      // B[k][col]: lane 4 col + (k % 8) / 2, register b0 + (k >= 8); the half k % 2
      const float a = emu_mma_elem(regs, 4 * (row % 8) + (k % 8) / 2,
                                   (row >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0), k & 1);
      const float b = emu_mma_elem(regs, 4 * col + (k % 8) / 2, 4 + (k >= 8 ? 1 : 0), k & 1);
      acc = fmaf(a, b, acc);
    }
    d[q] = acc;
  }
}

// ---- ldmatrix.sync.aligned.m8n8.x4.shared.b16: lanes deposit their row
// pointers (two buffers, as for mma), meet, and read their four words ----
inline const void* emu_ldm_rows[2][32][32];   // [buffer][warp][lane]
inline thread_local unsigned emu_ldm_buffer = 0;
inline void emu_ldmatrix_x4(unsigned (&r)[4], const void* row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const void** rows = emu_ldm_rows[emu_ldm_buffer][warp];
  emu_ldm_buffer ^= 1u;
  rows[lane] = row;
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) memcpy(&r[i], static_cast<const char*>(rows[8 * i + g]) + 4 * t, 4);
}

// ---- wgmma (warpgroup = 4 warps = 128 threads) ----
inline unsigned char* emu_smem_base;   // the block's shared memory: address 0
inline size_t __cvta_generic_to_shared(const void* p) {
  return size_t(static_cast<const unsigned char*>(p) - emu_smem_base);
}

inline EmuWarpBarrier emu_wg_barrier[8];
inline void emu_warpgroup_sync() {
  EmuWarpBarrier& b = emu_wg_barrier[threadIdx.x >> 7];
  const int phase = b.phase.load(std::memory_order_acquire);
  if (b.count.fetch_add(1, std::memory_order_acq_rel) == 127) {
    b.count.store(0, std::memory_order_relaxed);
    b.phase.store(phase + 1, std::memory_order_release);
  } else {
    while (b.phase.load(std::memory_order_acquire) == phase) std::this_thread::yield();
  }
}
inline void emu_wgmma_fence() { emu_warpgroup_sync(); }
inline void emu_wgmma_wait() { emu_warpgroup_sync(); }

// Element (row, k) of a K-major operand with the 128-byte swizzle, k < 16.
inline float emu_sw128(unsigned long long desc, int row, int k) {
  if ((desc >> 62) != 1) abort();   // only the 128-byte swizzle
  const size_t start = size_t(desc & 0x3fffu) << 4, sbo = size_t((desc >> 32) & 0x3fffu) << 4;
  size_t addr = start + size_t(row / 8) * sbo + size_t(row % 8) * 128 + size_t(k) * 2;
  addr ^= ((addr >> 7) & 7u) << 4;
  uint16_t v;
  memcpy(&v, emu_smem_base + addr, 2);
  return emu_bf16_float(v);
}

#ifdef EMU_WGMMA_TRUNCATE
// The tensor cores' rounding, as modelled when EMU_WGMMA_TRUNCATE is
// defined: an instruction's exact sum (the accumulator and its 16
// products, summed in double: exact for these operands' magnitudes)
// rounded to f32 once, toward zero (chip_smoke.py phase 9 holds the card's
// wgmma against this model).
inline float emu_truncate(double s) {
  float f = float(s);   // to nearest
  if (fabs(double(f)) > fabs(s)) f = nextafterf(f, 0.f);
  return f;
}
#endif

// The thread's accumulators d (fragment layout of wgmma_m64n128k16_bf16)
// from its two A rows ar[h][k] (rows 16 w + g + 8 h) and B^T read from the
// descriptor b, the 16 products of each summed in k order in f32 (or, with
// EMU_WGMMA_TRUNCATE, exactly and then truncated: emu_truncate).
inline void emu_wgmma_rows(float* d, int n, const float (&ar)[2][16], unsigned long long b,
                           int scale_d) {
  const int q = threadIdx.x & 3;
  for (int j = 0; j < n / 8; ++j)
    for (int e = 0; e < 2; ++e) {
      float bc[16];
      for (int k = 0; k < 16; ++k) bc[k] = emu_sw128(b, 8 * j + 2 * q + e, k);
      for (int h = 0; h < 2; ++h) {
#ifdef EMU_WGMMA_TRUNCATE
        double acc = scale_d ? d[4 * j + 2 * h + e] : 0.0;
        for (int k = 0; k < 16; ++k) acc += double(ar[h][k]) * double(bc[k]);
        d[4 * j + 2 * h + e] = emu_truncate(acc);
#else
        float acc = scale_d ? d[4 * j + 2 * h + e] : 0.f;
        for (int k = 0; k < 16; ++k) acc = fmaf(ar[h][k], bc[k], acc);
        d[4 * j + 2 * h + e] = acc;
#endif
      }
    }
}

// wgmma with A from shared memory (descriptor a).
inline void emu_wgmma_bf16(float* d, int n, unsigned long long a, unsigned long long b,
                           int scale_d) {
  const int t = threadIdx.x & 127, w = t >> 5, g = (t & 31) >> 2;
  float ar[2][16];
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 16; ++k) ar[h][k] = emu_sw128(a, 16 * w + g + 8 * h, k);
  emu_wgmma_rows(d, n, ar, b, scale_d);
}

// wgmma with A from registers (mma.m16n8k16's A fragment per warp): each
// lane deposits its four registers, the warp meets, and each thread reads
// its two rows from the deposits (two buffers, as for mma).
inline unsigned emu_wgmma_a[2][32][32][4];   // [buffer][warp][lane][a0..a3]
inline thread_local unsigned emu_wgmma_a_buffer = 0;
inline void emu_wgmma_bf16_ra(float* d, int n, const unsigned (&a)[4], unsigned long long b,
                              int scale_d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  unsigned (*regs)[4] = emu_wgmma_a[emu_wgmma_a_buffer][warp];
  emu_wgmma_a_buffer ^= 1u;
  memcpy(regs[lane], a, sizeof(a));
  emu_warp_sync();
  float ar[2][16];
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 16; ++k) {
      // A[row][k], row g + 8 h of the warp's 16: lane 4 g + (k % 8) / 2,
      // register h + 2 (k >= 8), the half k % 2
      const unsigned r = regs[4 * g + (k % 8) / 2][h + (k >= 8 ? 2 : 0)];
      ar[h][k] = emu_bf16_float((r >> (16 * (k & 1))) & 0xffffu);
    }
  emu_wgmma_rows(d, n, ar, b, scale_d);
}

// ---- named barriers: a count and a generation each ----
struct EmuNamedBarrier {
  std::atomic<int> count{0};
  std::atomic<int> gen{0};
};
inline EmuNamedBarrier emu_named_barrier[16];
inline int emu_bar_arrive_at(int id, int n) {   // returns the generation arrived in
  EmuNamedBarrier& b = emu_named_barrier[id];
  const int gen = b.gen.load(std::memory_order_acquire);
  if (b.count.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
    b.count.store(0, std::memory_order_relaxed);
    b.gen.store(gen + 1, std::memory_order_release);
  }
  return gen;
}
inline void emu_bar_arrive(int id, int n) { emu_bar_arrive_at(id, n); }
inline void emu_bar_sync(int id, int n) {
  const int gen = emu_bar_arrive_at(id, n);
  while (emu_named_barrier[id].gen.load(std::memory_order_acquire) == gen)
    std::this_thread::yield();
}

// ---- mbarrier: bits 0-15 expected arrivals, 16-31 pending, 32-63 completed phases ----
inline void emu_mbar_init(unsigned long long* bar, unsigned count) {
  std::atomic_ref<unsigned long long>(*bar).store(count | (count << 16), std::memory_order_release);
}
inline void emu_mbar_arrive(unsigned long long* bar) {
  std::atomic_ref<unsigned long long> a(*bar);
  unsigned long long v = a.load(std::memory_order_acquire), next;
  do {
    const unsigned long long expected = v & 0xffffu, pending = ((v >> 16) & 0xffffu) - 1;
    next = pending == 0 ? (((v >> 32) + 1) << 32) | (expected << 16) | expected
                        : (v & ~0xffff0000ull) | (pending << 16);
  } while (!a.compare_exchange_weak(v, next, std::memory_order_acq_rel,
                                    std::memory_order_acquire));
}
inline void emu_mbar_wait(unsigned long long* bar, unsigned parity) {
  std::atomic_ref<unsigned long long> a(*bar);
  while (((a.load(std::memory_order_acquire) >> 32) & 1u) == parity) std::this_thread::yield();
}
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaGetDevice(int*) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) { return cudaSuccess; }
template <class T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, T, int, size_t) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
