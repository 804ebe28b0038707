// A CPU stand-in for the part of the CUDA runtime the port's kernels use
// (point pipeline, ray march, MLP chain, SDF sweep and grid SDF), so that
// the *_emulated tests can compile csrc/point_pipeline.cu,
// csrc/ray_march.cu, csrc/mlp_chain.cu and csrc/sdf_rays.cu with a host C++
// compiler and run them: a harness runs each block's CUDA threads with
// emu_run_block, __syncthreads is a barrier over them, __shfl_xor_sync
// exchanges through an array between two meetings of the warp (every
// thread of the warp calls it the same number of times), and the launch syntax
// <<<...>>> is stripped from the source.
//
// A block's CUDA threads are fibers on the one host thread that calls
// emu_run_block, each on a stack of its own, threadIdx set to the fiber's
// while it runs: a fiber runs until it waits (__syncthreads, a warp's or a
// warpgroup's meeting, a named barrier, an mbarrier), and then passes the
// host thread to the next fiber that can run, round robin (emu_yield). So
// a block takes one host core, whatever its thread count, and a wait costs
// a switch of stacks, not a trip through the host's scheduler (one host
// thread per CUDA thread, far more than the host's cores, spent most of
// their time waking each other). The order in which the threads run
// between two waits is fixed, so a run is repeatable; a wait that no
// thread can end is a deadlock here as on the card.
//
// The bf16 tensor-core product mma.sync.m16n8k16 (mlp::mma_bf16 calls
// mma_m16n8k16_bf16 here) follows the PTX fragment layouts: each lane
// deposits its A and B registers, the 32 lanes of its warp meet at a
// barrier, and each lane then computes its own four accumulators from the
// deposits, summing the 16 products in k order in f32. Deposits alternate
// between two buffers, so one barrier per instruction suffices; the
// barrier is the warp's own (as mma.sync is a warp's instruction). The
// bf16 conversions round to nearest, ties to even.
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

#include <sys/mman.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <vector>
#if !defined(__x86_64__)
#include <ucontext.h>
#endif

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
inline emu_dim3 threadIdx, blockIdx, blockDim, gridDim;
constexpr int EMU_MAX_THREADS = 1024;
inline float emu_shuffle[EMU_MAX_THREADS];   // one slot per thread of the block

// ---- the block's threads as fibers ----
struct EmuFiber {
  void* sp;            // its stack pointer while it does not run (x86-64)
#if !defined(__x86_64__)
  ucontext_t uc;
#endif
  unsigned bar_gen;    // at_bar: the __syncthreads generation it waits in
  bool at_bar, done;
};
inline std::vector<EmuFiber> emu_fibers;
inline std::vector<unsigned char*> emu_stacks;
constexpr size_t EMU_STACK_BYTES = size_t(4) << 20;   // reserved, touched as used
inline int emu_nthreads = 0, emu_cur = 0, emu_alive = 0, emu_arrived = 0;
inline unsigned emu_gen = 0;   // __syncthreads generations completed
inline std::function<void()> emu_body;
inline void* emu_main_sp;
#if !defined(__x86_64__)
inline ucontext_t emu_main_uc;
#endif

#if defined(__x86_64__)
// Saves the callee-saved registers on the running stack and its pointer
// in *save, then resumes the stack at `load` (saved so, or a new fiber's
// first frame: emu_run_block).
extern "C" void emu_ctx_switch(void** save, void* load);
__asm__(".text\n.globl emu_ctx_switch\n.type emu_ctx_switch, @function\n"
        "emu_ctx_switch:\n"
        "  pushq %rbp\n  pushq %rbx\n  pushq %r12\n  pushq %r13\n  pushq %r14\n  pushq %r15\n"
        "  movq %rsp, (%rdi)\n  movq %rsi, %rsp\n"
        "  popq %r15\n  popq %r14\n  popq %r13\n  popq %r12\n  popq %rbx\n  popq %rbp\n"
        "  ret\n.size emu_ctx_switch, .-emu_ctx_switch\n");
#endif

inline bool emu_runnable(const EmuFiber& f) {
  return !f.done && !(f.at_bar && f.bar_gen == emu_gen);
}

inline void emu_switch(int next) {   // from the running fiber to fiber next
  const int prev = emu_cur;
  emu_cur = next;
  threadIdx.x = unsigned(next);
#if defined(__x86_64__)
  emu_ctx_switch(&emu_fibers[prev].sp, emu_fibers[next].sp);
#else
  swapcontext(&emu_fibers[prev].uc, &emu_fibers[next].uc);
#endif
}

// Passes the host thread to the next fiber that can run (round robin);
// returns at once when there is none.
inline void emu_yield() {
  int next = emu_cur;
  for (int k = 0; k < emu_nthreads; ++k) {
    next = next + 1 == emu_nthreads ? 0 : next + 1;
    if (emu_runnable(emu_fibers[next])) break;
  }
  if (next != emu_cur && emu_runnable(emu_fibers[next])) emu_switch(next);
}

// Every fiber's first frame: the block's body, then the host thread to the
// next fiber, or back to emu_run_block after the last.
inline void emu_fiber_main() {
  emu_body();
  emu_fibers[emu_cur].done = true;
  if (--emu_alive == 0) {
#if defined(__x86_64__)
    void* dead;
    emu_ctx_switch(&dead, emu_main_sp);
#else
    setcontext(&emu_main_uc);
#endif
  }
  emu_yield();
  abort();   // the others all wait at a barrier this thread has left: a deadlock
}

inline void emu_reset_thread_state();   // each new thread's own state (below)

// Runs body() as the n CUDA threads of one block (blockIdx and gridDim are
// the caller's to set), each a fiber; returns when all have returned.
inline void emu_run_block(int n, std::function<void()> body) {
  if (n < 1 || n > EMU_MAX_THREADS) abort();
  emu_body = std::move(body);
  while (int(emu_stacks.size()) < n) {
    void* m = mmap(nullptr, EMU_STACK_BYTES, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (m == MAP_FAILED) abort();
    emu_stacks.push_back(static_cast<unsigned char*>(m));
  }
  emu_fibers.assign(size_t(n), EmuFiber{});
  for (int i = 0; i < n; ++i) {
#if defined(__x86_64__)
    // the frame emu_ctx_switch resumes: six registers, then emu_fiber_main
    // as its return address, entered as if called (the stack 16-byte
    // aligned before the call)
    void** sp = reinterpret_cast<void**>(emu_stacks[i] + EMU_STACK_BYTES);
    *--sp = nullptr;
    *--sp = reinterpret_cast<void*>(&emu_fiber_main);
    for (int r = 0; r < 6; ++r) *--sp = nullptr;
    emu_fibers[i].sp = sp;
#else
    getcontext(&emu_fibers[i].uc);
    emu_fibers[i].uc.uc_stack.ss_sp = emu_stacks[i];
    emu_fibers[i].uc.uc_stack.ss_size = EMU_STACK_BYTES;
    emu_fibers[i].uc.uc_link = nullptr;
    makecontext(&emu_fibers[i].uc, &emu_fiber_main, 0);
#endif
  }
  emu_reset_thread_state();
  emu_nthreads = emu_alive = n;
  emu_arrived = 0;
  emu_cur = 0;
  threadIdx.x = 0;
  blockDim.x = unsigned(n);
#if defined(__x86_64__)
  emu_ctx_switch(&emu_main_sp, emu_fibers[0].sp);
#else
  swapcontext(&emu_main_uc, &emu_fibers[0].uc);
#endif
}

// Yields until the word a (a std::atomic or std::atomic_ref) no longer
// holds old.
template <class A, class V>
inline void emu_wait_while(A& a, V old) {
  while (a.load(std::memory_order_acquire) == old) emu_yield();
}

inline void __syncthreads() {
  EmuFiber& me = emu_fibers[emu_cur];
  if (++emu_arrived == emu_nthreads) {
    emu_arrived = 0;
    ++emu_gen;
    return;
  }
  me.at_bar = true;
  me.bar_gen = emu_gen;
  while (me.bar_gen == emu_gen) emu_yield();
  me.at_bar = false;
}
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

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
inline unsigned emu_mma_buffer[EMU_MAX_THREADS];   // each thread's next buffer

// A meeting of n threads at b: the last to arrive opens the next phase.
inline void emu_meet(EmuWarpBarrier& b, int n) {
  const int phase = b.phase.load(std::memory_order_acquire);
  if (b.count.fetch_add(1, std::memory_order_acq_rel) == n - 1) {
    b.count.store(0, std::memory_order_relaxed);
    b.phase.store(phase + 1, std::memory_order_release);
  } else {
    emu_wait_while(b.phase, phase);
  }
}

inline void emu_warp_sync() { emu_meet(emu_warp_barrier[threadIdx.x >> 5], 32); }

// Half h (0: low) of register `reg` of lane `lane`, as a float.
inline float emu_mma_elem(unsigned (*regs)[6], int lane, int reg, int h) {
  return emu_bf16_float((regs[lane][reg] >> (16 * h)) & 0xffffu);
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_sync(); }

// A meeting of the warp, as on the card: a warp-uniform shuffle under a
// branch that other warps skip (the flush's reductions) does not wait for
// them.
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  emu_shuffle[threadIdx.x] = v;
  emu_warp_sync();
  const float r = emu_shuffle[threadIdx.x ^ lane_mask];
  emu_warp_sync();
  return r;
}

inline void mma_m16n8k16_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                              unsigned b0, unsigned b1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned (*regs)[6] = emu_mma_regs[emu_mma_buffer[threadIdx.x]][warp];
  emu_mma_buffer[threadIdx.x] ^= 1u;
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
inline unsigned emu_ldm_buffer[EMU_MAX_THREADS];
inline void emu_ldmatrix_x4(unsigned (&r)[4], const void* row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const void** rows = emu_ldm_rows[emu_ldm_buffer[threadIdx.x]][warp];
  emu_ldm_buffer[threadIdx.x] ^= 1u;
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
inline void emu_warpgroup_sync() { emu_meet(emu_wg_barrier[threadIdx.x >> 7], 128); }
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
inline unsigned emu_wgmma_a_buffer[EMU_MAX_THREADS];
inline void emu_reset_thread_state() {
  memset(emu_mma_buffer, 0, sizeof(emu_mma_buffer));
  memset(emu_ldm_buffer, 0, sizeof(emu_ldm_buffer));
  memset(emu_wgmma_a_buffer, 0, sizeof(emu_wgmma_a_buffer));
}
inline void emu_wgmma_bf16_ra(float* d, int n, const unsigned (&a)[4], unsigned long long b,
                              int scale_d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  unsigned (*regs)[4] = emu_wgmma_a[emu_wgmma_a_buffer[threadIdx.x]][warp];
  emu_wgmma_a_buffer[threadIdx.x] ^= 1u;
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
  emu_wait_while(emu_named_barrier[id].gen, gen);
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
  for (unsigned long long v = a.load(std::memory_order_acquire); ((v >> 32) & 1u) == parity;
       v = a.load(std::memory_order_acquire))
    emu_wait_while(a, v);
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
