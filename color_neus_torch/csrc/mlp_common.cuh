// Device code shared by the port's MLP kernels (sdf_rays.cu: the placement
// sweep and the grid SDF; point_pipeline.cu and ray_march.cu: the per-point
// pipeline; mlp_chain.cu: the chain microbenchmark): the positional
// encoding and its derivatives, the softplus(beta=100), the bf16
// tensor-core instruction with its operand packing, the asynchronous bulk
// copy into shared memory with its mbarrier, Hopper's warpgroup product
// (wgmma) with its descriptors, fences and the named barriers, and the
// pieces of an f32 product as six bf16 wgmma passes (load_a3,
// unbias_truncated).
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

// softplus(beta=100) = max(x, 0) + log1p(exp(-100 |x|)) / 100, the log
// term scaled by a multiply: an IEEE divide's range check and its slow
// path (denormal log terms, 0.87 < |x| < 1.04) cost more than the rest.
__device__ __forceinline__ float softplus100(float x) {
  return fmaxf(x, 0.f) + __fmul_rn(log1pf(expf(-100.f * fabsf(x))), 0.01f);
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

// The four 8 x 8 16-bit matrices whose rows lanes 8 i .. 8 i + 7 point at
// (16 bytes each, in shared memory): r[i] of lane 4 g + t holds matrix i's
// row g, elements 2t and 2t + 1 (ldmatrix.x4). With the rows of an A tile
// (lanes 0-7 rows 0-7, 8-15 rows 8-15, 16-31 the same eight columns on),
// r is the mma.m16n8k16 A fragment. The CPU rehearsal supplies
// emu_ldmatrix_x4.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
#ifdef __CUDACC__
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(unsigned(__cvta_generic_to_shared(row))));
#else
  emu_ldmatrix_x4(r, row);
#endif
}

// ---- asynchronous copies into shared memory (Hopper bulk copy, mbarrier) ----
// An mbarrier is a 64-bit word in shared memory that counts arrivals and,
// for a bulk copy, the bytes still in flight; a phase completes when both
// reach zero, and mbar_wait(bar, parity) returns once the phase of that
// parity has completed (the k-th use of a barrier waits with parity k & 1).
// The CPU rehearsal (tests/cuda_emu) supplies the emu_mbar_* twins: a copy
// that completes at once and a barrier that counts real arrivals.

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
#ifdef __CUDACC__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(unsigned(__cvta_generic_to_shared(bar))), "r"(count) : "memory");
#else
  emu_mbar_init(bar, count);
#endif
}

// After the inits, before any other thread or a copy uses the barriers
// (and a __syncthreads before the other threads do).
__device__ __forceinline__ void mbar_init_fence() {
#ifdef __CUDACC__
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
#ifdef __CUDACC__
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(unsigned(__cvta_generic_to_shared(bar))) : "memory");
#else
  emu_mbar_arrive(bar);
#endif
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
#ifdef __CUDACC__
  const unsigned addr = unsigned(__cvta_generic_to_shared(bar));
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
#else
  emu_mbar_wait(bar, parity);
#endif
}

// One thread: arrive on `bar` announcing `bytes`, then copy `bytes` from
// device memory to shared memory with the TMA unit (both addresses 16-byte
// aligned, bytes a multiple of 16); the copy completes the transaction.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
#ifdef __CUDACC__
  const unsigned b = unsigned(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(unsigned(__cvta_generic_to_shared(dst))), "l"(src), "r"(bytes), "r"(b)
      : "memory");
#else
  memcpy(dst, src, bytes);
  emu_mbar_arrive(bar);
#endif
}

// One thread: ask the TMA unit to bring `bytes` (a multiple of 16, from a
// 16-byte aligned address) of device memory into L2 ahead of their use. A
// hint: nothing waits for it. The CPU rehearsal does nothing.
__device__ __forceinline__ void prefetch_l2(const void* src, unsigned bytes) {
#ifdef __CUDACC__
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" :: "l"(src), "r"(bytes) : "memory");
#endif
}

// p[0 .. 4) += v (p in device memory, 16-byte aligned) as one vector
// reduction (red.global.add.v4.f32, sm_90): the add happens in L2, the
// thread issues it and goes on, nothing is read back into the SM. One
// thread's reductions to one address are performed in its program order.
// The CPU rehearsal adds in place.
__device__ __forceinline__ void red_add4(float* p, float4 v) {
#ifdef __CUDACC__
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
#else
  p[0] += v.x;
  p[1] += v.y;
  p[2] += v.z;
  p[3] += v.w;
#endif
}

// One thread: copy `bytes` (a multiple of 16) of shared memory to device
// memory with the TMA unit (both addresses 16-byte aligned), as one bulk
// group; bulk_store_wait_read then waits until the copy has read the
// shared memory, which may then be written again, bulk_store_wait until
// its writes are done (before the kernel ends). The caller fences its
// threads' shared-memory writes to the async proxy (fence_proxy_async) and
// meets a barrier first. The CPU rehearsal copies at once.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
#ifdef __CUDACC__
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(unsigned(__cvta_generic_to_shared(src))), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
#else
  memcpy(dst, src, bytes);
#endif
}

__device__ __forceinline__ void bulk_store_wait_read() {
#ifdef __CUDACC__
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
#endif
}

// One thread: dst[0 .. bytes / 4) += src's f32 values (shared memory), the
// adds done by the TMA unit in L2, as one bulk group (bulk_store's rules).
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, unsigned bytes) {
#ifdef __CUDACC__
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;"
               :: "l"(dst), "r"(unsigned(__cvta_generic_to_shared(src))), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
#else
  const float* s = static_cast<const float*>(src);
  for (unsigned i = 0; i < bytes / 4; ++i) dst[i] += s[i];
#endif
}

__device__ __forceinline__ void bulk_store_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
#endif
}

// ---- wgmma: Hopper's warpgroup product, operands in shared memory ----
// The operand layout every wgmma of the port reads (K-major, 128-byte
// swizzle): a [rows][64] bf16 block of 128-byte rows, 8-row groups 1024
// bytes apart (SBO), the block 1024-byte aligned; the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8) (the hardware applies the XOR to
// address bits 4-6 from bits 7-9). A k16 slice of the block starts 32 k
// bytes into it. The CPU rehearsal (tests/cuda_emu) decodes the same
// descriptor and reads the same bytes.

// Byte offset of element (r, k) of such a block, k < 64.
__host__ __device__ __forceinline__ unsigned sw128_offset(int r, int k) {
  return unsigned(r) * 128u + ((unsigned(k >> 3) ^ unsigned(r & 7)) << 4) + unsigned(k & 7) * 2u;
}

// The descriptor of a K-major, 128-byte swizzled operand at p (shared
// memory): start address >> 4, LBO 1 (unused by this layout), SBO 1024
// bytes, layout type 1 (128-byte swizzle).
__device__ __forceinline__ unsigned long long wgmma_desc(const void* p) {
  const unsigned long long addr = (unsigned long long)__cvta_generic_to_shared(p);
  return ((addr & 0x3ffffull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

// Before a warpgroup's first wgmma and after any other instruction wrote
// its accumulator registers.
__device__ __forceinline__ void wgmma_fence() {
#ifdef __CUDACC__
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#else
  emu_wgmma_fence();
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#ifdef __CUDACC__
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#endif
}

// Until every committed wgmma of the warpgroup has completed (its
// accumulators written, its shared-memory operands read).
__device__ __forceinline__ void wgmma_wait_all() {
#ifdef __CUDACC__
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#else
  emu_wgmma_wait();
#endif
}

// Shared-memory writes of this thread made visible to the async proxy
// (wgmma's operand reads); then a barrier before the wgmma.
__device__ __forceinline__ void fence_proxy_async() {
#ifdef __CUDACC__
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
}

// After wgmma_wait_all: the accumulators' registers as the wait leaves
// them, so that no read of them (a shuffle, a select) is scheduled before
// the wait (ptxas would then serialize the kernel's wgmma, C7514).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#ifdef __CUDACC__
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
#endif
}

// Named barriers (0 is __syncthreads'): bar_sync waits until n threads
// have arrived at barrier id, counting itself; bar_arrive only arrives.
__device__ __forceinline__ void bar_sync(int id, int n) {
#ifdef __CUDACC__
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
#else
  emu_bar_sync(id, n);
#endif
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
#ifdef __CUDACC__
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
#else
  emu_bar_arrive(id, n);
#endif
}

// d (+)= A B over one m64n128k16 step, bf16 operands from shared memory (the
// descriptors a: 64 rows of A, b: 128 rows of B^T), f32 accumulators; d is
// added to where scale_d is nonzero, overwritten where it is 0. Fragment
// of thread t of the warpgroup (w = t / 32, g = t % 32 / 4, q = t % 4):
// d[4 j + 2 h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e (PTX ISA,
// wgmma .m64nNk16 f32 accumulator layout, N = 128).
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], unsigned long long a,
                                                     unsigned long long b, int scale_d) {
#ifdef __CUDACC__
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
#else
  emu_wgmma_bf16(d, 128, a, b, scale_d);
#endif
}

// d (+)= A B over one m64n256k16 step, A and B from shared memory (as
// wgmma_m64n128k16_bf16, 256 rows of B^T): 128 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128], unsigned long long a,
                                                     unsigned long long b, int scale_d) {
#ifdef __CUDACC__
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
#else
  emu_wgmma_bf16(d, 256, a, b, scale_d);
#endif
}

// d (+)= A B over one m64nNk16 step (N = 128, 64, 48, 32 or 24), A from
// registers, B from shared memory (the descriptor b: N rows of B^T, the
// layout above), f32 accumulators (N / 2 a thread, laid out as for
// wgmma_m64n128k16_bf16). A's fragment is mma.m16n8k16's: warp w of the
// warpgroup holds rows 16 w .. 16 w + 16, a[0] / a[2] row g, a[1] / a[3]
// row g + 8, a[0] / a[1] columns 2 q, 2 q + 1, a[2] / a[3] eight further
// (each a pair of bf16, the lower column in the low half).
template <int N>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[N / 2], const unsigned (&a)[4],
                                              unsigned long long b, int scale_d) {
  static_assert(N == 128 || N == 64 || N == 48 || N == 32 || N == 24, "wgmma_rs_bf16: N");
#ifdef __CUDACC__
  if constexpr (N == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  } else if constexpr (N == 24) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
#else
  emu_wgmma_bf16_ra(d, N, a, b, scale_d);
#endif
}

// ---- an f32 product as six bf16 wgmma passes (JAX's Precision.HIGHEST) ----
// Each f32 operand x is split into three bf16 parts, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid) (hi + mid + lo == x exactly for a
// normal x), and A B is summed as the six products of parts whose ranks
// add to at most 2, smallest first, hi Hi last; each k16 step's six
// passes go into a fresh accumulator whose sum is nudged (unbias_truncated)
// before it joins the f32 total. Users: point_pipeline_tile.cuh hp_step
// (rows 3-6 in MARCH_BWD_PRECISION f32) and mlp_chain.cu's f32 chain.

// Pass i of the six in their order, A's part (operand 0) or B's (1), ranks
// 0 hi, 1 mid, 2 lo: lo Hi, mid Mid, hi Lo, mid Hi, hi Mid, hi Hi.
__host__ __device__ constexpr int hp_part(int i, int operand) {
  constexpr int pass[6][2] = {{2, 0}, {1, 1}, {0, 2}, {1, 0}, {0, 1}, {0, 0}};
  return pass[i][operand];
}

// v nudged half an ulp away from zero, rounded to nearest even: a step's
// sum, which the tensor cores truncate toward zero, so rounded without bias
// in expectation (the nudge lands on the next value for an odd last bit,
// on v for an even one). Exact for a v below 2^-102 in magnitude (left).
__device__ __forceinline__ float unbias_truncated(float v) {
  const unsigned b = __float_as_uint(v), e = b & 0x7f800000u;
  return e > (24u << 23) ? v + __uint_as_float((b & 0x80000000u) | (e - (24u << 23))) : v;
}

// unbias_truncated as one LOP and one FFMA, v + sign(v) 2^(e-24) (half an
// ulp) rounded to nearest even, where unbias_truncated's test and integer
// ops take seven instructions (mlp_chain.cu's f32 chain, whose pace these
// instructions set). Equal for |v| >= 2^-102; below, the half ulp is itself
// subnormal and v still moves by it (a subnormal v stays).
__device__ __forceinline__ float unbias_truncated_ffma(float v) {
  return fmaf(__uint_as_float(__float_as_uint(v) & 0xff800000u), 0x1p-24f, v);
}

// Parts hi, mid, lo (a[0..2]) of the A fragment (wgmma_rs_bf16's) of rows
// m0 .. m0 + 16, columns k0 .. k0 + 16 of an f32 tile in shared memory
// (row stride lda).
__device__ __forceinline__ void load_a3(const float* A, int lda, int m0, int k0,
                                        unsigned (&a)[3][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* row = A + (m0 + g) * lda + k0 + 2 * t;   // row g; row g + 8 at 8 lda
  const float2 x[4] = {*reinterpret_cast<const float2*>(row),
                       *reinterpret_cast<const float2*>(row + 8 * lda),
                       *reinterpret_cast<const float2*>(row + 8),
                       *reinterpret_cast<const float2*>(row + 8 * lda + 8)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float u = x[i].x, v = x[i].y;
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const unsigned h = pack_bf16(u, v);
      a[part][i] = h;
      u -= __uint_as_float(h << 16);
      v -= __uint_as_float(h & 0xffff0000u);
    }
  }
}

// Global-memory writes of this thread made visible to the async proxy
// (a later bulk copy that reads them); then a barrier before the copy.
__device__ __forceinline__ void fence_proxy_async_global() {
#ifdef __CUDACC__
  asm volatile("fence.proxy.async.global;" ::: "memory");
#endif
}

}  // namespace mlp
