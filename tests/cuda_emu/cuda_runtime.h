// A CPU stand-in for the part of the CUDA runtime the port's point-pipeline
// and ray-march kernels use, so that tests/test_torch_point_pipeline_emulated.py
// and tests/test_torch_ray_march_emulated.py can compile csrc/point_pipeline.cu
// and csrc/ray_march.cu with a host C++ compiler and run them: the
// test starts one std::thread per CUDA thread of a block, __syncthreads is
// a barrier over them, __shfl_xor_sync exchanges through an array between
// two barriers (every thread of the block calls it the same number of
// times), and the launch syntax <<<...>>> is stripped from the source.
#pragma once
#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstddef>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __shared__
#define __align__(n)
#define __restrict__

struct emu_dim3 { unsigned x, y, z; };
extern thread_local emu_dim3 threadIdx;
extern emu_dim3 blockIdx, blockDim, gridDim;
extern std::barrier<>* emu_barrier;
extern float emu_shuffle[256];

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
struct float4 { float x, y, z, w; };
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

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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
