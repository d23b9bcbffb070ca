// BlendAvg parameter blend (paper Eq. 11): out[n] = sum_l omega[l] * x[l, n].
//
// Replaces the TPU kernel src/repro/kernels/blendavg/blendavg.py:29
// (blend_params_pallas, its pl.pallas_call and _kernel body), which
// streams each (L, block_n) tile through VMEM once and writes each
// output once.
//
// Arithmetic: each product omega_l * x[l, n] is rounded to f32 and
// added to an f32 accumulator in l order (__fmul_rn / __fadd_rn, so the
// compiler does not contract them into an FMA), then the sum is stored
// once in x's dtype (f32, or bf16 rounded to nearest even). No fast math.
//
// Bound: HBM bytes. A call reads L*N*itemsize + 4*L bytes and writes
// N*itemsize; it does 2 f32 operations per input element, far below the
// card's compute rate (the main-path leaf (17, 2,097,152) f32 moves
// 151 MB, 45 us at 3.35 TB/s). Layout: each thread owns output columns
// (grid-stride over N); neighbouring threads take neighbouring columns,
// so each of the L row loads of a warp is one coalesced 128-byte line.
// omega is staged in shared memory once per block.
//
// One launch per parameter leaf mirrors the JAX package's one
// pallas_call per pytree leaf (ops.py). A single launch over every leaf
// through a pointer table, with vectorised 16-byte loads, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 256;  // omega staged in shared memory
constexpr int64_t kMaxBlocks = 65536;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void blend_kernel(const T* __restrict__ x,
                             const float* __restrict__ omega,
                             T* __restrict__ out, int rows, int64_t n) {
  __shared__ float w[kMaxRows];
  for (int l = threadIdx.x; l < rows; l += blockDim.x) w[l] = omega[l];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const T* p = x + j;
    float acc = 0.0f;
    for (int l = 0; l < rows; ++l) {
      acc = __fadd_rn(acc, __fmul_rn(w[l], load_f32(p)));
      p += n;
    }
    store_f32(out + j, acc);
  }
}

template <typename T>
int launch(const void* x, const void* omega, void* out, int rows, int64_t n,
           void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  blend_kernel<T><<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(omega),
      static_cast<T*>(out), rows, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. x is a contiguous (rows, n) array of
// the named dtype, omega contiguous (rows,) f32, out contiguous (n,) of
// x's dtype, all on the device of `stream`; 1 <= rows <= 256 and n >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int blend_params_f32(const void* x, const void* omega, void* out,
                                int rows, int64_t n, void* stream) {
  return launch<float>(x, omega, out, rows, n, stream);
}

extern "C" int blend_params_bf16(const void* x, const void* omega, void* out,
                                 int rows, int64_t n, void* stream) {
  return launch<__nv_bfloat16>(x, omega, out, rows, n, stream);
}
