// Fused wire-codec round-trip: sparsify + int8 quantize + dequantize in
// one pass over each element.
//
// Replaces the TPU kernel src/repro/kernels/wire_codec/wire_codec.py
// (wire_codec_pallas, its pl.pallas_call and _kernel body). Per row of
// x (L, N), with that row's [scale, thresh] from scale_thresh (L, 2):
//
//     keep = |x| >= thresh
//     q    = clip(rint(x * (127 / scale)), -127, 127)      (quantize only)
//     x    = q * (scale / 127)                              (quantize only)
//     out  = keep ? x : 0
//
// Arithmetic in f32, stored in the input dtype (f32 or bf16). rintf
// rounds half to even like jnp.round; both divisions are IEEE (the
// library is built without --use_fast_math) and ordered exactly as the
// reference orders them, so codes and masks match the plain version
// bit for bit. With quantize off and thresh 0 the output is the input,
// bit for bit (-0.0 included).
//
// Bound: HBM bytes, L*N*2*itemsize (one read, one write per element)
// plus 8 bytes of scale_thresh per row; a handful of f32 operations per
// element is far below the card's compute rate. At serving shapes
// ((2..64, 1024) features, (2..64, 25) scores) it moves under 600 KB
// and is launch-bound. Layout: blockIdx.y is the row, blockIdx.x with a
// grid stride covers N, and the ragged end is masked by the loop bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, bool kQuantize>
__global__ void wire_codec_kernel(const T* __restrict__ x,
                                  const float* __restrict__ scale_thresh,
                                  T* __restrict__ out, int64_t n) {
  const int64_t row = blockIdx.y;
  const float scale = scale_thresh[2 * row];
  const float thresh = scale_thresh[2 * row + 1];
  const float to_code = 127.0f / scale;
  const float from_code = scale / 127.0f;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float v = load_f32(xr + j);
    const bool keep = fabsf(v) >= thresh;
    if (kQuantize) {
      const float q = fminf(fmaxf(rintf(v * to_code), -127.0f), 127.0f);
      v = q * from_code;
    }
    store_f32(orow + j, keep ? v : 0.0f);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksPerRow = 256;

template <typename T>
int launch(const void* x, const void* scale_thresh, void* out, int64_t rows,
           int64_t n, int quantize, void* stream) {
  int64_t bx = (n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  const dim3 grid((unsigned)bx, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const float* stp = static_cast<const float*>(scale_thresh);
  T* op = static_cast<T*>(out);
  if (quantize) {
    wire_codec_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, stp, op, n);
  } else {
    wire_codec_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, stp, op, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. x and out are contiguous (rows, n) of
// the named dtype, scale_thresh contiguous (rows, 2) f32, all on the
// device of `stream`. Returns cudaGetLastError() after the launch.
extern "C" int wire_codec_f32(const void* x, const void* scale_thresh,
                              void* out, int64_t rows, int64_t n,
                              int quantize, void* stream) {
  return launch<float>(x, scale_thresh, out, rows, n, quantize, stream);
}

extern "C" int wire_codec_bf16(const void* x, const void* scale_thresh,
                               void* out, int64_t rows, int64_t n,
                               int quantize, void* stream) {
  return launch<__nv_bfloat16>(x, scale_thresh, out, rows, n, quantize,
                               stream);
}
