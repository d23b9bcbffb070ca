// Wire-codec round trip: per row, the int8 scale and the top-k
// threshold selected on the card, then sparsify + int8 quantize +
// dequantize in one pass over each element.
//
// Replaces the TPU kernel src/repro/kernels/wire_codec/wire_codec.py
// (wire_codec_pallas, its pl.pallas_call and _kernel body) and the
// lax.top_k the reference runs beside it (src/repro/kernels/wire_codec/
// ops.py). Per row of x (L, N):
//
//     scale  = max |x|, at least 1e-30          (NaN if the row has one)
//     thresh = k-th largest |x|, or 0 when the row is dense (k >= N)
//     keep   = |x| >= thresh
//     q      = clamp(rint(x * (127 / scale)), -127, 127)  (quantize only)
//     x      = q * (scale / 127)                          (quantize only)
//     out    = keep ? x : 0
//
// The pass is the TPU kernel's: arithmetic in f32, stored in the input
// dtype (f32 or bf16); rintf rounds half to even like jnp.round; both
// divisions are IEEE (no --use_fast_math) and ordered as the reference
// orders them; the clamp propagates NaN as torch.clamp and jnp.clip do.
// With quantize off and thresh 0 the output is the input, bit for bit.
//
// Selection. |x| as a 32-bit key (the f32 bits with the sign cleared; a
// bf16 widened exactly) orders as an unsigned integer, NaN above inf, as
// torch.topk orders values. scale is the largest key; thresh is the k-th
// largest, found by an exact radix select over three digits of the key,
// bits [31:21], [20:10] and [9:0] (11 + 11 + 10; a bf16 key's low 16 bits
// are zero, so it needs the first two). Each digit pass counts the keys
// that match the digits chosen so far in a histogram of the next digit
// and picks the digit where the count from the top reaches the rank left.
// The threshold is a value, so the select gives the plain version's
// value bit for bit, and every tie at it is kept.
//
// Two layouts, chosen by N:
// - narrow rows (N <= kNarrowMax, every serving message): one CTA a row
//   reads the row once into shared memory, takes the largest key by a
//   block reduction, runs the digit passes on a shared-memory histogram
//   and writes the decoded row and its [scale, thresh]: one launch a
//   call, one HBM read and write of x.
// - wide rows (training deltas up to 2M entries): a memset of the
//   workspace, then one kernel a digit pass over (CTAs a row, rows), each
//   CTA counting its share into a shared-memory histogram and merging it
//   into the row's histogram in the workspace with atomics. The last CTA
//   of a row to finish (an atomic ticket) picks the digit, zeroes the
//   histogram for the next pass and, after the last pass, writes the
//   row's [scale, thresh]; no value crosses to the host. Then the pass
//   kernel. A row of 8 MB stays in the 50 MB L2 between passes.
// Grids are sized from the SM count; rows whose pointers and N allow it
// load and store 16 bytes a thread.
//
// Bound: HBM bytes, L*N*2*itemsize (one read, one write per element)
// plus 8 bytes of [scale, thresh] per row; a handful of f32 operations
// and one shared-memory atomic per element are far below the card's
// rates. At serving shapes a call moves under 600 KB and is launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // units a thread loads before using them
constexpr int kCtasPerSm = 8;  // a wide kernel's grid: CTAs an SM, over all rows
constexpr int64_t kNarrowMax = 8192;  // NARROW_MAX in wire_codec.py
constexpr int kBins = 2048;          // the widest digit's histogram
constexpr int kPasses = 3;
__constant__ int kShift[kPasses] = {21, 10, 0};
__constant__ int kWidth[kPasses] = {11, 11, 10};
// workspace a row (WS_WORDS in wire_codec.py): the histogram, then the
// ticket, the digits chosen so far, the rank left and the largest key
constexpr int kDone = kBins, kPrefix = kBins + 1, kRank = kBins + 2,
              kAmax = kBins + 3, kWsWords = kBins + 4;
constexpr float kEps = 1e-30f;  // guards all-zero rows

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // elements a 16-byte unit

__device__ __forceinline__ uint32_t f32_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t f32_bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v) << 16;
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the f32 bits of a 16-byte unit's elements
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, uint32_t* b) {
  if constexpr (sizeof(T) == 4) {
    b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = w[i] << 16;
      b[2 * i + 1] = w[i] & 0xffff0000u;
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * i]))
             | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1]))
                << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

struct Codec {
  float thresh, to_code, from_code;
  __device__ __forceinline__ Codec(float scale, float th)
      : thresh(th), to_code(127.0f / scale), from_code(scale / 127.0f) {}
  template <bool kQuantize>
  __device__ __forceinline__ float apply(float v) const {
    const bool keep = fabsf(v) >= thresh;
    if (kQuantize) {
      float q = rintf(v * to_code);
      q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);  // NaN stays
      v = q * from_code;
    }
    return keep ? v : 0.0f;
  }
};

__device__ __forceinline__ float clamp_scale(uint32_t amax_key) {
  const float a = __uint_as_float(amax_key);
  return a < kEps ? kEps : a;  // NaN compares false and stays NaN
}

// Block-wide: the digit d of `hist` (nb bins, shared memory) where the
// count of keys from the top first reaches `rank`, and the rank left
// inside bin d; written to sel[0], sel[1]. Every thread calls it.
__device__ void select_digit(const uint32_t* hist, int nb, uint32_t rank,
                             uint32_t* warp_sums, uint32_t* sel) {
  const int per = nb / kThreads;
  const int lo = threadIdx.x * per;
  uint32_t s = 0;
  for (int j = 0; j < per; ++j) s += hist[lo + j];
  // inclusive suffix sum over threads: keys in this thread's bins and above
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t v = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += o;
  }
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  for (int j = warp + 1; j < kThreads / 32; ++j) v += warp_sums[j];
  uint32_t above = v - s;  // keys in the bins of higher threads
  if (above < rank && rank <= above + s) {
    for (int b = lo + per - 1; b >= lo; --b) {
      if (above + hist[b] >= rank) {
        sel[0] = (uint32_t)b;
        sel[1] = rank - above;
        break;
      }
      above += hist[b];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t block_max(uint32_t v, uint32_t* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // warp_sums may still be read by an earlier caller
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t m = 0;
  for (int j = 0; j < kThreads / 32; ++j) m = max(m, warp_sums[j]);
  return m;
}

// Does key match the digits chosen before pass p (prefix)?
__device__ __forceinline__ bool in_prefix(uint32_t key, int p, uint32_t prefix) {
  const int hi = kShift[p] + kWidth[p];
  return p == 0 || (key >> hi) == prefix;
}

// ---------------------------------------------------------- narrow rows --

template <typename T, bool kQuantize>
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const T* __restrict__ x, T* __restrict__ out,
              float* __restrict__ st, int64_t n, int64_t k) {
  __shared__ uint32_t vals[kNarrowMax];  // the row's f32 bits
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_sums[kThreads / 32];
  __shared__ uint32_t sel[2];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * n;
  uint32_t lmax = 0;
  for (int64_t base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    uint32_t b[kUnroll];  // kUnroll loads in flight a thread
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t j = base + (int64_t)i * kThreads;
      b[i] = j < n ? f32_bits(xr[j]) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t j = base + (int64_t)i * kThreads;
      if (j < n) vals[j] = b[i];
      lmax = max(lmax, b[i] & 0x7fffffffu);
    }
  }
  const uint32_t amax = block_max(lmax, warp_sums);  // also syncs vals
  uint32_t thresh = 0;
  if (k >= 1 && k < n) {
    const int passes = sizeof(T) == 2 ? 2 : kPasses;
    uint32_t prefix = 0, rank = (uint32_t)k;
    for (int p = 0; p < passes; ++p) {
      const int shift = kShift[p], nb = 1 << kWidth[p];
      for (int b = threadIdx.x; b < nb; b += kThreads) hist[b] = 0;
      __syncthreads();
      for (int64_t i = threadIdx.x; i < n; i += kThreads) {
        const uint32_t key = vals[i] & 0x7fffffffu;
        if (in_prefix(key, p, prefix))
          atomicAdd(&hist[(key >> shift) & (nb - 1)], 1u);
      }
      __syncthreads();
      select_digit(hist, nb, rank, warp_sums, sel);
      prefix = (prefix << kWidth[p]) | sel[0];
      rank = sel[1];
      __syncthreads();  // sel is rewritten by the next pass
    }
    thresh = prefix << kShift[passes - 1];  // the digits in place
  }
  const float scale = clamp_scale(amax);
  if (threadIdx.x == 0) {
    st[2 * row] = scale;
    st[2 * row + 1] = __uint_as_float(thresh);
  }
  const Codec c(scale, __uint_as_float(thresh));
  T* orow = out + row * n;
  for (int64_t i = threadIdx.x; i < n; i += kThreads)
    store_f32(orow + i, c.apply<kQuantize>(__uint_as_float(vals[i])));
}

// ------------------------------------------------------------ wide rows --

// CTAs a row for a grid of kCtasPerSm CTAs an SM over all rows: at
// least one, at most enough to give every thread kUnroll of the row's
// units (16-byte vectors, or elements).
__host__ int64_t ctas_per_row(int64_t rows, int64_t units) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) dev = 63;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = ((int64_t)kCtasPerSm * sms[dev] + rows - 1) / rows;
  const int64_t most = (units + (int64_t)kThreads * kUnroll - 1)
                       / ((int64_t)kThreads * kUnroll);
  return want < 1 ? 1 : (want < most ? want : most);
}

// Calls f(f32 bits) on each element of this CTA's share of the row, with
// kUnroll units' loads in flight a thread.
template <typename T, bool kVecPath, typename F>
__device__ __forceinline__ void for_each_share(const T* xr, int64_t n, F&& f) {
  constexpr int V = kVecPath ? kVec<T> : 1;
  const int64_t units = n / V;
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < units; base += step) {
    uint32_t b[kUnroll][V];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t u = base + (int64_t)i * kThreads;
      if (u < units) {
        if constexpr (kVecPath) unpack<T>(__ldg(reinterpret_cast<const uint4*>(xr) + u), b[i]);
        else b[i][0] = f32_bits(xr[u]);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      if (base + (int64_t)i * kThreads < units) {
#pragma unroll
        for (int j = 0; j < V; ++j) f(b[i][j]);
      }
  }
}

// One digit pass p of the wide rows (grid: CTAs a row x rows). Pass 0
// also takes the row's largest key. The row's last CTA picks the digit
// and, at the last pass (or on a dense row), writes [scale, thresh].
template <typename T, bool kVecPath>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ x, uint32_t* __restrict__ ws,
            float* __restrict__ st, int64_t n, int64_t k, int p, int last) {
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_sums[kThreads / 32];
  __shared__ uint32_t sel[2];
  __shared__ int is_last;
  const int64_t row = blockIdx.y;
  uint32_t* w = ws + row * kWsWords;
  const bool sparse = k >= 1 && k < n;
  const int shift = kShift[p], nb = 1 << kWidth[p];
  const uint32_t prefix = p ? w[kPrefix] : 0;
  if (sparse) {
    for (int b = threadIdx.x; b < nb; b += kThreads) hist[b] = 0;
    __syncthreads();
  }
  uint32_t lmax = 0;
  for_each_share<T, kVecPath>(x + row * n, n, [&](uint32_t bits) {
    const uint32_t key = bits & 0x7fffffffu;
    lmax = max(lmax, key);
    if (sparse && in_prefix(key, p, prefix))
      atomicAdd(&hist[(key >> shift) & (nb - 1)], 1u);
  });
  if (p == 0) {
    const uint32_t m = block_max(lmax, warp_sums);
    if (threadIdx.x == 0) atomicMax(&w[kAmax], m);
  } else {
    __syncthreads();
  }
  if (sparse)
    for (int b = threadIdx.x; b < nb; b += kThreads)
      if (hist[b]) atomicAdd(&w[b], hist[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&w[kDone], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  // the row's last CTA: every other CTA's counts are in the workspace
  __threadfence();
  uint32_t thresh = 0;
  if (sparse) {
    // L2 loads, all in flight at once (the other CTAs' atomics are done
    // and fenced), then plain stores that zero the bins for the next pass
    for (int b = threadIdx.x; b < nb; b += kThreads) hist[b] = __ldcg(&w[b]);
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += kThreads) w[b] = 0u;
    const uint32_t rank = p ? __ldcg(&w[kRank]) : (uint32_t)k;
    select_digit(hist, nb, rank, warp_sums, sel);
    const uint32_t chosen = (prefix << kWidth[p]) | sel[0];
    if (threadIdx.x == 0) {
      w[kPrefix] = chosen;
      w[kRank] = sel[1];
    }
    thresh = chosen << shift;
  }
  if (threadIdx.x == 0) {
    w[kDone] = 0;
    if (p == last) {
      st[2 * row] = clamp_scale(__ldcg(&w[kAmax]));
      st[2 * row + 1] = __uint_as_float(thresh);
    }
  }
}

// The pass given each row's [scale, thresh] (grid: CTAs a row x rows).
template <typename T, bool kQuantize, bool kVecPath>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const T* __restrict__ x, const float* __restrict__ st,
            T* __restrict__ out, int64_t n) {
  constexpr int V = kVecPath ? kVec<T> : 1;
  const int64_t row = blockIdx.y;
  const Codec c(st[2 * row], st[2 * row + 1]);
  const T* xr = x + row * n;
  T* orow = out + row * n;
  const int64_t units = n / V;
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < units; base += step) {
    uint32_t b[kUnroll][V];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t u = base + (int64_t)i * kThreads;
      if (u < units) {
        if constexpr (kVecPath) unpack<T>(__ldg(reinterpret_cast<const uint4*>(xr) + u), b[i]);
        else b[i][0] = f32_bits(xr[u]);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int64_t u = base + (int64_t)i * kThreads;
      if (u < units) {
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = c.apply<kQuantize>(__uint_as_float(b[i][j]));
        if constexpr (kVecPath) reinterpret_cast<uint4*>(orow)[u] = pack<T>(v);
        else store_f32(orow + u, v[0]);
      }
    }
  }
}

template <typename T>
bool vec_ok(const void* x, const void* out, int64_t n) {
  return (n * (int64_t)sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0
         && (uintptr_t)out % 16 == 0;
}

template <typename T, bool kVecPath>
int launch_pass(const T* x, const float* st, T* out, int64_t rows, int64_t n,
                int quantize, cudaStream_t s) {
  const int64_t units = n / (kVecPath ? kVec<T> : 1);
  const dim3 grid((unsigned)ctas_per_row(rows, units), (unsigned)rows);
  if (quantize) pass_kernel<T, true, kVecPath><<<grid, kThreads, 0, s>>>(x, st, out, n);
  else pass_kernel<T, false, kVecPath><<<grid, kThreads, 0, s>>>(x, st, out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int pass(const void* x, const void* st, void* out, int64_t rows, int64_t n,
         int quantize, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const float* stp = static_cast<const float*>(st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec_ok<T>(x, out, n)
             ? launch_pass<T, true>(xp, stp, op, rows, n, quantize, s)
             : launch_pass<T, false>(xp, stp, op, rows, n, quantize, s);
}

template <typename T, bool kVecPath>
int launch_hist(const T* x, uint32_t* ws, float* st, int64_t rows, int64_t n,
                int64_t k, int passes, cudaStream_t s) {
  const int64_t units = n / (kVecPath ? kVec<T> : 1);
  const dim3 grid((unsigned)ctas_per_row(rows, units), (unsigned)rows);
  for (int p = 0; p < passes; ++p) {
    hist_kernel<T, kVecPath><<<grid, kThreads, 0, s>>>(x, ws, st, n, k, p,
                                                       passes - 1);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

template <typename T>
int fused(const void* x, void* out, void* st, void* ws, int64_t rows,
          int64_t n, int64_t k, int quantize, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  float* stp = static_cast<float*>(st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kNarrowMax) {
    if (quantize) narrow_kernel<T, true><<<(unsigned)rows, kThreads, 0, s>>>(xp, op, stp, n, k);
    else narrow_kernel<T, false><<<(unsigned)rows, kThreads, 0, s>>>(xp, op, stp, n, k);
    return (int)cudaGetLastError();
  }
  if (rows > 65535 || ws == nullptr) return (int)cudaErrorInvalidValue;
  uint32_t* wp = static_cast<uint32_t*>(ws);
  int err = (int)cudaMemsetAsync(wp, 0, (size_t)rows * kWsWords * 4, s);
  if (err) return err;
  const int passes = (k >= 1 && k < n) ? (sizeof(T) == 2 ? 2 : kPasses) : 1;
  err = vec_ok<T>(x, x, n) ? launch_hist<T, true>(xp, wp, stp, rows, n, k, passes, s)
                           : launch_hist<T, false>(xp, wp, stp, rows, n, k, passes, s);
  if (err) return err;
  return pass<T>(x, st, out, rows, n, quantize, stream);
}

}  // namespace

// Plain C entry points for ctypes. x and out are contiguous (rows, n) of
// the named dtype, st contiguous (rows, 2) f32, all on the device of
// `stream`. Each returns cudaGetLastError() after its launches (0 when
// all were taken).
//
// wire_codec_*: the pass alone, given each row's [scale, thresh] in st.
extern "C" int wire_codec_f32(const void* x, const void* st, void* out,
                              int64_t rows, int64_t n, int quantize,
                              void* stream) {
  return pass<float>(x, st, out, rows, n, quantize, stream);
}

extern "C" int wire_codec_bf16(const void* x, const void* st, void* out,
                               int64_t rows, int64_t n, int quantize,
                               void* stream) {
  return pass<__nv_bfloat16>(x, st, out, rows, n, quantize, stream);
}

// wire_codec_fused_*: the whole round trip, keeping the k largest |x| a
// row (k >= n: dense); writes out and each row's [scale, thresh] to st.
// ws is a (rows, 2052) uint32 workspace on the device for n > 8192
// (zeroed here), unused (may be null) otherwise.
extern "C" int wire_codec_fused_f32(const void* x, void* out, void* st,
                                    void* ws, int64_t rows, int64_t n,
                                    int64_t k, int quantize, void* stream) {
  return fused<float>(x, out, st, ws, rows, n, k, quantize, stream);
}

extern "C" int wire_codec_fused_bf16(const void* x, void* out, void* st,
                                     void* ws, int64_t rows, int64_t n,
                                     int64_t k, int quantize, void* stream) {
  return fused<__nv_bfloat16>(x, out, st, ws, rows, n, k, quantize, stream);
}
