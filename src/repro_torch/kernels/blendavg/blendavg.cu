// BlendAvg parameter blend (paper Eq. 11) over every leaf of a stacked
// tree in one launch: for each leaf, out[n] = sum_l omega[l] * x[l, n].
//
// Replaces the TPU kernel src/repro/kernels/blendavg/blendavg.py:29
// (blend_params_pallas, its pl.pallas_call and _kernel body), which
// streams each (L, block_n) tile of one leaf through VMEM once and
// writes each output once, one pallas_call a leaf.
//
// Arithmetic: each product omega_l * x[l, n] is rounded to f32 and
// added to an f32 accumulator in l order (__fmul_rn / __fadd_rn, so the
// compiler does not contract them into an FMA), then the sum is stored
// once in x's dtype (f32, or bf16 rounded to nearest even). No fast
// math. Every column is summed the same way whichever path, tile or
// launch computes it, so a tree launch equals one-leaf launches bit for
// bit.
//
// Bound: HBM bytes. A leaf reads L*N*itemsize + 4*L bytes and writes
// N*itemsize; 2 f32 operations per input element are far below the
// card's compute rate. A full-width round blends 13 + 13 + 4 leaves in
// three launches (groups A, B and M), 0.22 ms of bytes at 3.35 TB/s.
//
// Layout. The launcher passes a segment table by value (one segment a
// leaf, at most kMaxSegs a launch): the leaf's input and output
// pointers, its N, whether it takes the 16-byte path, and its first
// tile. A leaf whose pointers are 16-byte aligned and whose N fills
// whole 16-byte vectors is cut into units of one vector (4 f32 or 8
// bf16 columns) and loads each row's vector with one 16-byte load; any
// other leaf (a 25-wide head) takes one column a unit. Each thread
// issues kInFlight = R x U loads before it adds them in l order: R rows
// of U units (16 x 1 from 9 rows up, 8 x 2 at 5-8 rows, 4 x 4 up to 4),
// so a thread keeps 16 loads in flight whatever the row count. A tile is
// kThreads x U units of one leaf. The grid, sized by the launcher from
// the SM count over all of the call's tiles, walks the tiles with a
// stride; a block finds its tile's segment by a binary search over the
// table, the same for all its threads. omega is staged in shared memory
// once per block. The table is a __grid_constant__ parameter: indexing
// it at run time reads the parameter bank, never a local copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 256;  // omega staged in shared memory
constexpr int kMaxSegs = 64;   // segments a launch (MAX_SEGMENTS in blendavg.py)
constexpr int kInFlight = 16;  // loads a thread issues before its adds
constexpr int kCtasPerSm = 2;  // CTAS_PER_SM in blendavg.py

struct Seg {
  const void* x;   // (L, n) rows of the leaf
  void* out;       // (n,)
  int64_t n;
  int64_t tile0;   // first tile of this segment in the launch
};

struct Table {
  Seg seg[kMaxSegs];
  uint64_t vec;    // bit s: segment s takes the 16-byte path
  int n_segs;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// one 16-byte vector: 4 f32 or 8 bf16 columns
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
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
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16 lo = __float2bfloat16(v[2 * i]);
      const __nv_bfloat16 hi = __float2bfloat16(v[2 * i + 1]);
      w[i] = (uint32_t)__bfloat16_as_ushort(lo)
             | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Units u0 + i*kThreads (i < U) of a 16-byte segment: columns
// [u*kVec, u*kVec + kVec) each, R rows' loads of each in flight.
template <typename T, int R, int U>
__device__ __forceinline__ void blend_vec(const Seg& s, int64_t u0,
                                          const float* w, int rows) {
  constexpr int V = kVec<T>;
  const int64_t units = s.n / V;  // vectors a row
  const uint4* x = static_cast<const uint4*>(s.x);
  float acc[U][V];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0.0f;
  for (int l0 = 0; l0 < rows; l0 += R) {
    uint4 r[R][U];
#pragma unroll
    for (int l = 0; l < R; ++l)
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int64_t u = u0 + (int64_t)i * kThreads;
        r[l][i] = (l0 + l < rows && u < units) ? __ldg(x + (int64_t)(l0 + l) * units + u)
                                               : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
    for (int l = 0; l < R; ++l) {
      if (l0 + l < rows) {
        const float wl = w[l0 + l];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          float v[V];
          unpack<T>(r[l][i], v);
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(wl, v[j]));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int64_t u = u0 + (int64_t)i * kThreads;
    if (u < units) static_cast<uint4*>(s.out)[u] = pack<T>(acc[i]);
  }
}

// The same over columns u0 + i*kThreads of a scalar segment.
template <typename T, int R, int U>
__device__ __forceinline__ void blend_scalar(const Seg& s, int64_t u0,
                                             const float* w, int rows) {
  const T* x = static_cast<const T*>(s.x);
  float acc[U];
#pragma unroll
  for (int i = 0; i < U; ++i) acc[i] = 0.0f;
  for (int l0 = 0; l0 < rows; l0 += R) {
    float r[R][U];
#pragma unroll
    for (int l = 0; l < R; ++l)
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int64_t u = u0 + (int64_t)i * kThreads;
        r[l][i] = (l0 + l < rows && u < s.n) ? to_f32(x[(int64_t)(l0 + l) * s.n + u]) : 0.0f;
      }
#pragma unroll
    for (int l = 0; l < R; ++l)
      if (l0 + l < rows)
#pragma unroll
        for (int i = 0; i < U; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(w[l0 + l], r[l][i]));
  }
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int64_t u = u0 + (int64_t)i * kThreads;
    if (u < s.n) store_f32(static_cast<T*>(s.out) + u, acc[i]);
  }
}

template <typename T, int R, int U>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
blend_kernel(const __grid_constant__ Table t, const float* __restrict__ omega,
             int rows, int64_t tiles) {
  __shared__ float w[kMaxRows];
  for (int l = threadIdx.x; l < rows; l += blockDim.x) w[l] = omega[l];
  __syncthreads();
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int lo = 0, hi = t.n_segs - 1;  // the last segment starting at or before tile
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.seg[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
    }
    const Seg& s = t.seg[lo];
    const int64_t u0 = (tile - s.tile0) * kThreads * U + threadIdx.x;
    if ((t.vec >> lo) & 1u) blend_vec<T, R, U>(s, u0, w, rows);
    else blend_scalar<T, R, U>(s, u0, w, rows);
  }
}

// Units a thread takes a tile (U of R x U; units_for in blendavg.py): rows 9 and up 1, 5-8 rows 2, up to 4 rows 4.
__host__ __device__ constexpr int units_for(int rows) {
  return rows > 8 ? 1 : (rows > 4 ? 2 : 4);
}

template <typename T>
int launch(const int64_t* table, int n_segs, const void* omega, int rows,
           int64_t tiles, int grid, void* stream) {
  if (rows < 1 || rows > kMaxRows || n_segs < 1 || n_segs > kMaxSegs
      || tiles < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  Table t = {};
  t.n_segs = n_segs;
  for (int s = 0; s < n_segs; ++s) {
    const int64_t* e = table + 5 * s;  // x, out, n, tile0, vec
    t.seg[s].x = reinterpret_cast<const void*>(e[0]);
    t.seg[s].out = reinterpret_cast<void*>(e[1]);
    t.seg[s].n = e[2];
    t.seg[s].tile0 = e[3];
    if (e[4]) t.vec |= (uint64_t)1 << s;
  }
  const float* w = static_cast<const float*>(omega);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (units_for(rows)) {
    case 1: blend_kernel<T, kInFlight, 1><<<(unsigned)grid, kThreads, 0, s>>>(t, w, rows, tiles); break;
    case 2: blend_kernel<T, kInFlight / 2, 2><<<(unsigned)grid, kThreads, 0, s>>>(t, w, rows, tiles); break;
    default: blend_kernel<T, kInFlight / 4, 4><<<(unsigned)grid, kThreads, 0, s>>>(t, w, rows, tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. table holds n_segs rows of five
// int64 (input pointer, output pointer, n, first tile, 16-byte path),
// in host memory, as blendavg.plan lays them out; every input is a
// contiguous (rows, n) array of the named dtype, every output a
// contiguous (n,) one, omega contiguous (rows,) f32, all on the device
// of `stream`; 1 <= rows <= 256, 1 <= n_segs <= 64. tiles is the
// launch's tile count, grid its block count. Returns cudaGetLastError()
// after the launch.
extern "C" int blend_tree_f32(const int64_t* table, int n_segs,
                              const void* omega, int rows, int64_t tiles,
                              int grid, void* stream) {
  return launch<float>(table, n_segs, omega, rows, tiles, grid, stream);
}

extern "C" int blend_tree_bf16(const int64_t* table, int n_segs,
                               const void* omega, int rows, int64_t tiles,
                               int grid, void* stream) {
  return launch<__nv_bfloat16>(table, n_segs, omega, rows, tiles, grid,
                               stream);
}
