// DSNT raw moments of heatmaps stored as rows: online softmax plus the eight
// spatial moments [1, x, y, x^2, y^2, xy, x^3, y^3], one read of the logits.
//
// Replaces contouring_uncertainty_tpu/ops/pallas_dsnt.py `_raw_moments_pallas`
// (Pallas kernel `_dsnt_kernel`): (rows, H*W) logits in bf16, f16 or f32,
// each row one heatmap, -> (rows, 8) f32 normalised raw moments of
// softmax(logits) over the cell-centre grid (2i+1)/L - 1.
//
// What bounds it on an H100: device memory. A serving view reads 420
// heatmaps x 65536 px of bf16 (55 MB) once and writes 420 x 8 floats:
// 16.4 us at 3.35 TB/s. The design keeps the work per pixel and the
// synchronisation low enough that the loads are the limit:
//
// - Separable accumulation. A thread owns fixed columns: one 16-byte load
//   is 8 bf16 (or 4 f32) neighbouring pixels of one image row, so 32
//   threads cover a 256-px image row. Per column it keeps sum(e) and
//   sum(e*y) (y, the row's basis value, is one per load), and per thread
//   sum(e*y^2) and sum(e*y^3) over its columns. The eight moments come out
//   of these once, at the end, with the columns' x, x^2 and x^3 in
//   registers: about 6 instructions per pixel (unpack, max, subtract and
//   exp, two accumulations).
// - Per-thread online max, lazy rescale. Each thread keeps its own running
//   max and rescales its accumulators only when a load raises it, which is
//   rare after the first rows of a peaked heatmap. Threads are combined
//   once, log-sum-exp style, when the block reduces: no reduction across
//   warps runs in the loop.
// - Bytes in flight. Each thread issues the loads of 16 pixels (two 16-byte
//   loads in bf16/f16, four in f32) before it uses any: 8 KB (16 KB in f32)
//   per 256-thread block, with five or more blocks resident per SM (48
//   registers a thread), so that ~40 KB or more are in flight per SM where
//   ~20 KB cover the memory latency. More loads per thread cost registers
//   and so resident blocks.
// - Balance over 132 SMs. With enough heatmaps (420 on the serving path)
//   there is one block per heatmap and all of them are resident at once,
//   sharing the memory bandwidth. With fewer heatmaps than SMs each is
//   split into `bands` bands of whole image rows, one block each. The
//   bands of one heatmap form one thread-block cluster: each block leaves
//   its partial (max, 8 sums) in its shared memory and the cluster's first
//   block combines them through distributed shared memory. One launch, no
//   partials in device memory, no second kernel. Only below one block per
//   SM does the split pay (1.5-1.8x at 21 and 42 heatmaps of 256^2); at
//   210 and 420 it is slower (PERF.md, chip_smoke.py [8]).
//
// The basis values are the JAX kernel's f32 values, read from two small
// tables (xs: W values, ys: H values). The exponential is ex2.approx on
// (v - max) * log2(e); its relative error (~2^-22) is far below the bars
// the kernel is held to (mu <= 1e-4 px, sigma relative error <= 1e-3
// against f64), so the library is built with FMA contraction on.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBands = 8;  // the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };  // ops/dsnt_kernel.py DTYPE_CODES

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 16-byte load -> kN floats; kNegInf fills a load past the band's end.
template <int D> struct Pack;
template <> struct Pack<kF32> {
  static constexpr int kN = 4;
  static constexpr unsigned kNegInf = 0xff800000u;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Pack<kBF16> {
  static constexpr int kN = 8;
  static constexpr unsigned kNegInf = 0xff80ff80u;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Pack<kF16> {
  static constexpr int kN = 8;
  static constexpr unsigned kNegInf = 0xfc00fc00u;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x: the heatmaps as 16-byte vectors, row r at x + r * row_stride_vec.
// band_vecs: vectors per band (whole image rows); width_vecs: per image row.
template <int D>
__global__ void __launch_bounds__(kThreads) dsnt_moments_kernel(
    const uint4* __restrict__ x, long long row_stride_vec, int band_vecs, int width_vecs,
    const float* __restrict__ xs, const float* __restrict__ ys, float* __restrict__ out) {
  constexpr int V = Pack<D>::kN;
  constexpr int U = 16 / V;  // 16-byte loads per thread per step
  cg::cluster_group cluster = cg::this_cluster();
  const int bands = static_cast<int>(cluster.num_blocks());
  const int band = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / bands;
  const uint4* src = x + row * row_stride_vec + static_cast<long long>(band) * band_vecs;

  // kThreads is a multiple of width_vecs and every band starts on an image
  // row, so this thread's columns are the same at every step.
  const int col_vec = threadIdx.x % width_vecs;
  const int rows_per_step = kThreads / width_vecs;
  int yrow = band * (band_vecs / width_vecs) + threadIdx.x / width_vecs;

  float m = -FLT_MAX;  // finite, so that (v - m) of a -inf logit is -inf
  float a0[V], a1[V];  // per column: sum e, sum e*y
#pragma unroll
  for (int c = 0; c < V; ++c) a0[c] = a1[c] = 0.0f;
  float b2 = 0.0f, b3 = 0.0f;  // sum e*y^2, sum e*y^3 over the columns

  for (int v0 = threadIdx.x; v0 < band_vecs; v0 += U * kThreads, yrow += U * rows_per_step) {
    float f[U][V];
    float vmax = -FLT_MAX;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * kThreads;
      uint4 r = make_uint4(Pack<D>::kNegInf, Pack<D>::kNegInf, Pack<D>::kNegInf,
                           Pack<D>::kNegInf);
      if (v < band_vecs) r = __ldg(src + v);
      Pack<D>::unpack(r, f[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < V; ++c) vmax = fmaxf(vmax, f[u][c]);
    }
    if (vmax > m) {  // lazy rescale: only when this thread's max rises
      const float s = fast_exp2((m - vmax) * kLog2e);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        a0[c] *= s;
        a1[c] *= s;
      }
      b2 *= s;
      b3 *= s;
      m = vmax;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float y = (v0 + u * kThreads < band_vecs) ? __ldg(ys + yrow + u * rows_per_step) : 0.0f;
      float t = 0.0f;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float e = fast_exp2((f[u][c] - m) * kLog2e);
        a0[c] += e;
        a1[c] = fmaf(e, y, a1[c]);
        t += e;
      }
      const float y2 = y * y;
      b2 = fmaf(t, y2, b2);
      b3 = fmaf(t, y2 * y, b3);
    }
  }

  // This thread's eight sums, relative to its own max m.
  float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, b2, 0.0f, 0.0f, b3};
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const float xv = __ldg(xs + col_vec * V + c);
    const float x2 = xv * xv;
    s[0] += a0[c];
    s[1] = fmaf(xv, a0[c], s[1]);
    s[2] += a1[c];
    s[3] = fmaf(x2, a0[c], s[3]);
    s[5] = fmaf(xv, a1[c], s[5]);
    s[6] = fmaf(x2 * xv, a0[c], s[6]);
  }

  // Block: the max over threads, then every thread's sums rescaled to it.
  __shared__ float warp_max[kWarps];
  __shared__ float warp_sums[kWarps][8];
  __shared__ float part[9];  // this band's (max, 8 sums)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float wm = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, o));
  if (lane == 0) warp_max[warp] = wm;
  __syncthreads();
  float bm = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, warp_max[w]);
  const float scale = fast_exp2((m - bm) * kLog2e);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = warp_sum(s[k] * scale);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sums[w][threadIdx.x];
    part[1 + threadIdx.x] = t;
  }
  if (threadIdx.x == 0) part[0] = bm;

  if (bands == 1) {
    __syncthreads();
    if (threadIdx.x < 8) out[row * 8 + threadIdx.x] = part[1 + threadIdx.x] / part[1];
    return;
  }
  cluster.sync();  // every band's partial is in its block's shared memory
  if (band == 0 && threadIdx.x < 8) {
    float gm = -FLT_MAX;
    for (int r = 0; r < bands; ++r) gm = fmaxf(gm, cluster.map_shared_rank(part, r)[0]);
    float t0 = 0.0f, tk = 0.0f;
    for (int r = 0; r < bands; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      const float w = fast_exp2((p[0] - gm) * kLog2e);
      t0 = fmaf(p[1], w, t0);
      tk = fmaf(p[1 + threadIdx.x], w, tk);
    }
    out[row * 8 + threadIdx.x] = tk / t0;
  }
  cluster.sync();  // no block leaves while the first one reads its shared memory
}

template <int D>
int launch(const void* x, int rows, long long row_stride, int height, int width, int bands,
           const float* xs, const float* ys, float* out, cudaStream_t stream) {
  constexpr int V = Pack<D>::kN;
  const int width_vecs = width / V;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * bands);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = bands;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dsnt_moments_kernel<D>, static_cast<const uint4*>(x), row_stride / V,
      height / bands * width_vecs, width_vecs, xs, ys, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x: (rows, height*width) heatmaps with unit pixel stride and `row_stride`
// elements between rows, 16-byte aligned; dtype 0 f32, 1 bf16, 2 f16.
// xs (width,), ys (height,): f32 basis tables. out: (rows, 8) f32.
// bands in 1..8 divides height; 256 is a multiple of width / (16 / itemsize).
// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int cu_dsnt_moments(const void* x, int dtype, int rows, long long row_stride,
                               int height, int width, int bands,
                               const float* xs, const float* ys, float* out, void* stream) {
  if (rows == 0) return 0;
  const int vec = dtype == kF32 ? 4 : 8;
  if (dtype < kF32 || dtype > kF16 || bands < 1 || bands > kMaxBands || height % bands != 0
      || width < vec || width % vec != 0 || kThreads % (width / vec) != 0 || row_stride % vec != 0
      || reinterpret_cast<unsigned long long>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<kF32>(x, rows, row_stride, height, width, bands, xs, ys, out, s);
    case kBF16: return launch<kBF16>(x, rows, row_stride, height, width, bands, xs, ys, out, s);
    default: return launch<kF16>(x, rows, row_stride, height, width, bands, xs, ys, out, s);
  }
}
