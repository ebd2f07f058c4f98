// DSNT raw moments: online softmax plus the eight spatial moments [1, x, y,
// x^2, y^2, xy, x^3, y^3], one read of the logits. Two kernels, one per
// layout: K2 (below) for heatmaps stored as rows, K1 (further down, with its
// own note) for heatmaps stored as columns.
//
// K2 replaces contouring_uncertainty_tpu/ops/pallas_dsnt.py `_raw_moments_pallas`
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
// against f64), so the library is built with FMA contraction on. Both
// kernels share these.

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

// Element i of a run of packed elements held as 32-bit words (little-endian:
// element 2i of a 16-bit type is the low half of word i); the elementwise
// max of two such words; kNegInf fills a word past the data's end; unpack:
// one 16-byte load -> kN floats.
template <int D> struct Pack;
template <> struct Pack<kF32> {
  static constexpr int kBytes = 4;
  static constexpr int kN = 4;
  static constexpr unsigned kNegInf = 0xff800000u;
  __device__ __forceinline__ static float at(const unsigned* w, int i) {
    return __uint_as_float(w[i]);
  }
  __device__ __forceinline__ static unsigned max_word(unsigned a, unsigned b) {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Pack<kBF16> {
  static constexpr int kBytes = 2;
  static constexpr int kN = 8;
  static constexpr unsigned kNegInf = 0xff80ff80u;
  __device__ __forceinline__ static float at(const unsigned* w, int i) {
    const unsigned h = w[i >> 1];
    return __uint_as_float((i & 1) ? (h & 0xffff0000u) : (h << 16));
  }
  __device__ __forceinline__ static unsigned max_word(unsigned a, unsigned b) {
    unsigned r;
    asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = at(w, i);
  }
};
template <> struct Pack<kF16> {
  static constexpr int kBytes = 2;
  static constexpr int kN = 8;
  static constexpr unsigned kNegInf = 0xfc00fc00u;
  __device__ __forceinline__ static float at(const unsigned* w, int i) {
    const unsigned h = w[i >> 1];
    return __half2float(__ushort_as_half(static_cast<unsigned short>((i & 1) ? h >> 16 : h & 0xffffu)));
  }
  __device__ __forceinline__ static unsigned max_word(unsigned a, unsigned b) {
    unsigned r;
    asm("max.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = at(w, i);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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
  __shared__ float warp_maxes[kWarps];
  __shared__ float warp_sums[kWarps][8];
  __shared__ float part[9];  // this band's (max, 8 sums)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float wm = warp_max(m);
  if (lane == 0) warp_maxes[warp] = wm;
  __syncthreads();
  float bm = warp_maxes[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, warp_maxes[w]);
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

// K1: DSNT raw moments of heatmaps stored as the columns of an (HW, N)
// tensor. Replaces pallas_dsnt.py `_raw_moments_pallas_cols` (Pallas kernel
// `_dsnt_kernel_cols`): the same (N, 8) normalised raw moments.
//
// What bounds it on an H100: device memory, as for K2 (420 columns x 65536
// px of bf16, 55 MB, read once: 16.4 us at 3.35 TB/s). A pixel row of 420
// bf16 is 840 bytes, 8-byte aligned but not 16: TMA's tensor copies cannot
// take it (their strides are multiples of 16 bytes), so the loads are
// per-thread vector copies.
//
// - Columns owned, loads coalesced. A thread owns C adjacent columns and
//   loads them as one VB-byte vector (VB the largest of 16, 8, 4, 2 that
//   divides the address, the row stride and N in bytes, at most 4 columns:
//   8 bytes at the serving shape). Consecutive vectors of a pixel row go to
//   consecutive groups of `lanes` threads, so a warp reads whole stretches
//   of pixel rows and every thread loads useful bytes: 105 vectors a row at
//   N = 420, no padding to a power of two.
// - Separable accumulation along image rows. A lane takes runs of RUN
//   pixels of one image row (RUN * VB = 64 bytes) at a step of lanes * RUN
//   pixels. Per column it keeps sum(e) and sum(e*x) of the current image
//   row and sum(e*x^2), sum(e*x^3) of all its pixels (x from the f32 basis
//   table, one broadcast load per pixel); when the image row changes it
//   folds the row's two sums into the y-weighted moments with y, y^2 and
//   y^3: 4 accumulations per element, where eight moments per element and
//   a block-wide max per chunk cost about 25 instructions.
// - Online max per thread and column, lazy rescale: a column's sums are
//   rescaled only when a run raises its max (taken on the packed words, two
//   16-bit columns per instruction). The lanes of a vector are combined
//   once, log-sum-exp style, with warp shuffles.
// - Bytes in flight without registers: each thread keeps its next run in
//   flight as cp.async copies into its own slots of a shared-memory ring
//   while it computes on the current one. Copies issued from registers
//   would hold ~16 more registers a thread.
// - Filling 132 SMs: the pixels are split into bands of whole image rows
//   (grid x, one block per SM at the serving shape) and, above 256 vectors a
//   row, the columns into tiles (grid y). Each band writes its partial
//   (max, 8 sums) per column as rows of N consecutive floats, so the block's
//   stores are contiguous; a second small kernel on the same stream, one
//   thread per column and band slice, combines them. One band writes the
//   moments directly.

constexpr int kColsMaxThreads = 448;  // ops/dsnt_kernel.py COLS_MAX_THREADS
constexpr int kColsStages = 2;        // runs in each thread's copy ring
constexpr int kColsLoadBytes = 64;    // bytes a thread loads per run ...
constexpr int kColsMaxRun = 16;       // ... in at most this many pixels
constexpr int kColsMaxCols = 4;       // columns a thread owns (registers)
constexpr float kColsInitMax = -1.0e30f;  // finite, so (v - max) of a -inf logit is -inf

// A VB-byte vector as 32-bit words (a 2-byte vector: the low half of one).
template <int VB> struct Vec;
template <> struct Vec<16> {
  using T = uint4;
  __device__ __forceinline__ static void words(T r, unsigned* w) {
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  }
};
template <> struct Vec<8> {
  using T = uint2;
  __device__ __forceinline__ static void words(T r, unsigned* w) {
    w[0] = r.x;
    w[1] = r.y;
  }
};
template <> struct Vec<4> {
  using T = unsigned;
  __device__ __forceinline__ static void words(T r, unsigned* w) { w[0] = r; }
};
template <> struct Vec<2> {
  using T = unsigned short;
  __device__ __forceinline__ static void words(T r, unsigned* w) { w[0] = r; }
};

template <int D, int VB>
constexpr bool cols_vec_ok() {
  return VB >= Pack<D>::kBytes && VB <= kColsMaxCols * Pack<D>::kBytes;
}

// Copy one VB-byte vector from device to shared memory without holding a
// register: cp.async (4, 8 or 16 bytes); a 2-byte vector goes through one.
template <int VB>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VB == 2) {
    *static_cast<unsigned short*>(dst) = __ldg(static_cast<const unsigned short*>(src));
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (VB == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(VB)
                   : "memory");
    }
  }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x: the (HW, N) heatmaps as VB-byte vectors, pixel row p at x + p * ld_vec.
// Grid (bands, tiles); block (tile_vecs x lanes) threads rounded up to whole
// warps, lanes fastest (a power of two up to 32, so a vector's lanes share a
// warp). Lane j takes the runs of RUN pixels starting at j * RUN, j * RUN +
// lanes * RUN, ... of its band, each in one image row (RUN | width). Shared
// memory: each thread's ring of kColsStages runs, (stage, RUN, threads)
// vectors. The maxima are kept scaled by log2(e). part: (bands, 9, N)
// partials; out: (N, 8) when bands == 1.
template <int D, int VB, int RUN>
__global__ void __launch_bounds__(kColsMaxThreads) dsnt_moments_cols_kernel(
    const void* __restrict__ x, long long ld_vec, int n_vec, int tile_vecs, int lanes,
    int height, int width, const float* __restrict__ xs, const float* __restrict__ ys,
    float* __restrict__ part, float* __restrict__ out) {
  constexpr int C = VB / Pack<D>::kBytes;  // columns this thread owns
  constexpr int NW = (VB + 3) / 4;         // 32-bit words per vector
  constexpr int S = kColsStages;
  using T = typename Vec<VB>::T;
  const int threads = static_cast<int>(blockDim.x);
  const int tid = static_cast<int>(threadIdx.x);
  const int bands = static_cast<int>(gridDim.x);
  const int band = static_cast<int>(blockIdx.x);
  const int t = tid / lanes;
  const int lane = tid % lanes;
  const int vec = static_cast<int>(blockIdx.y) * tile_vecs + t;
  const bool active = t < tile_vecs && vec < n_vec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  // Band b holds image rows [b * H / bands, (b + 1) * H / bands).
  int row = static_cast<int>(static_cast<long long>(band) * height / bands);
  const int row_end = static_cast<int>(static_cast<long long>(band + 1) * height / bands);
  const int n_pix = (row_end - row) * width;
  const int step = lanes * RUN;
  const T* src = static_cast<const T*>(x) + static_cast<long long>(row) * width * ld_vec + vec;

  // Per column: scaled max; the current image row's sum e and sum e*x; all
  // pixels' sum e*x^2, sum e*x^3; the folded rows' sum e, sum e*x, sum e*y,
  // sum e*y^2, sum e*xy, sum e*y^3.
  float ml[C], r0[C], r1[C], s3[C], s6[C], f1[C], f2[C], f3[C], f5[C], f6[C], f8[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ml[c] = kColsInitMax * kLog2e;
    r0[c] = r1[c] = s3[c] = s6[c] = 0.0f;
    f1[c] = f2[c] = f3[c] = f5[c] = f6[c] = f8[c] = 0.0f;
  }
  auto fold = [&](int yr) {  // the row's sums into the y-weighted moments
    const float y = __ldg(ys + yr);
    const float y2 = y * y;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      f1[c] += r0[c];
      f2[c] += r1[c];
      f3[c] = fmaf(r0[c], y, f3[c]);
      f5[c] = fmaf(r0[c], y2, f5[c]);
      f6[c] = fmaf(r1[c], y, f6[c]);
      f8[c] = fmaf(r0[c], y2 * y, f8[c]);
      r0[c] = r1[c] = 0.0f;
    }
  };
  auto issue = [&](int stage, int p) {  // run at band pixel p -> ring stage
    if (p < n_pix) {
      const T* s = src + static_cast<long long>(p) * ld_vec;
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        copy_async<VB>(ring + (stage * RUN + u) * threads + tid, s + u * ld_vec);
      }
    }
    copy_commit();
  };
  // One run: its max per column (lazy rescale), then the four sums.
  auto consume = [&](int stage, int w) {
    unsigned wd[RUN][NW];
#pragma unroll
    for (int u = 0; u < RUN; ++u) Vec<VB>::words(ring[(stage * RUN + u) * threads + tid], wd[u]);
    unsigned mx[NW];  // the run's max of each column, still packed
#pragma unroll
    for (int i = 0; i < NW; ++i) mx[i] = wd[0][i];
#pragma unroll
    for (int u = 1; u < RUN; ++u) {
#pragma unroll
      for (int i = 0; i < NW; ++i) mx[i] = Pack<D>::max_word(mx[i], wd[u][i]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float vl = Pack<D>::at(mx, c) * kLog2e;
      if (vl > ml[c]) {  // lazy rescale: only when this column's max rises
        const float sc = fast_exp2(ml[c] - vl);
        r0[c] *= sc;
        r1[c] *= sc;
        s3[c] *= sc;
        s6[c] *= sc;
        f1[c] *= sc;
        f2[c] *= sc;
        f3[c] *= sc;
        f5[c] *= sc;
        f6[c] *= sc;
        f8[c] *= sc;
        ml[c] = vl;
      }
    }
#pragma unroll
    for (int u = 0; u < RUN; ++u) {
      const float xv = __ldg(xs + w + u);
      const float x2 = xv * xv;
      const float x3 = x2 * xv;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float e = fast_exp2(fmaf(Pack<D>::at(wd[u], c), kLog2e, -ml[c]));
        r0[c] += e;
        r1[c] = fmaf(e, xv, r1[c]);
        s3[c] = fmaf(e, x2, s3[c]);
        s6[c] = fmaf(e, x3, s6[c]);
      }
    }
  };

  if (active) {
    int q = lane * RUN;
    int w = q;  // column of the run's first pixel in its image row
    while (w >= width) {
      w -= width;
      ++row;
    }
    // S - 1 runs in flight ahead of the one being used.
#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s, q + s * step);
    for (int stage = 0; q < n_pix; q += step, stage = (stage + 1) % S) {
      issue((stage + S - 1) % S, q + (S - 1) * step);
      copy_wait<S - 1>();  // this thread's run `stage` has landed
      consume(stage, w);
      w += step;
      if (w >= width) {  // the next run starts on a later image row
        fold(row);
        do {
          w -= width;
          ++row;
        } while (w >= width);
      }
    }
    if (row < row_end) fold(row);
  }
  copy_wait<0>();

  // The lanes of each vector, log-sum-exp style across the warp: the max,
  // then every lane's sums rescaled to it and summed.
  float p[9][C];  // (scaled max, 8 sums) of each owned column
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float gm = ml[c];
    for (int o = 1; o < lanes; o <<= 1) gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, o));
    const float wt = fast_exp2(ml[c] - gm);
    const float v[8] = {f1[c], f2[c], f3[c], s3[c], f5[c], f6[c], s6[c], f8[c]};
    p[0][c] = gm;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float a = v[k] * wt;
      for (int o = 1; o < lanes; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      p[1 + k][c] = a;
    }
  }
  // Lane 0 of each vector writes the band's partial (or, with one band, the
  // moments).
  if (lane == 0 && active) {
    const long long n0 = static_cast<long long>(vec) * C;
    if (bands == 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int k = 0; k < 8; ++k) out[(n0 + c) * 8 + k] = p[1 + k][c] / p[1][c];
      }
    } else {
      // Each k is a row of N consecutive floats and each thread's C columns
      // one vector store in it, so a warp's stores are contiguous.
      const long long n = static_cast<long long>(n_vec) * C;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        float* o = part + (static_cast<long long>(band) * 9 + k) * n + n0;
        if constexpr (C == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(p[k][0], p[k][1], p[k][2], p[k][3]);
        } else if constexpr (C == 2) {
          *reinterpret_cast<float2*>(o) = make_float2(p[k][0], p[k][1]);
        } else {
          *o = p[k][0];
        }
      }
    }
  }
}

// The bands' partials -> each column's normalised moments. A block takes
// kCombineCols consecutive columns (threads x, so every load is contiguous)
// and splits the bands over kCombineSlices threads y, each walking its few
// bands with a running max and lazy rescale; the slices are then merged
// pairwise, log-sum-exp style, through shared memory. Maxima are scaled by
// log2(e).
constexpr int kCombineCols = 32;
constexpr int kCombineSlices = 32;

__global__ void __launch_bounds__(kCombineCols * kCombineSlices) dsnt_moments_cols_combine_kernel(
    const float* __restrict__ part, int n, int bands, float* __restrict__ out) {
  __shared__ float slices[kCombineSlices][9][kCombineCols];
  const int tx = static_cast<int>(threadIdx.x);
  const int ty = static_cast<int>(threadIdx.y);
  const int col = static_cast<int>(blockIdx.x) * kCombineCols + tx;
  float m = kColsInitMax * kLog2e;
  float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  auto merge = [&](float m2, const float* s2, int stride) {
    const float gm = fmaxf(m, m2);
    const float a = fast_exp2(m - gm), b = fast_exp2(m2 - gm);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = fmaf(s[k], a, s2[k * stride] * b);
    m = gm;
  };
  if (col < n) {
#pragma unroll 4
    for (int b = ty; b < bands; b += kCombineSlices) {
      const float* p = part + static_cast<long long>(b) * 9 * n + col;
      float v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = __ldg(p + static_cast<long long>(k) * n);
      merge(v[0], v + 1, 1);
    }
  }
  auto keep = [&] {
    slices[ty][0][tx] = m;
#pragma unroll
    for (int k = 0; k < 8; ++k) slices[ty][1 + k][tx] = s[k];
  };
  keep();
  for (int h = kCombineSlices / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (ty < h) {
      merge(slices[ty + h][0][tx], &slices[ty + h][1][tx], kCombineCols);
      keep();
    }
  }
  if (ty == 0 && col < n) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[static_cast<long long>(col) * 8 + k] = s[k] / s[0];
  }
}

template <int D, int VB>
int launch_cols(const void* x, int n, long long row_stride, int height, int width,
                int tile_vecs, int lanes, int run, int bands, const float* xs, const float* ys,
                float* part, float* out, cudaStream_t stream) {
  if constexpr (!cols_vec_ok<D, VB>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int C = VB / Pack<D>::kBytes;
    constexpr int kRun = kColsLoadBytes / VB < kColsMaxRun ? kColsLoadBytes / VB : kColsMaxRun;
    const int n_vec = n / C;
    const int tiles = (n_vec + tile_vecs - 1) / tile_vecs;
    const int threads = (tile_vecs * lanes + 31) / 32 * 32;
    const size_t smem = static_cast<size_t>(kColsStages) * run * VB * threads;
    const auto kernel = run == kRun ? dsnt_moments_cols_kernel<D, VB, kRun>
                                    : dsnt_moments_cols_kernel<D, VB, 1>;
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(bands, tiles), threads, smem, stream>>>(
        x, row_stride / C, n_vec, tile_vecs, lanes, height, width, xs, ys, part, out);
    err = cudaGetLastError();
    if (err != cudaSuccess || bands == 1) return static_cast<int>(err);
    dsnt_moments_cols_combine_kernel<<<(n + kCombineCols - 1) / kCombineCols,
                                       dim3(kCombineCols, kCombineSlices), 0, stream>>>(
        part, n, bands, out);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D>
int launch_cols_dtype(int vec_bytes, const void* x, int n, long long row_stride, int height,
                      int width, int tile_vecs, int lanes, int run, int bands, const float* xs,
                      const float* ys, float* part, float* out, cudaStream_t stream) {
  switch (vec_bytes) {
    case 16:
      return launch_cols<D, 16>(x, n, row_stride, height, width, tile_vecs, lanes, run, bands, xs,
                                ys, part, out, stream);
    case 8:
      return launch_cols<D, 8>(x, n, row_stride, height, width, tile_vecs, lanes, run, bands, xs,
                               ys, part, out, stream);
    case 4:
      return launch_cols<D, 4>(x, n, row_stride, height, width, tile_vecs, lanes, run, bands, xs,
                               ys, part, out, stream);
    default:
      return launch_cols<D, 2>(x, n, row_stride, height, width, tile_vecs, lanes, run, bands, xs,
                               ys, part, out, stream);
  }
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

// K1. x: (hw, n) heatmaps as columns, unit column stride, `row_stride` >= n
// elements between pixel rows; dtype 0 f32, 1 bf16, 2 f16. vec_bytes (2, 4,
// 8 or 16; whole elements, at most 4 a thread) divides x's address, n and
// row_stride in bytes. Grid (bands, tiles of tile_vecs vectors); lanes a
// power of two up to 32; tile_vecs * lanes, rounded up to whole warps, at
// most 448 threads; bands in 1..height. xs (width,),
// ys (height,): f32 basis tables. part: (bands, 9, n) f32 scratch when
// bands > 1 (else unused); out: (n, 8) f32. Launches on `stream`; returns a
// CUDA error code (0 on success).
extern "C" int cu_dsnt_moments_cols(const void* x, int dtype, int hw, int n,
                                    long long row_stride, int height, int width, int vec_bytes,
                                    int tile_vecs, int lanes, int run, int bands, const float* xs,
                                    const float* ys, float* part, float* out, void* stream) {
  if (n == 0) return 0;
  const int item = dtype == kF32 ? 4 : 2;
  const long long n_bytes = static_cast<long long>(n) * item;
  if (dtype < kF32 || dtype > kF16 || hw < 1 || static_cast<long long>(height) * width != hw
      || (vec_bytes != 2 && vec_bytes != 4 && vec_bytes != 8 && vec_bytes != 16)
      || vec_bytes < item || vec_bytes > kColsMaxCols * item || n_bytes % vec_bytes != 0
      || row_stride < n || (row_stride * item) % vec_bytes != 0
      || reinterpret_cast<unsigned long long>(x) % vec_bytes != 0 || tile_vecs < 1 || lanes < 1
      || lanes > 32 || (lanes & (lanes - 1)) != 0
      || (tile_vecs * lanes + 31) / 32 * 32 > kColsMaxThreads
      || (run != 1 && (run != (kColsLoadBytes / vec_bytes < kColsMaxRun ? kColsLoadBytes / vec_bytes
                                                                     : kColsMaxRun)
                       || width % run != 0))
      || bands < 1 || bands > height
      || (n_bytes / vec_bytes + tile_vecs - 1) / tile_vecs > 65535
      || (bands > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_cols_dtype<kF32>(vec_bytes, x, n, row_stride, height, width, tile_vecs, lanes,
                                     run, bands, xs, ys, part, out, s);
    case kBF16:
      return launch_cols_dtype<kBF16>(vec_bytes, x, n, row_stride, height, width, tile_vecs,
                                      lanes, run, bands, xs, ys, part, out, s);
    default:
      return launch_cols_dtype<kF16>(vec_bytes, x, n, row_stride, height, width, tile_vecs, lanes,
                                     run, bands, xs, ys, part, out, s);
  }
}
