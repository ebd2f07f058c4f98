// Exact min-k scanline crossing selection for the even-odd polygon fill.
//
// Replaces contouring_uncertainty_tpu/ops/pallas_select.py `_min_k_crossings`
// (Pallas kernel `_select_kernel`). For each mask m and image row y it
// returns the K = 16 smallest abscissae x0 + ((y - y0) / (y1 - y0)) * (x1 - x0)
// over the closed polygon's edges that straddle y ((y0 > y) != (y1 > y)),
// sorted ascending and padded with +inf. Duplicate values keep their
// multiplicity, so the even-odd parity of the fill is exact.
//
// What bounds it on an H100: device memory, once the work follows the
// crossings. A serving view reads 8 KB of vertices per mask and writes 16 KB
// of crossings per mask (500 masks x 1024 edges x 256 rows), but has only
// ~2 crossings per row. Testing every (row, edge) pair (256 x 1024 straddle
// tests per mask, the row walk below) costs ~100x more issue slots than the
// crossings themselves. The design makes the work scale with edges plus
// crossings:
//
// - One block per mask stages the mask's E vertices in shared memory.
//   Edge-parallel enumeration: each thread takes a run of consecutive edges
//   and visits only the rows between each edge's end points: lo <= y < hi,
//   i.e. ceil(lo) .. ceil(hi) - 1. ceilf is exact and the bounds are
//   clipped to the image in float before any int cast, so the range is the
//   predicate's own; each visited row is still confirmed with the exact
//   straddle predicate, so rounding can neither add nor drop a row. Each
//   crossing is appended to its row's bucket in shared memory through an
//   atomicAdd on the row's count. The buckets of each chunk of blockDim
//   rows are slot-major (slot * blockDim + row in the chunk), so that the
//   per-row reads below hit distinct banks.
// - Long edges are shared out. An edge over more than kShort rows (the
//   straight closing edge of an open contour spans a hundred rows, where a
//   spline edge spans one or two) would keep one thread busy while the
//   block waits for it. Such edges go to a list in shared memory; then every
//   thread takes every blockDim-th (edge, row) pair of the list, so their
//   rows are spread evenly over the block.
// - Per-row selection: one thread per row inserts its bucket into a 16-entry
//   sorted list in registers (strict <, ties kept). The result is the sorted
//   multiset, so the order in which the atomics filled the bucket cannot
//   change a value. The rows, padded with +inf, are gathered into a tile in
//   the chunk's own bucket memory (read by then), so that the block writes
//   them to device memory as consecutive float4s, 512 contiguous bytes per
//   warp store, where each thread storing its own 64-byte row would touch
//   half a sector per lane.
// - A row with more than kCap crossings cannot be held in its bucket; it
//   takes the exact row walk over all E edges (the first design of this
//   kernel, which walked every row; PERF.md keeps the two designs' times).
// - Shared memory is 44 KB at E = 1024 and H = 256 (vertices 8 KB,
//   buckets 32 KB, counts and the long-edge list), so that five blocks are
//   resident per SM and all 500 masks of a view run in one wave.
//
// A crossing whose abscissa is NaN or +inf is no crossing: it never enters
// the list, whose padding is +inf (an edge with a NaN end point straddles no
// row in the enumeration, and gives a NaN abscissa in the walk). Here alone
// the kernel and its plain version differ: the plain version keeps a NaN
// candidate, which torch.topk ranks first. On such input the kernel equals
// the plain selection over the candidates with NaN set to +inf
// (chip_smoke.py [4] checks it); the serving path's splines are finite.
//
// Bitwise parity with the plain PyTorch version (ops/select_kernel.py): the
// library is built with --fmad=false and IEEE division (no --use_fast_math),
// so tt and x0 + tt * (x1 - x0) round exactly as PyTorch's separate
// elementwise ops do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kK = 16;          // K_CROSSINGS of ops/select_kernel.py
constexpr int kCap = 32;        // crossings a row's shared-memory bucket holds
constexpr int kShort = 8;       // rows an edge's own thread enumerates
constexpr int kLong = 128;      // long edges the block shares out
constexpr int kThreads = 256;   // edges, then rows, per block pass

__device__ __forceinline__ float crossing(float4 ed, float yf) {
  const float denom = ed.y - ed.x;
  const float safe = fabsf(denom) < 1e-12f ? 1.0f : denom;
  const float tt = (yf - ed.x) / safe;
  return ed.z + tt * (ed.w - ed.z);
}

// Sorted insertion into the register list v (ascending, +inf padded).
__device__ __forceinline__ void insert(float (&v)[kK], float c) {
  if (c < v[kK - 1]) {
    v[kK - 1] = c;
#pragma unroll
    for (int j = kK - 1; j > 0; --j) {
      const float lo = v[j - 1];
      const float hi = v[j];
      if (hi < lo) {
        v[j - 1] = hi;
        v[j] = lo;
      }
    }
  }
}

// Edge e of the closed polygon as (y0, y1, x0, x1); the last edge wraps to
// vertex 0.
__device__ __forceinline__ float4 edge_at(const float2* __restrict__ poly, int e, int E) {
  const float2 p0 = poly[e];
  const float2 p1 = poly[e + 1 == E ? 0 : e + 1];
  return make_float4(p0.y, p1.y, p0.x, p1.x);
}

// The row walk: every edge tested against row yf (an overflowing row).
template <typename Edges>
__device__ __forceinline__ void walk_row(Edges edges, int E, float yf, float (&v)[kK]) {
  for (int e = 0; e < E; ++e) {
    const float4 ed = edges(e);
    if ((ed.x > yf) != (ed.y > yf)) insert(v, crossing(ed, yf));
  }
}

// Rows first..last that straddle the edge: lo <= y < hi, i.e.
// ceil(lo) .. ceil(hi) - 1, clipped to the image in float before any int
// cast. False for a horizontal edge or a NaN end point, which straddle no
// row, and for an edge outside the image.
__device__ __forceinline__ bool row_range(float4 ed, int H, int& first, int& last) {
  const float lo = fminf(ed.x, ed.y);
  const float hi = fmaxf(ed.x, ed.y);
  if (!(lo < hi)) return false;
  const float last_row = static_cast<float>(H - 1);
  first = static_cast<int>(fminf(fmaxf(ceilf(lo), 0.0f), last_row + 1.0f));
  last = static_cast<int>(fmaxf(fminf(ceilf(hi) - 1.0f, last_row), -1.0f));
  return first <= last;
}

// Slot j of row y's bucket: chunks of kThreads rows, slot-major in each.
__device__ __forceinline__ int bucket_at(int y, int j) {
  return (y / kThreads) * (kCap * kThreads) + j * kThreads + y % kThreads;
}

// Append the edge's crossing of row y, if it straddles it, to y's bucket.
__device__ __forceinline__ void add_crossing(float4 ed, int y, int* count, float* bucket) {
  const float yf = static_cast<float>(y);
  if ((ed.x > yf) == (ed.y > yf)) return;
  const float c = crossing(ed, yf);
  if (!(c < INFINITY)) return;
  const int slot = atomicAdd(&count[y], 1);
  if (slot < kCap) bucket[bucket_at(y, slot)] = c;
}

// Float4 j of the tile's row r, swizzled so that eight threads storing
// float4 j of eight consecutive rows hit eight distinct bank groups.
__device__ __forceinline__ int tile_at(int r, int j) {
  return r * (kK / 4) + (j ^ ((r >> 1) & 3));
}

__global__ void __launch_bounds__(kThreads) min_k_crossings_kernel(
    const float* __restrict__ dense, float* __restrict__ out, int E, int H,
    int* __restrict__ overflow_rows) {
  extern __shared__ float4 smem[];  // 16-byte aligned: the tiles are float4s
  const int chunks = (H + kThreads - 1) / kThreads;
  float* bucket = reinterpret_cast<float*>(smem);                            // (chunks, kCap, kThreads)
  float2* verts = reinterpret_cast<float2*>(bucket + chunks * kCap * kThreads);  // (E,)
  int* count = reinterpret_cast<int*>(verts + E);                            // (H,)
  __shared__ float4 long_edge[kLong];                     // long edges
  __shared__ int long_base[kLong];                        // and their first pair
  __shared__ int n_long, long_rows;
  const float2* poly = reinterpret_cast<const float2*>(dense) + static_cast<size_t>(blockIdx.x) * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) verts[e] = poly[e];
  for (int y = threadIdx.x; y < H; y += blockDim.x) count[y] = 0;
  if (threadIdx.x == 0) n_long = long_rows = 0;
  __syncthreads();

  const int run = (E + blockDim.x - 1) / blockDim.x;
  const int e_end = min(E, (threadIdx.x + 1) * run);
  for (int e = threadIdx.x * run; e < e_end; ++e) {
    const float4 ed = edge_at(verts, e, E);
    int first, last;
    if (!row_range(ed, H, first, last)) continue;
    if (last - first >= kShort) {
      const int slot = atomicAdd(&n_long, 1);
      if (slot < kLong) {  // a full list leaves the edge to this thread
        long_edge[slot] = ed;
        long_base[slot] = atomicAdd(&long_rows, last - first + 1);
        continue;
      }
    }
    for (int y = first; y <= last; ++y) add_crossing(ed, y, count, bucket);
  }
  __syncthreads();
  // The long edges' (edge, row) pairs, numbered from long_base: pair p goes
  // to thread p % blockDim.
  const int n = min(n_long, kLong);
  const int threads = static_cast<int>(blockDim.x);
  for (int l = 0; l < n; ++l) {
    const float4 ed = long_edge[l];
    int first, last;
    row_range(ed, H, first, last);
    const int skip = (static_cast<int>(threadIdx.x) - long_base[l] % threads + threads) % threads;
    for (int y = first + skip; y <= last; y += threads) add_crossing(ed, y, count, bucket);
  }
  __syncthreads();

  for (int y0 = 0; y0 < H; y0 += kThreads) {
    const int y = y0 + threadIdx.x;
    float v[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) v[j] = INFINITY;
    if (y < H) {
      const int c = count[y];
      if (c <= kCap) {
        for (int j = 0; j < c; ++j) insert(v, bucket[bucket_at(y, j)]);
      } else {
        walk_row([&](int e) { return edge_at(verts, e, E); }, E, static_cast<float>(y), v);
        if (overflow_rows != nullptr) atomicAdd(overflow_rows, 1);
      }
    }
    __syncthreads();  // the chunk's buckets are read: they become its tile
    float4* tile = reinterpret_cast<float4*>(bucket + bucket_at(y0, 0));
#pragma unroll
    for (int j = 0; j < kK / 4; ++j) {
      tile[tile_at(threadIdx.x, j)] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(out + (static_cast<size_t>(blockIdx.x) * H + y0) * kK);
    const int n4 = min(kThreads, H - y0) * (kK / 4);
    for (int q = threadIdx.x; q < n4; q += kThreads) o[q] = tile[tile_at(q >> 2, q & 3)];
  }
}

// Dynamic shared memory above 48 KB, and the largest shared-memory carveout
// of the SM's 256 KB, so that as many blocks are resident as the shared
// memory allows.
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  return static_cast<int>(err);
}

}  // namespace

// dense: (M, E, 2) f32 contiguous (8-byte aligned); out: (M, H, 16) f32
// contiguous (16-byte aligned);
// overflow_rows: one device int that counts the rows that took the row walk,
// or null. Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int cu_min_k_crossings(const float* dense, float* out, int M, int E,
                                  int H, int* overflow_rows, void* stream) {
  if (M == 0 || H == 0) return 0;
  const size_t chunks = (static_cast<size_t>(H) + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(E) * sizeof(float2) + static_cast<size_t>(H) * sizeof(int)
                      + chunks * kCap * kThreads * sizeof(float);
  const int err = set_smem(min_k_crossings_kernel, smem);
  if (err != 0) return err;
  min_k_crossings_kernel<<<M, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dense, out, E, H, overflow_rows);
  return static_cast<int>(cudaGetLastError());
}
