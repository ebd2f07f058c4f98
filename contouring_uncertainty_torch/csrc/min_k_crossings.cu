// Exact min-k scanline crossing selection for the even-odd polygon fill.
//
// Replaces contouring_uncertainty_tpu/ops/pallas_select.py `_min_k_crossings`
// (Pallas kernel `_select_kernel`). For each mask m and image row y it
// returns the K = 16 smallest abscissae x0 + ((y - y0) / (y1 - y0)) * (x1 - x0)
// over the closed polygon's edges that straddle y ((y0 > y) != (y1 > y)),
// sorted ascending and padded with +inf. Duplicate values keep their
// multiplicity, so the even-odd parity of the fill is exact.
//
// What bounds it on an H100: arithmetic issue, not memory. A serving view
// selects for 500 masks x 256 rows x 1024 edges (1.3e8 straddle tests) from
// 8 KB of vertices per mask and writes 16 KB per mask. The design keeps the
// (H, E) candidate tensor and any sort out of device memory:
//
// - One block per mask. The block stages the mask's E edges in shared memory
//   once, as float4 (y0, y1, x0, x1): 16 KB at E = 1024.
// - One thread per image row walks all E edges. Every thread reads the same
//   edge at the same time, so each shared-memory load is one broadcast. Only
//   an edge that straddles the row pays for the division; its abscissa goes
//   into a 16-entry sorted list held in registers (fully unrolled insertion
//   with strict <), so no candidate is written anywhere and nothing is sorted.
//
// Bitwise parity with the plain PyTorch version (ops/select_kernel.py): the
// library is built with --fmad=false and IEEE division (no --use_fast_math),
// so tt and x0 + tt * (x1 - x0) round exactly as PyTorch's separate
// elementwise ops do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kK = 16;          // K_CROSSINGS of ops/select_kernel.py
constexpr int kThreads = 256;   // rows per block pass

__global__ void min_k_crossings_kernel(const float* __restrict__ dense,
                                       float* __restrict__ out, int E, int H) {
  extern __shared__ float4 edges[];  // (y0, y1, x0, x1) per edge
  const float* poly = dense + static_cast<size_t>(blockIdx.x) * E * 2;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int n = (e + 1 == E) ? 0 : e + 1;  // closing edge wraps to vertex 0
    edges[e] = make_float4(poly[2 * e + 1], poly[2 * n + 1], poly[2 * e], poly[2 * n]);
  }
  __syncthreads();

  for (int y = threadIdx.x; y < H; y += blockDim.x) {
    const float yf = static_cast<float>(y);
    float v[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) v[j] = INFINITY;
    for (int e = 0; e < E; ++e) {
      const float4 ed = edges[e];
      if ((ed.x > yf) != (ed.y > yf)) {
        const float denom = ed.y - ed.x;
        const float safe = fabsf(denom) < 1e-12f ? 1.0f : denom;
        const float tt = (yf - ed.x) / safe;
        const float c = ed.z + tt * (ed.w - ed.z);
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
    }
    float4* o = reinterpret_cast<float4*>(out + (static_cast<size_t>(blockIdx.x) * H + y) * kK);
#pragma unroll
    for (int j = 0; j < kK / 4; ++j) {
      o[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  }
}

}  // namespace

// dense: (M, E, 2) f32 contiguous; out: (M, H, 16) f32 contiguous.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cu_min_k_crossings(const float* dense, float* out, int M, int E,
                                  int H, void* stream) {
  if (M == 0 || H == 0) return 0;
  const size_t smem = static_cast<size_t>(E) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        min_k_crossings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = H < kThreads ? ((H + 31) / 32) * 32 : kThreads;
  min_k_crossings_kernel<<<M, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      dense, out, E, H);
  return static_cast<int>(cudaGetLastError());
}
