// The weight gradient of a 1x1 convolution, split over its reduction.
//
// For a 1x1 convolution with zero padding, stride (sh, sw), input X
// (N, Ci, H, W) and output gradient dY (N, Co, Ho, Wo):
//
//   dW[co, ci] = sum over n, i, j of dY[n, co, i, j] * X[n, ci, i*sh, j*sw]
//
// a matrix product whose reduction runs over the N*Ho*Wo output pixels.
// `conv1x1_wgrad_kernel` computes it in f32 with f32 fused multiply-adds,
// reading both operands where they lie (any element strides, so NCHW as
// the step holds it, a strided view of X for a stride-2 projection, a
// slice of a concatenation's gradient), with no layout copy.
//
// It replaces no TPU kernel: the JAX package leaves this gradient to XLA.
// It was added because cuDNN's weight gradient runs these shapes far below
// the card's rate (PERF.md): the output is small (256 x 64 at DeepLabV3's
// first stage, 21 x 32 at the UNet's head) and the reduction huge (131,072
// and 2,097,152 pixels at batch 32). A product that tiles only the output
// finds a few tiles for 132 SMs and walks the whole reduction on each.
//
// What bounds it on an H100: the larger of 2*Co*Ci*NP operations at the
// f32 rate (67 TFLOP/s) and 4*(Co+Ci)*NP bytes at 3.35 TB/s. DeepLabV3's
// first stage sits at the ridge, its last stage is bound by operations, the
// UNet's head by bytes. The design:
//
// - Split-K. The grid's z axis cuts the reduction into equal ranges of
//   pixels (a multiple of the slab, 16), so that output tiles x splits fill
//   the card (one or two blocks an SM); each split writes its partial tile
//   to a workspace [splits, Co, Ci], and `conv1x1_wgrad_reduce_kernel` sums
//   the splits in index order. The result is the same bits from run to
//   run. With one split the first kernel writes dW itself.
//   ops/conv1x1_wgrad.py `wgrad_plan` derives tile and splits from (Co, Ci,
//   NP) alone.
// - Tiles. A block of 256 threads owns a BM x BN output tile (BM, BN in
//   32-256, BM * BN at most 128 x 128); each thread holds a (BM/16) x
//   (BN/16) register micro-tile (8 x 8 at 128 x 128, 16 x 4 at 256 x 64)
//   and reads it as float4s (float2s at 32) along M and N, the next
//   pixel's fragments while the current one's multiply-adds run. A side of
//   64 or less lets the other grow to 256, so X (or dY) is read once.
// - Loads. Slabs of 16 pixels arrive by 4-byte `cp.async` in a ring of
//   kStages shared-memory stages, transposed on their way in (pixel-major
//   rows of BM + 4 floats: conflict-free stores, 16-byte aligned reads).
//   Each thread loads one pixel of a slab for several channels, so it
//   computes one address a slab and steps it; rows past Co or Ci and
//   pixels past the split's end are zero-filled, which masks the ragged
//   edges (Co = 21, P = 1).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;     // pixels a slab (a multiple of 8)
constexpr int kRowStep = kThreads / kBK;  // tile rows one load step covers
constexpr int kPad = 4;     // floats after each pixel row of a tile in shared memory
constexpr int kStages = 4;  // slabs in the shared-memory ring

// One operand over the output's pixel grid: element (n, c, i, j) at
// ptr[n*sn + c*sc + i*sh + j*sw].
struct Operand {
  const float* ptr;
  long long sn, sc, sh, sw;
  int rows;
};

struct Args {
  Operand a;          // dY: Co rows
  Operand b;          // X through the stride: Ci rows
  float* out;         // (splits, Co, Ci), or dW (Co, Ci) with one split
  int ho, wo;         // the output's pixel grid
  long long np;       // N * ho * wo
  long long chunk;    // pixels a split, a multiple of kBK
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The rows of a thread's micro-tile: T of a BT-row tile side, thread t of
// 16 along it. T = 2: 2t, 2t+1; T >= 4: T/4 groups of four, spread evenly.
template <int T, int BT>
__device__ __forceinline__ int micro_row(int t, int e) {
  if constexpr (T == 2) {
    return t * 2 + e;
  } else {
    return (e / 4) * (BT / (T / 4)) + t * 4 + (e % 4);
  }
}

template <int T, int BT>
__device__ __forceinline__ void load_frag(const float* s, int t, float (&f)[T]) {
  if constexpr (T == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s + t * 2);
    f[0] = v.x;
    f[1] = v.y;
  } else {
#pragma unroll
    for (int g = 0; g < T / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(s + g * (BT / (T / 4)) + t * 4);
      f[4 * g] = v.x;
      f[4 * g + 1] = v.y;
      f[4 * g + 2] = v.z;
      f[4 * g + 3] = v.w;
    }
  }
}

// Issue one slab's copies of one operand: this thread's pixel (at element
// offset `off`, valid where `in`) for rows r0, r0 + kRowStep, ... of the tile.
template <int BT>
__device__ __forceinline__ void load_operand(float* stage, const Operand& op, int row0,
                                             long long off, bool in, int kk, int r0) {
  const float* p = op.ptr + off + static_cast<long long>(row0 + r0) * op.sc;
  const long long step = kRowStep * op.sc;
#pragma unroll
  for (int q = 0; q < BT / kRowStep; ++q) {
    const bool valid = in && row0 + r0 + kRowStep * q < op.rows;
    cp_async4(stage + kk * (BT + kPad) + r0 + kRowStep * q, valid ? p : op.ptr, valid);
    p += step;
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2) conv1x1_wgrad_kernel(Args a) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                                // [kStages][kBK][BM + kPad]
  float* s_b = smem + kStages * kBK * (BM + kPad);  // [kStages][kBK][BN + kPad]

  const int t = threadIdx.x;
  const int row_a = blockIdx.y * BM;
  const int row_b = blockIdx.x * BN;
  const long long k_begin = static_cast<long long>(blockIdx.z) * a.chunk;
  const long long k_end = min(k_begin + a.chunk, a.np);
  const int slabs = static_cast<int>((k_end - k_begin + kBK - 1) / kBK);

  // The loader's pixel of a slab and its first row; conflict-free stores:
  // a warp writes 8 pixels x 4 rows, banks 4 * pixel + row.
  const int kk = (t & 7) + 8 * ((t >> 5) & (kBK / 8 - 1));
  const int r0 = 4 * (t / (4 * kBK)) + ((t >> 3) & 3);
  long long k = k_begin + kk;
  const long long per_image = static_cast<long long>(a.ho) * a.wo;
  long long n = k / per_image;
  const long long rem = k - n * per_image;
  int i = static_cast<int>(rem / a.wo);
  int j = static_cast<int>(rem - static_cast<long long>(i) * a.wo);

  auto load = [&](int stage) {
    const bool in = k < k_end;
    load_operand<BM>(s_a + stage * kBK * (BM + kPad), a.a, row_a,
                     n * a.a.sn + i * a.a.sh + j * a.a.sw, in, kk, r0);
    load_operand<BN>(s_b + stage * kBK * (BN + kPad), a.b, row_b,
                     n * a.b.sn + i * a.b.sh + j * a.b.sw, in, kk, r0);
    k += kBK;
    j += kBK;
    while (j >= a.wo) {
      j -= a.wo;
      if (++i == a.ho) {
        i = 0;
        ++n;
      }
    }
  };

  // The compute layout: a warp is 4 (M) x 8 (N) threads, so a k step's
  // float4 reads touch 4 and 8 distinct addresses.
  const int w = t >> 5, l = t & 31;
  const int tm = (w >> 1) * 4 + (l >> 3);
  const int tn = (w & 1) * 8 + (l & 7);

  float acc[TM][TN];
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TN; ++y) acc[x][y] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < slabs; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < slabs) load(next % kStages);
    cp_async_commit();
    const float* sa = s_a + (it % kStages) * kBK * (BM + kPad);
    const float* sb = s_b + (it % kStages) * kBK * (BN + kPad);
    // Fragments in two register sets: pixel q + 1's are read from shared
    // memory while pixel q's multiply-adds run.
    float fa[2][TM], fb[2][TN];
    load_frag<TM, BM>(sa, tm, fa[0]);
    load_frag<TN, BN>(sb, tn, fb[0]);
#pragma unroll
    for (int q = 0; q < kBK; ++q) {
      if (q + 1 < kBK) {
        load_frag<TM, BM>(sa + (q + 1) * (BM + kPad), tm, fa[(q + 1) & 1]);
        load_frag<TN, BN>(sb + (q + 1) * (BN + kPad), tn, fb[(q + 1) & 1]);
      }
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(fa[q & 1][x], fb[q & 1][y], acc[x][y]);
    }
  }
  cp_async_wait<0>();

  const int co = a.a.rows, ci = a.b.rows;
  float* out = a.out + static_cast<long long>(blockIdx.z) * co * ci;
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int r = row_a + micro_row<TM, BM>(tm, x);
    if (r >= co) continue;
    float* row = out + static_cast<long long>(r) * ci;
#pragma unroll
    for (int g = 0; g < TN; g += (TN == 2 ? 2 : 4)) {
      const int c = row_b + micro_row<TN, BN>(tn, g);
      if constexpr (TN == 2) {
        if (c + 1 < ci && ci % 2 == 0) {
          *reinterpret_cast<float2*>(row + c) = make_float2(acc[x][g], acc[x][g + 1]);
          continue;
        }
        for (int e = 0; e < 2; ++e)
          if (c + e < ci) row[c + e] = acc[x][g + e];
      } else {
        if (c + 3 < ci && ci % 4 == 0) {
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[x][g], acc[x][g + 1], acc[x][g + 2], acc[x][g + 3]);
          continue;
        }
        for (int e = 0; e < 4; ++e)
          if (c + e < ci) row[c + e] = acc[x][g + e];
      }
    }
  }
}

// dW[e] = the sum over splits z of part[z][e], in index order; the loads
// of kBatch splits are issued before their adds.
constexpr int kReduceThreads = 64;
constexpr int kBatch = 16;

__global__ void conv1x1_wgrad_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ out, int splits,
                                            long long count) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const float* p = part + e;
  float s = p[0];
  int z = 1;
  for (; z + kBatch <= splits; z += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = p[(z + u) * count];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) s += v[u];
  }
  for (; z < splits; ++z) s += p[z * count];
  out[e] = s;
}

template <int BM, int BN>
int launch_tiles(const Args& a, int splits, cudaStream_t stream) {
  constexpr int smem = kStages * kBK * (BM + BN + 2 * kPad) * sizeof(float);
  // The attribute is the current device's: set on every launch.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv1x1_wgrad_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.b.rows + BN - 1) / BN, (a.a.rows + BM - 1) / BM, splits);
  conv1x1_wgrad_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The tiles built: BM, BN in 32-256 with BM * BN at most 128 x 128.
template <int BM>
int launch_bn(const Args& a, int bn, int splits, cudaStream_t s) {
  switch (bn) {
    case 32: return launch_tiles<BM, 32>(a, splits, s);
    case 64: return launch_tiles<BM, 64>(a, splits, s);
    case 128:
      if constexpr (BM <= 128) return launch_tiles<BM, 128>(a, splits, s);
      break;
    case 256:
      if constexpr (BM <= 64) return launch_tiles<BM, 256>(a, splits, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool side_ok(int b) { return b == 32 || b == 64 || b == 128 || b == 256; }

}  // namespace

// dW (co, ci) of a 1x1 convolution from dY (element strides dy_s*, co
// rows) and X through the stride (x_s*, ci rows), both over the output's
// ho x wo pixel grid, n images, as ops/conv1x1_wgrad.py `wgrad_plan` lays it
// out: bm x bn output tiles (32-256 each, bm * bn <= 128 * 128), `splits` ranges of
// `chunk` pixels (a multiple of 16; splits = ceil(n*ho*wo / chunk)). With
// splits > 1 the partial tiles go to `part` (splits, co, ci) and a second
// launch sums them into `out`; with one split the first launch writes
// `out`. All f32 on the current device; launches on `stream`; returns a
// CUDA error code (0 on success).
extern "C" int cu_conv1x1_wgrad(const float* dy, long long dy_sn, long long dy_sc,
                                long long dy_sh, long long dy_sw, const float* x,
                                long long x_sn, long long x_sc, long long x_sh, long long x_sw,
                                float* part, float* out, int co, int ci, int n, int ho, int wo,
                                int bm, int bn, int splits, long long chunk, void* stream) {
  const long long np = static_cast<long long>(n) * ho * wo;
  if (dy == nullptr || x == nullptr || out == nullptr || co < 1 || ci < 1 || n < 1 || ho < 1
      || wo < 1 || !side_ok(bm) || !side_ok(bn) || splits < 1 || splits > 65535
      || chunk < kBK || chunk % kBK != 0 || (splits - 1) * chunk >= np || splits * chunk < np
      || (splits > 1 && part == nullptr) || (co + bm - 1) / bm > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {{dy, dy_sn, dy_sc, dy_sh, dy_sw, co}, {x, x_sn, x_sc, x_sh, x_sw, ci},
                  splits > 1 ? part : out, ho, wo, np, chunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (bm) {
    case 32: err = launch_bn<32>(a, bn, splits, s); break;
    case 64: err = launch_bn<64>(a, bn, splits, s); break;
    case 128: err = launch_bn<128>(a, bn, splits, s); break;
    default: err = launch_bn<256>(a, bn, splits, s); break;
  }
  if (err != 0 || splits == 1) return err;
  const long long count = static_cast<long long>(co) * ci;
  conv1x1_wgrad_reduce_kernel<<<static_cast<unsigned>((count + kReduceThreads - 1)
                                                      / kReduceThreads),
                                kReduceThreads, 0, s>>>(part, out, splits, count);
  return static_cast<int>(cudaGetLastError());
}
