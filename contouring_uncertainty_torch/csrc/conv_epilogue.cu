// Norm chains: everything between a convolution and the next one's input,
// forward and backward, one kernel each. Two kernel pairs share the plane
// and cluster machinery below.
//
// The conv epilogue (`conv_epilogue_fwd/_bwd`): models/unet.py ConvLayer's
// chain, and DeepLabV3's conv -> norm [-> ReLU] (models/deeplabv3.py):
//
//   v    = x + conv_bias, then v / keep_prob where the channel is kept and 0
//          where it is dropped (channel dropout, only where a keep mask is
//          given)
//   mean = sum(v) / HW, var = max(sum(v^2) / HW - mean^2, 0) per (n, c)
//          plane, in f32 (the program's single-pass formula)
//   rstd = 1 / sqrt(var + 1e-5), xhat = (v - mean) * rstd
//   z    = xhat * weight[c] + bias[c], y = act(z)
//
// act is a template parameter: LeakyReLU(0.01) (the UNet's ConvLayer),
// ReLU, or none. x is the convolution's output without its bias. The
// backward is the closed form of the same chain: gz = gy * act'(z), the
// plane's sums S1 = sum(gz) and S2 = sum(gz * xhat), then
//   dv = rstd * weight * (gz - S1 / HW - xhat * S2 / HW)
// (the S2 term only where var was not clamped: the clamp passes no
// gradient), dx = dv / keep_prob where kept, 0 where dropped. It also
// writes each plane's S2 and S1 (the norm's weight and bias gradients
// before the sum over n) and, where there is a conv bias, the sum of its
// dx (the conv bias's gradient before the sum over n), the latter per
// member of the plane's cluster.
//
// The norm tail (`norm_tail_fwd/_bwd`): a DeepLabV3 bottleneck's last norm,
// its channel dropout after the norm, the residual add and the ReLU:
//
//   z = xhat * weight[c] + bias[c] (the statistics of a, as above)
//   y = relu(z / keep_prob (kept) or 0 (dropped) + r)
//
// a is the convolution's output, r the residual. Backward: gz = gy where
// y > 0, else 0, written out as r's gradient; gn = gz / keep_prob (kept)
// or 0 (dropped); then the norm's closed form of gn as above (da = dv), and
// each plane's S2 and S1 of gn. It reads the saved y, which the next
// convolution keeps alive anyway, so the mask costs no memory.
//
// They replace no TPU kernel: the JAX package leaves these chains to XLA,
// which fuses them on the TPU. On the card the port ran them as about ten
// PyTorch launches a norm forward and twenty backward, each a pass over
// the activations (PERF.md has the times).
//
// What bounds them on an H100: device memory. The arithmetic is a few
// operations per element, far below the card's ridge point. The epilogue's
// forward must read x once and write y once (8 bytes an element), its
// backward read x and gy once and write dx once (12 bytes); the tail's
// forward reads a and r and writes y (12), its backward reads a, y and gy
// and writes da and r's gradient (20). The design keeps every plane on
// chip between the statistics and their use:
//
// - A plane lives in registers. Each thread holds up to 16 floats of one
//   plane (four 16-byte vectors where HW is a multiple of 4), loaded
//   coalesced, all issued before any is used. The statistics are a group
//   sum (shuffles in a warp, then the warps' partials through shared
//   memory), and the same registers are normalised and stored.
// - Large planes over a cluster. A block of 512 threads holds 8192 floats;
//   a 128^2 plane is split over a cluster of 2 blocks, a 256^2 plane over 8
//   (the portable cluster size). Each block leaves its partial sums in its
//   shared memory, and every block of the cluster adds all of them, in rank
//   order, through distributed shared memory: each reads the same totals,
//   and nothing is read twice from device memory.
// - Small planes packed. A plane of 64^2 or fewer elements takes a group of
//   1 to 256 threads (a power of two), and a block holds 512 / group planes.
//   The split follows H*W alone (ops/conv_epilogue.py `epilogue_plan`).
//
// Every sum is f32, carried with its rounding error (`Acc`): a per-thread
// run of at most 16 terms, a tree of shuffles, then the warps' and the
// cluster's partials in order. The normalisation and the kink test use the
// same rounded operations (`normed`, `affine`) in both kernels of a pair,
// so the backward sees the forward's side of every kink.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxElems = 16;   // floats a thread holds
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr float kSlope = 0.01f;
constexpr float kEps = 1e-5f;

// The conv epilogue's activation (its template parameter).
enum Act { kLeaky = 0, kRelu = 1, kNone = 2 };

struct Args {
  const float* x;                 // (planes, hw): the convolution's output without bias
  const float* conv_bias;         // (channels,) or null
  const unsigned char* keep;      // (planes,) bool, or null: no dropout
  const float* weight;            // (channels,) the norm's scale
  const float* bias;              // (channels,) the norm's shift
  const float* gy;                // backward: (planes, hw) incoming gradient
  float* out;                     // forward y, backward dx: (planes, hw)
  float* stats;                   // (3, planes): mean, rstd, 1 where var was not clamped
  float* part;                    // backward: (2 [+ cluster], planes): S2, S1[, sum(dx) per rank]
  long long planes;
  int channels;
  int hw;
  int n_vec;                      // vectors of VEC floats in a plane
  int group;                      // threads of a plane in each block
  float keep_prob;
  const float* res;               // tail: forward the residual r, backward the saved y
  float* out2;                    // tail backward: r's gradient
};

template <int VEC> struct Vec;
template <> struct Vec<4> {
  __device__ __forceinline__ static void load(const float* p, int i, float* f) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, int i, const float* f) {
    reinterpret_cast<float4*>(p)[i] = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<1> {
  __device__ __forceinline__ static void load(const float* p, int i, float* f) { f[0] = __ldg(p + i); }
  __device__ __forceinline__ static void store(float* p, int i, const float* f) { p[i] = f[0]; }
};

// The value after the conv bias and the channel dropout: x + b, then
// divided by keep_prob (kept) or 0 (dropped), rounded as PyTorch rounds
// the separate add and division.
__device__ __forceinline__ float dropped(float x, float cb, bool has_keep, bool kept,
                                         float keep_prob) {
  const float v = __fadd_rn(x, cb);
  if (!has_keep) return v;
  return kept ? __fdiv_rn(v, keep_prob) : 0.0f;
}

__device__ __forceinline__ float normed(float v, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(v, mean), rstd);
}

__device__ __forceinline__ float affine(float xhat, float w, float b) {
  return __fmaf_rn(xhat, w, b);
}

template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if (ACT == kLeaky) return z > 0.0f ? z : __fmul_rn(z, kSlope);
  if (ACT == kRelu) return z > 0.0f ? z : 0.0f;
  return z;
}

// gy times the activation's slope at z.
template <int ACT>
__device__ __forceinline__ float activate_grad(float gy, float z) {
  if (ACT == kLeaky) return z > 0.0f ? gy : __fmul_rn(gy, kSlope);
  if (ACT == kRelu) return z > 0.0f ? gy : 0.0f;
  return gy;
}

// The tail's dropout after the norm: z / keep_prob (kept) or 0 (dropped).
__device__ __forceinline__ float post_dropped(float z, bool has_keep, bool kept, float keep_prob) {
  if (!has_keep) return z;
  return kept ? __fdiv_rn(z, keep_prob) : 0.0f;
}

// An f32 sum carried with its rounding error: each addition's error is
// exact (TwoSum) and so is a product's (its fma residual), and both go to
// the compensation `c`. A plane's sums come out within about one rounding
// of the exact sum of their f32 terms, in whatever order the threads add
// them; nothing is computed in f64.
struct Acc {
  float s = 0.0f;
  float c = 0.0f;
  // s + x -> (t, its exact error).
  __device__ __forceinline__ float two_sum(float x) {
    const float t = __fadd_rn(s, x);
    const float z = __fsub_rn(t, s);
    const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(x, z));
    s = t;
    return e;
  }
  __device__ __forceinline__ void add(float x) { c = __fadd_rn(c, two_sum(x)); }
  __device__ __forceinline__ void add_product(float a, float b) {
    const float p = __fmul_rn(a, b);
    c = __fadd_rn(c, __fadd_rn(two_sum(p), __fmaf_rn(a, b, -p)));
  }
  // Another sum (s2, c2); symmetric in the two, bit for bit, so both lanes
  // of a shuffle get the same result.
  __device__ __forceinline__ void merge(float s2, float c2) {
    const float cc = __fadd_rn(c, c2);
    c = __fadd_rn(cc, two_sum(s2));
  }
  __device__ __forceinline__ float value() const { return __fadd_rn(s, c); }
};

// The sums of this thread's group (`group` threads, a power of two, groups
// aligned to it) in every thread of the group: a shuffle tree in the warp,
// then the group's warps in order. Every thread of the block calls it.
template <int N>
__device__ __forceinline__ void group_sum(Acc (&v)[N], int group, float (*warp_part)[2 * N]) {
  const int width = group < 32 ? group : 32;
  for (int o = width >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float s2 = __shfl_xor_sync(0xffffffffu, v[i].s, o);
      const float c2 = __shfl_xor_sync(0xffffffffu, v[i].c, o);
      v[i].merge(s2, c2);
    }
  }
  if (group <= 32) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      warp_part[warp][2 * i] = v[i].s;
      warp_part[warp][2 * i + 1] = v[i].c;
    }
  }
  __syncthreads();
  const int warps = group >> 5;
  const int first = warp & ~(warps - 1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    Acc t;
    t.s = warp_part[first][2 * i];
    t.c = warp_part[first][2 * i + 1];
    for (int w = 1; w < warps; ++w) t.merge(warp_part[first + w][2 * i], warp_part[first + w][2 * i + 1]);
    v[i] = t;
  }
}

// The block's sums (one group, the whole block) -> the cluster's, merged in
// rank order by every block, so each holds the same totals.
template <int N>
__device__ __forceinline__ void cluster_sum(Acc (&v)[N], float* part, float* total) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      part[2 * i] = v[i].s;
      part[2 * i + 1] = v[i].c;
    }
  }
  cluster.sync();  // every block's partial is in its shared memory
  if (threadIdx.x < N) {
    const int i = threadIdx.x;
    const float* p0 = cluster.map_shared_rank(part, 0);
    Acc t;
    t.s = p0[2 * i];
    t.c = p0[2 * i + 1];
    for (unsigned r = 1; r < cluster.num_blocks(); ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      t.merge(p[2 * i], p[2 * i + 1]);
    }
    total[2 * i] = t.s;
    total[2 * i + 1] = t.c;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i].s = total[2 * i];
    v[i].c = total[2 * i + 1];
  }
}

// Where this thread's plane and vectors lie.
struct Place {
  long long plane;
  bool live;      // the plane exists (the last block may hold fewer)
  int c;          // its channel
  int t;          // this thread's rank in the plane's group
  int rank;       // this block's rank in the plane's cluster
  int blocks;     // the cluster's blocks
};

__device__ __forceinline__ Place place(const Args& a) {
  cg::cluster_group cluster = cg::this_cluster();
  Place p;
  p.blocks = static_cast<int>(cluster.num_blocks());
  p.rank = static_cast<int>(cluster.block_rank());
  p.t = threadIdx.x & (a.group - 1);
  p.plane = static_cast<long long>(blockIdx.x / p.blocks) * (kThreads / a.group)
            + threadIdx.x / a.group;
  p.live = p.plane < a.planes;
  p.c = p.live ? static_cast<int>(p.plane % a.channels) : 0;
  return p;
}

template <int ACT, int VEC, int V>
__global__ void __launch_bounds__(kThreads, 2) conv_epilogue_fwd_kernel(const Args a) {
  __shared__ float warp_part[kWarps][4];
  __shared__ float part[4];
  __shared__ float total[4];
  const Place p = place(a);
  const float cb = a.conv_bias != nullptr ? a.conv_bias[p.c] : 0.0f;
  const bool has_keep = a.keep != nullptr;
  const bool kept = !has_keep || (p.live && a.keep[p.plane] != 0);
  const float* src = a.x + p.plane * a.hw;
  const int first = p.rank * a.group * V + p.t;

  float f[V][VEC];
  Acc s[2];  // sum v, sum v^2
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) Vec<VEC>::load(src, vi, f[k]);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (p.live && first + k * a.group < a.n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        f[k][j] = dropped(f[k][j], cb, has_keep, kept, a.keep_prob);
        s[0].add(f[k][j]);
        s[1].add_product(f[k][j], f[k][j]);
      }
    }
  }
  group_sum(s, a.group, warp_part);
  if (p.blocks > 1) cluster_sum(s, part, total);

  const float n = static_cast<float>(a.hw);
  const float mean = __fdiv_rn(s[0].value(), n);
  const float raw = __fsub_rn(__fdiv_rn(s[1].value(), n), __fmul_rn(mean, mean));
  const float var = raw < 0.0f ? 0.0f : raw;
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, kEps)));
  const float w = a.weight[p.c];
  const float b = a.bias[p.c];
  float* dst = a.out + p.plane * a.hw;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        f[k][j] = activate<ACT>(affine(normed(f[k][j], mean, rstd), w, b));
      }
      Vec<VEC>::store(dst, vi, f[k]);
    }
  }
  if (p.live && p.t == 0 && p.rank == 0) {
    a.stats[p.plane] = mean;
    a.stats[a.planes + p.plane] = rstd;
    a.stats[2 * a.planes + p.plane] = raw < 0.0f ? 0.0f : 1.0f;
  }
  if (p.blocks > 1) cg::this_cluster().sync();  // no block leaves while another reads its shared memory
}

template <int ACT, int VEC, int V>
__global__ void __launch_bounds__(kThreads, 2) conv_epilogue_bwd_kernel(const Args a) {
  __shared__ float warp_part[kWarps][4];
  __shared__ float warp_part_dx[kWarps][2];
  __shared__ float part[4];
  __shared__ float total[4];
  const Place p = place(a);
  const float cb = a.conv_bias != nullptr ? a.conv_bias[p.c] : 0.0f;
  const bool has_keep = a.keep != nullptr;
  const bool kept = !has_keep || (p.live && a.keep[p.plane] != 0);
  const float mean = p.live ? a.stats[p.plane] : 0.0f;
  const float rstd = p.live ? a.stats[a.planes + p.plane] : 0.0f;
  const bool full = p.live && a.stats[2 * a.planes + p.plane] != 0.0f;
  const float w = a.weight[p.c];
  const float b = a.bias[p.c];
  const long long off = p.plane * a.hw;
  const int first = p.rank * a.group * V + p.t;

  float h[V][VEC];  // xhat
  float g[V][VEC];  // gy, then gz, then dx
  Acc s[2];         // sum gz, sum gz * xhat
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
      Vec<VEC>::load(a.x + off, vi, h[k]);
      Vec<VEC>::load(a.gy + off, vi, g[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (p.live && first + k * a.group < a.n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        h[k][j] = normed(dropped(h[k][j], cb, has_keep, kept, a.keep_prob), mean, rstd);
        g[k][j] = activate_grad<ACT>(g[k][j], affine(h[k][j], w, b));
        s[0].add(g[k][j]);
        s[1].add_product(g[k][j], h[k][j]);
      }
    }
  }
  group_sum(s, a.group, warp_part);
  if (p.blocks > 1) cluster_sum(s, part, total);

  const float n = static_cast<float>(a.hw);
  const float mean_gz = __fdiv_rn(s[0].value(), n);
  const float mean_gzh = full ? __fdiv_rn(s[1].value(), n) : 0.0f;
  const float rw = __fmul_rn(rstd, w);
  Acc sdx[1];
  float* dst = a.out + off;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float d = rw * (g[k][j] - mean_gz - h[k][j] * mean_gzh);
        if (has_keep) d = kept ? __fdiv_rn(d, a.keep_prob) : 0.0f;
        g[k][j] = d;
        if (a.conv_bias != nullptr) sdx[0].add(d);
      }
      Vec<VEC>::store(dst, vi, g[k]);
    }
  }
  if (a.conv_bias != nullptr) group_sum(sdx, a.group, warp_part_dx);
  if (p.live && p.t == 0) {
    if (p.rank == 0) {
      a.part[p.plane] = s[1].value();
      a.part[a.planes + p.plane] = s[0].value();
    }
    if (a.conv_bias != nullptr) a.part[(2 + p.rank) * a.planes + p.plane] = sdx[0].value();
  }
  if (p.blocks > 1) cg::this_cluster().sync();  // no block leaves while another reads its shared memory
}

template <int VEC, int V>
__global__ void __launch_bounds__(kThreads, 2) norm_tail_fwd_kernel(const Args a) {
  __shared__ float warp_part[kWarps][4];
  __shared__ float part[4];
  __shared__ float total[4];
  const Place p = place(a);
  const bool has_keep = a.keep != nullptr;
  const bool kept = !has_keep || (p.live && a.keep[p.plane] != 0);
  const long long off = p.plane * a.hw;
  const int first = p.rank * a.group * V + p.t;

  float f[V][VEC];  // a, then y
  float r[V][VEC];  // the residual
  Acc s[2];         // sum a, sum a^2
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
      Vec<VEC>::load(a.x + off, vi, f[k]);
      Vec<VEC>::load(a.res + off, vi, r[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (p.live && first + k * a.group < a.n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[0].add(f[k][j]);
        s[1].add_product(f[k][j], f[k][j]);
      }
    }
  }
  group_sum(s, a.group, warp_part);
  if (p.blocks > 1) cluster_sum(s, part, total);

  const float n = static_cast<float>(a.hw);
  const float mean = __fdiv_rn(s[0].value(), n);
  const float raw = __fsub_rn(__fdiv_rn(s[1].value(), n), __fmul_rn(mean, mean));
  const float var = raw < 0.0f ? 0.0f : raw;
  const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, kEps)));
  const float w = a.weight[p.c];
  const float b = a.bias[p.c];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float z = affine(normed(f[k][j], mean, rstd), w, b);
        f[k][j] = activate<kRelu>(__fadd_rn(post_dropped(z, has_keep, kept, a.keep_prob), r[k][j]));
      }
      Vec<VEC>::store(a.out + off, vi, f[k]);
    }
  }
  if (p.live && p.t == 0 && p.rank == 0) {
    a.stats[p.plane] = mean;
    a.stats[a.planes + p.plane] = rstd;
    a.stats[2 * a.planes + p.plane] = raw < 0.0f ? 0.0f : 1.0f;
  }
  if (p.blocks > 1) cg::this_cluster().sync();  // no block leaves while another reads its shared memory
}

template <int VEC, int V>
__global__ void __launch_bounds__(kThreads, 2) norm_tail_bwd_kernel(const Args a) {
  __shared__ float warp_part[kWarps][4];
  __shared__ float part[4];
  __shared__ float total[4];
  const Place p = place(a);
  const bool has_keep = a.keep != nullptr;
  const bool kept = !has_keep || (p.live && a.keep[p.plane] != 0);
  const float mean = p.live ? a.stats[p.plane] : 0.0f;
  const float rstd = p.live ? a.stats[a.planes + p.plane] : 0.0f;
  const bool full = p.live && a.stats[2 * a.planes + p.plane] != 0.0f;
  const float w = a.weight[p.c];
  const long long off = p.plane * a.hw;
  const int first = p.rank * a.group * V + p.t;

  float h[V][VEC];  // a, then xhat (a dropped plane reads no a)
  float g[V][VEC];  // gy, then gz (stored as r's gradient), then gn, then da
  Acc s[2];         // sum gn, sum gn * xhat
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
      if (kept) Vec<VEC>::load(a.x + off, vi, h[k]);
      Vec<VEC>::load(a.gy + off, vi, g[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
      float y[VEC];
      Vec<VEC>::load(a.res + off, vi, y);
#pragma unroll
      for (int j = 0; j < VEC; ++j) g[k][j] = activate_grad<kRelu>(g[k][j], y[j]);
      Vec<VEC>::store(a.out2 + off, vi, g[k]);
      if (kept) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          g[k][j] = post_dropped(g[k][j], has_keep, kept, a.keep_prob);
          h[k][j] = normed(h[k][j], mean, rstd);
          s[0].add(g[k][j]);
          s[1].add_product(g[k][j], h[k][j]);
        }
      }
    }
  }
  group_sum(s, a.group, warp_part);
  if (p.blocks > 1) cluster_sum(s, part, total);

  const float n = static_cast<float>(a.hw);
  const float mean_gn = __fdiv_rn(s[0].value(), n);
  const float mean_gnh = full ? __fdiv_rn(s[1].value(), n) : 0.0f;
  const float rw = __fmul_rn(rstd, w);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int vi = first + k * a.group;
    if (p.live && vi < a.n_vec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        g[k][j] = kept ? rw * (g[k][j] - mean_gn - h[k][j] * mean_gnh) : 0.0f;
      }
      Vec<VEC>::store(a.out + off, vi, g[k]);
    }
  }
  if (p.live && p.t == 0 && p.rank == 0) {
    a.part[p.plane] = s[1].value();
    a.part[a.planes + p.plane] = s[0].value();
  }
  if (p.blocks > 1) cg::this_cluster().sync();  // no block leaves while another reads its shared memory
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int cluster, cudaStream_t stream) {
  const long long per_block = kThreads / a.group;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((a.planes + per_block - 1) / per_block * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The kernel pairs, each a `run<VEC, V>` that launches its forward or backward.
template <int ACT>
struct Epilogue {
  template <int VEC, int V>
  static int run(int backward, const Args& a, int cluster, cudaStream_t s) {
    return backward ? launch(conv_epilogue_bwd_kernel<ACT, VEC, V>, a, cluster, s)
                    : launch(conv_epilogue_fwd_kernel<ACT, VEC, V>, a, cluster, s);
  }
};

struct Tail {
  template <int VEC, int V>
  static int run(int backward, const Args& a, int cluster, cudaStream_t s) {
    return backward ? launch(norm_tail_bwd_kernel<VEC, V>, a, cluster, s)
                    : launch(norm_tail_fwd_kernel<VEC, V>, a, cluster, s);
  }
};

template <typename Pair>
int dispatch(int backward, const Args& a, int vec, int vecs, int cluster, cudaStream_t s) {
  if (vec == 4) {
    switch (vecs) {
      case 1: return Pair::template run<4, 1>(backward, a, cluster, s);
      case 2: return Pair::template run<4, 2>(backward, a, cluster, s);
      default: return Pair::template run<4, 4>(backward, a, cluster, s);
    }
  }
  switch (vecs) {
    case 1: return Pair::template run<1, 1>(backward, a, cluster, s);
    case 2: return Pair::template run<1, 2>(backward, a, cluster, s);
    case 4: return Pair::template run<1, 4>(backward, a, cluster, s);
    case 8: return Pair::template run<1, 8>(backward, a, cluster, s);
    default: return Pair::template run<1, 16>(backward, a, cluster, s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

// A launch layout the kernels take (see `cu_conv_epilogue`).
bool plan_ok(long long planes, int channels, int hw, int vec, int vecs, int group, int cluster,
             const unsigned char* keep, float keep_prob) {
  const long long per_block = group > 0 ? kThreads / group : 0;
  const int n_vec = vec > 0 ? hw / vec : 0;
  return planes >= 0 && channels >= 1 && planes % channels == 0 && hw >= 1
         && (vec == 1 || vec == 4) && hw % vec == 0
         && vecs >= 1 && (vecs & (vecs - 1)) == 0 && vec * vecs <= kMaxElems
         && group >= 1 && group <= kThreads && (group & (group - 1)) == 0
         && cluster >= 1 && cluster <= kMaxCluster && (cluster == 1 || group == kThreads)
         && static_cast<long long>(group) * vecs * cluster >= n_vec
         && (planes + per_block - 1) / per_block * cluster <= 0x7fffffffLL
         && (keep == nullptr || keep_prob > 0.0f);
}

}  // namespace

// One launch of the forward (backward = 0) or the backward (1) conv
// epilogue kernel with activation `act` (0 LeakyReLU(0.01), 1 ReLU, 2
// none), as ops/conv_epilogue.py `epilogue_plan` lays it out: `vec` floats
// a vector (4 where hw % 4 == 0 and the planes are 16-byte aligned, else
// 1), `vecs` vectors a thread (vec * vecs <= 16, a power of two), `group`
// threads of a plane in a block (a power of two up to 512), `cluster`
// blocks a plane (1-8; above 1 the group is the whole block). All tensors
// are contiguous f32 (keep: bool) on the current device. The forward
// writes out (y) and stats; the backward reads stats and gy and writes out
// (dx) and part (2 + cluster rows with a conv bias, else 2). Launches on
// `stream`; returns a CUDA error code (0 on success).
extern "C" int cu_conv_epilogue(int backward, int act, const float* x, const float* conv_bias,
                                const unsigned char* keep, float keep_prob,
                                const float* weight, const float* bias, const float* gy,
                                float* out, float* stats, float* part, long long planes,
                                int channels, int hw, int vec, int vecs, int group, int cluster,
                                void* stream) {
  if (planes == 0) return 0;
  if ((backward != 0 && backward != 1) || act < kLeaky || act > kNone || x == nullptr
      || weight == nullptr || bias == nullptr || out == nullptr || stats == nullptr
      || (backward && (gy == nullptr || part == nullptr))
      || !plan_ok(planes, channels, hw, vec, vecs, group, cluster, keep, keep_prob)
      || (vec == 4 && (!aligned16(x) || !aligned16(out) || (backward && !aligned16(gy))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {x, conv_bias, keep, weight, bias, gy, out, stats, part, planes, channels, hw,
                  hw / vec, group, keep_prob, nullptr, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kLeaky: return dispatch<Epilogue<kLeaky>>(backward, a, vec, vecs, cluster, s);
    case kRelu: return dispatch<Epilogue<kRelu>>(backward, a, vec, vecs, cluster, s);
    default: return dispatch<Epilogue<kNone>>(backward, a, vec, vecs, cluster, s);
  }
}

// One launch of the norm tail's forward (backward = 0: reads x = a and res
// = r, writes out = y and stats) or backward (1: reads x = a, res = the
// forward's y, gy and stats, writes out = da, out2 = r's gradient and part,
// 2 rows), laid out as `cu_conv_epilogue`. Returns a CUDA error code.
extern "C" int cu_norm_tail(int backward, const float* x, const float* res,
                            const unsigned char* keep, float keep_prob, const float* weight,
                            const float* bias, const float* gy, float* out, float* out2,
                            float* stats, float* part, long long planes, int channels, int hw,
                            int vec, int vecs, int group, int cluster, void* stream) {
  if (planes == 0) return 0;
  if ((backward != 0 && backward != 1) || x == nullptr || res == nullptr || weight == nullptr
      || bias == nullptr || out == nullptr || stats == nullptr
      || (backward && (gy == nullptr || out2 == nullptr || part == nullptr))
      || !plan_ok(planes, channels, hw, vec, vecs, group, cluster, keep, keep_prob)
      || (vec == 4 && (!aligned16(x) || !aligned16(res) || !aligned16(out)
                       || (backward && (!aligned16(gy) || !aligned16(out2)))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {x, nullptr, keep, weight, bias, gy, out, stats, part, planes, channels, hw,
                  hw / vec, group, keep_prob, res, out2};
  return dispatch<Tail>(backward, a, vec, vecs, cluster, static_cast<cudaStream_t>(stream));
}
