// Training BatchNorm with its Conv's SiLU for Hopper (sm_90a): three kernels a
// forward, three a backward.
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm and SiLU to XLA,
// which fuses them on the TPU. The port's plain form of the same function
// (nn/module.py:BatchNorm, then SiLU) ran as ~8 PyTorch kernels forward and ~10
// backward, through float32 copies of the activation. This file computes
// what cerberusdet_tpu_torch/ops/bn_cuda.py's plain passes compute.
//
// Layouts: x is (N, C, H, W), float32 or bfloat16, in one of two layouts:
//   planar  each (n, c) plane of H * W values contiguous (NCHW and its channel
//           slices): strides (sn, sc, 1);
//   rows    each (n, h, w) row of C values contiguous (channels last, which
//           the train step's convolutions keep from its NHWC images, and its
//           channel slices): strides (sn, 1, sp).
// A channel's N * H * W values, taken image-major, are cut into P chunks of
// L values (ops/bn_cuda.py:chunking). A block takes one chunk of one channel
// (planar) or of a tile of up to 256 vectors of channels (rows). A thread
// reads 16 bytes at a time (8 bfloat16 or 4 float32 values: along a plane,
// or along a row's channels) where the shape, the strides and the pointer
// allow, one value otherwise, with several loads in flight. In the rows
// layout a tile's tv vectors of a row go to tv neighbouring threads and the
// block's 256 / tv row lanes take every (256 / tv)-th row of the chunk.
//
//   bn_silu_stats_kernel          per (chunk, channel): mean and the centred
//                                 sum of squares M2 in float32. Each thread
//                                 keeps moments for each value of its
//                                 vector: a group of up to 4 loads two-pass
//                                 in registers, then Chan's merge. The block
//                                 merges them in a fixed order (planar: the
//                                 vector's slots, a warp tree, the warps;
//                                 rows: a tree over the row lanes).
//   bn_silu_finalize_kernel       a block a channel merges its P partials in
//                                 a fixed order (strided over the threads,
//                                 then a tree): mean, biased var = M2 / n,
//                                 rstd = rsqrt(var + eps), inv = rstd * weight,
//                                 shift = bias - mean * inv into stat, and the
//                                 running statistics updated in place
//                                 (keep * running + momentum * batch, the
//                                 variance unbiased by bessel).
//   bn_silu_apply_kernel          z = x * inv + shift, y = silu(z) (act) or z,
//                                 rounded as nn/module.py rounds them: inv and
//                                 shift cast to the activation dtype, the
//                                 product rounded to it, then the sum; SiLU
//                                 z / (1 + exp(-z)) in float32, rounded once,
//                                 as PyTorch's silu. Given the same statistics,
//                                 y is PyTorch's y bit for bit. y takes x's
//                                 layout family, dense.
//   bn_silu_grad_reduce_kernel    per (chunk, channel): z recomputed as above,
//                                 (dy in x's layout, or in NCHW planes against
//                                 a rows x: a concat's gradient, read value by
//                                 value),
//                                 g = dy * silu'(z) (act) or dy, and the sums
//                                 of g and g * xhat, xhat = (x - mean) * rstd,
//                                 in float32, merged as in the stats kernel.
//   bn_silu_grad_finalize_kernel  a block a channel sums its P partials in a
//                                 fixed order: dbias = sum g,
//                                 dweight = sum g * xhat, coef = (sum g / n,
//                                 sum g * xhat / n).
//   bn_silu_dx_kernel             dx = inv * (g - coef0 - xhat * coef1) in
//                                 float32, stored in the activation dtype, in
//                                 x's layout family, dense.
//
// No sum uses atomics and every merge runs in a fixed order, so a launch
// repeats its results bit for bit (a replayed CUDA graph equals the eager
// step). Every launch is asynchronous on the caller's stream and allocates
// nothing.
//
// What bounds it: bytes. A forward reads x twice and writes y (6 B a value
// in bfloat16), a backward reads x and dy twice and writes dx (10 B); the
// partials are 8 B a (chunk, channel). The arithmetic comes near the card's
// issue rate at those bytes (an exp and a division a value for the SiLU, its
// derivative twice in the backward), so the backward takes the hardware
// exponential and reciprocal, and the loads stay packed until used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Loads in flight a thread, and blocks an SM must hold at once (which caps a
// thread's registers: 3 blocks, 85), as timed on an H100 at the v8x train
// shapes (PERF.md): the statistics read one tensor and keep few values;
// the backward reads two, and in the rows layout keeps 7 constants for each
// of its 8 channels.
constexpr int kUnroll = 4;
constexpr int kStatsBlocks = 4;
constexpr int kApplyBlocks = 3;
template <bool Rows>
struct GradTuning {
  static constexpr int unroll = Rows ? 4 : 2;
  static constexpr int blocks = Rows ? 2 : 3;
};
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  long long sn, sc, sp;  // element strides of an image, a channel, a position in the plane
};

struct Geometry {
  int C, HW;       // channels, positions a plane
  long long NHW;   // values a channel
  long long L;     // values of a channel a chunk
  int P;           // chunks a channel
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// V values of T as loaded, kept packed until each is used: one 16-byte word,
// or one value.
template <typename T, int V>
struct Vec {
  typename std::conditional<V == 1, T, uint4>::type w;

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 1) {
      w = __ldg(p);
    } else {
      static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
      w = __ldg(reinterpret_cast<const uint4*>(p));
    }
  }

  // V values `stride` elements apart (dy in NCHW planes against a rows x).
  __device__ __forceinline__ void gather(const T* p, long long stride) {
    if constexpr (V == 1) {
      load(p);
    } else if constexpr (std::is_same<T, float>::value) {
      w = make_uint4(__float_as_uint(__ldg(p)), __float_as_uint(__ldg(p + stride)),
                     __float_as_uint(__ldg(p + 2 * stride)), __float_as_uint(__ldg(p + 3 * stride)));
    } else {
      uint32_t q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (uint32_t)__bfloat16_as_ushort(__ldg(p + 2 * i * stride)) |
               ((uint32_t)__bfloat16_as_ushort(__ldg(p + (2 * i + 1) * stride)) << 16);
      w = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }

  // Value j as float32 (j a constant once the loops over it are unrolled).
  __device__ __forceinline__ float operator[](int j) const {
    if constexpr (V == 1) {
      if constexpr (std::is_same<T, float>::value) {
        return w;
      } else {
        return __bfloat162float(w);
      }
    } else {
      const int q = std::is_same<T, float>::value ? j : j >> 1;
      const uint32_t word = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
      if constexpr (std::is_same<T, float>::value) {
        return __uint_as_float(word);
      } else {
        return __uint_as_float(j & 1 ? word & 0xffff0000u : word << 16);
      }
    }
  }
};

// V float32 values rounded to T (to nearest even) and stored at p.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      *p = v[0];
    } else {
      *p = __float2bfloat16_rn(v[0]);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
}

// The items one thread visits in its block's chunk, and where they lie.
// planar: an item is a vector of V values of channel `unit`, along the plane;
//         the block's threads take items first, first + 256, ...
// rows:   an item is a row, of which the thread takes the V channels from
//         `unit` on; the row lanes take rows first, first + lanes, ...
// Items count image-major: `per` items an image.
template <int V, bool Rows>
struct Walk {
  unsigned first, end, step, per;
  int unit;      // planar: the channel; rows: the first channel of the vector
  int slot;      // rows: the thread's vector in the tile; planar: 0
  int lane;      // rows: the thread's row lane; planar: 0
  int lanes;     // rows: the block's row lanes; planar: 1
  int tile_vecs; // rows: the tile's vectors; planar: 1

  __device__ Walk(const Geometry& g) {
    const int k = blockIdx.x;
    const long long e0 = (long long)k * g.L;
    const long long e1 = min(e0 + g.L, g.NHW);
    if constexpr (Rows) {
      const int vecs = g.C / V;
      tile_vecs = min(kThreads, vecs - (int)blockIdx.y * kThreads);
      lanes = kThreads / tile_vecs;
      slot = threadIdx.x % tile_vecs;
      lane = threadIdx.x / tile_vecs;
      unit = ((int)blockIdx.y * kThreads + slot) * V;
      per = (unsigned)g.HW;
      step = (unsigned)lanes;
      first = (unsigned)e0 + lane;
      end = lane < lanes ? (unsigned)e1 : 0u;
    } else {
      tile_vecs = 1;
      lanes = 1;
      slot = 0;
      lane = 0;
      unit = blockIdx.y;
      per = (unsigned)(g.HW / V);
      step = kThreads;
      first = (unsigned)(e0 / V) + threadIdx.x;
      end = (unsigned)(e1 / V);
    }
  }

  __device__ __forceinline__ long long offset(unsigned idx, const Layout& lay) const {
    const unsigned n = idx / per;
    const long long pos = (long long)(idx - n * per) * (Rows ? lay.sp : V * lay.sp);
    return (long long)n * lay.sn + (long long)unit * lay.sc + pos;
  }

  // Layout of the dense output in x's layout family.
  __device__ __forceinline__ static Layout dense(const Geometry& g) {
    return Rows ? Layout{(long long)g.HW * g.C, 1, g.C} : Layout{(long long)g.C * g.HW, g.HW, 1};
  }

  // The channel of value j of this thread's items.
  __device__ __forceinline__ int channel(int j) const { return Rows ? unit + j : unit; }
};

// z = x * inv + shift as nn/module.py:BatchNorm computes it in T: the
// product rounded to T, then the sum (inv and shift already rounded to T).
template <typename T>
__device__ __forceinline__ float affine(float x, float inv, float shift) {
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x, inv)), shift));
}

// PyTorch's silu: x / (1 + exp(-x)) in float32.
__device__ __forceinline__ float silu(float z) {
  return __fdiv_rn(z, __fadd_rn(1.0f, expf(-z)));
}

// d silu / dz = s * (1 + z * (1 - s)), s = sigmoid(z), in float32 from the
// hardware exponential and reciprocal (a few ulp): the backward's arithmetic
// costs as much as its bytes, and no bit-exact match is asked of it
// (PyTorch's own backward rounds this gradient to bfloat16).
__device__ __forceinline__ float silu_grad(float z) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-z));
  return s * __fmaf_rn(z, 1.0f - s, 1.0f);
}

// ---------------------------------------------------------------- reductions
struct Moments {
  float n, mean, m2;
};

// Chan's merge of (nb, mb, m2b) into a.
__device__ __forceinline__ void chan(Moments& a, float nb, float mb, float m2b) {
  if (nb == 0.0f) return;
  const float n = a.n + nb;
  const float d = mb - a.mean;
  const float f = nb / n;
  a.mean = a.mean + d * f;
  a.m2 = (a.m2 + m2b) + (d * d) * a.n * f;
  a.n = n;
}

// A thread's moments of V value slots (channels, or a plane's vector
// positions), all over the same count n.
template <int V>
struct Slots {
  float n, mean[V], m2[V];
};

// Chan's merge of nb values a slot, with means mb and M2 m2b, into a: one
// division for all slots.
template <int V>
__device__ __forceinline__ void chan(Slots<V>& a, float nb, const float (&mb)[V],
                                     const float (&m2b)[V]) {
  if (nb == 0.0f) return;
  const float n = a.n + nb;
  const float f = nb / n;
  const float h = a.n * f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = mb[j] - a.mean[j];
    a.mean[j] = a.mean[j] + d * f;
    a.m2[j] = (a.m2[j] + m2b[j]) + (d * d) * h;
  }
  a.n = n;
}

// Lane 0 ends with the merge of the warp's moments, in a fixed tree.
__device__ __forceinline__ void warp_merge(Moments& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(kFull, a.n, off);
    const float mb = __shfl_down_sync(kFull, a.mean, off);
    const float m2b = __shfl_down_sync(kFull, a.m2, off);
    if ((threadIdx.x & 31) + off < 32) chan(a, nb, mb, m2b);
  }
}

__device__ __forceinline__ float2 warp_sum(float2 a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a.x += __shfl_down_sync(kFull, a.x, off);
    a.y += __shfl_down_sync(kFull, a.y, off);
  }
  return a;
}

__device__ __forceinline__ float chunk_count(const Geometry& g, int k) {
  return (float)min(g.L, g.NHW - (long long)k * g.L);
}

// Rows layout: the block's row lanes merged in a fixed tree (lane l takes
// lane l + stride, stride 1, 2, 4, ...) through shared memory, into the
// registers of lane 0. `stage` writes this thread's values to slot t, `take`
// merges slot t's into its own.
template <int V, bool Rows, typename Stage, typename Take>
__device__ __forceinline__ void lane_tree(const Walk<V, Rows>& w, Stage stage, Take take) {
  stage(threadIdx.x);
  for (int stride = 1; stride < w.lanes; stride <<= 1) {
    __syncthreads();  // the last level's writes; no slot is read and written in one level
    if (w.lane % (2 * stride) == 0 && w.lane + stride < w.lanes) {
      take((w.lane + stride) * w.tile_vecs + w.slot);
      stage(threadIdx.x);
    }
  }
}

// The block's per-thread moments into the chunk's partials,
// part[channel * P + chunk] = (mean, M2), merged in a fixed order.
template <int V, bool Rows>
__device__ __forceinline__ void store_moments(const Walk<V, Rows>& w, const Geometry& g,
                                              Slots<V>& m, float2* part) {
  if constexpr (Rows) {
    __shared__ float2 s_m[kThreads][V];
    __shared__ float s_n[kThreads];
    lane_tree(
        w,
        [&](int t) {
#pragma unroll
          for (int j = 0; j < V; ++j) s_m[t][j] = make_float2(m.mean[j], m.m2[j]);
          s_n[t] = m.n;
        },
        [&](int t) {
          float mb[V], m2b[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            mb[j] = s_m[t][j].x;
            m2b[j] = s_m[t][j].y;
          }
          chan(m, s_n[t], mb, m2b);
        });
    if (w.lane == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        part[(long long)w.channel(j) * g.P + blockIdx.x] = make_float2(m.mean[j], m.m2[j]);
    }
  } else {
    Moments a{m.n, m.mean[0], m.m2[0]};
#pragma unroll
    for (int j = 1; j < V; ++j) chan(a, m.n, m.mean[j], m.m2[j]);
    __shared__ Moments warps[kWarps];
    warp_merge(a);
    if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = a;
    __syncthreads();
    if (threadIdx.x < 32) {
      Moments b = threadIdx.x < kWarps ? warps[threadIdx.x] : Moments{0.0f, 0.0f, 0.0f};
      warp_merge(b);
      if (threadIdx.x == 0) part[(long long)w.unit * g.P + blockIdx.x] = make_float2(b.mean, b.m2);
    }
  }
}

// The same for per-thread sums (sum g, sum g * xhat).
template <int V, bool Rows>
__device__ __forceinline__ void store_sums(const Walk<V, Rows>& w, const Geometry& g,
                                           float2 (&s)[V], float2* part) {
  if constexpr (Rows) {
    __shared__ float2 s_s[kThreads][V];
    lane_tree(
        w,
        [&](int t) {
#pragma unroll
          for (int j = 0; j < V; ++j) s_s[t][j] = s[j];
        },
        [&](int t) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s[j].x += s_s[t][j].x;
            s[j].y += s_s[t][j].y;
          }
        });
    if (w.lane == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) part[(long long)w.channel(j) * g.P + blockIdx.x] = s[j];
    }
  } else {
    float2 a = s[0];
#pragma unroll
    for (int j = 1; j < V; ++j) {
      a.x += s[j].x;
      a.y += s[j].y;
    }
    __shared__ float2 warps[kWarps];
    a = warp_sum(a);
    if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = a;
    __syncthreads();
    if (threadIdx.x < 32) {
      float2 b = threadIdx.x < kWarps ? warps[threadIdx.x] : make_float2(0.0f, 0.0f);
      b = warp_sum(b);
      if (threadIdx.x == 0) part[(long long)w.unit * g.P + blockIdx.x] = b;
    }
  }
}

// ---------------------------------------------------------------- kernels
template <typename T, int V, bool Rows>
__global__ void __launch_bounds__(kThreads, kStatsBlocks)
    bn_silu_stats_kernel(const T* __restrict__ x, Layout lx, Geometry g, float2* __restrict__ part) {
  const Walk<V, Rows> w(g);
  Slots<V> m;
  m.n = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) m.mean[j] = m.m2[j] = 0.0f;
  for (unsigned base = w.first; base < w.end; base += w.step * kUnroll) {
    Vec<T, V> v[kUnroll];
    int got = 0;  // items are visited in order, so the valid ones come first
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned idx = base + u * w.step;
      if (idx < w.end) {
        v[u].load(x + w.offset(idx, lx));
        ++got;
      }
    }
    const float cnt = (float)got, rc = 1.0f / cnt;
    float mean[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {  // the group's own two passes, each value slot apart
      float s = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < got) s += v[u][j];
      mean[j] = s * rc;
      m2[j] = 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < got) {
          const float d = v[u][j] - mean[j];
          m2[j] += d * d;
        }
    }
    chan(m, cnt, mean, m2);
  }
  store_moments<V, Rows>(w, g, m, part);
}

// A block a channel: the threads take partials tid, tid + 256, ... in
// order, then a warp tree and the warps in order.
__global__ void __launch_bounds__(kThreads)
    bn_silu_finalize_kernel(const float2* __restrict__ part, Geometry g,
                            const float* __restrict__ weight, const float* __restrict__ bias,
                            float eps, float keep, float momentum, float bessel,
                            float* running_mean, float* running_var, float* __restrict__ stat) {
  const int c = blockIdx.x;
  Moments a{0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int k = threadIdx.x; k < g.P; k += kThreads) {
    const float2 q = part[(long long)c * g.P + k];
    chan(a, chunk_count(g, k), q.x, q.y);
  }
  __shared__ Moments warps[kWarps];
  warp_merge(a);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  a = threadIdx.x < kWarps ? warps[threadIdx.x] : Moments{0.0f, 0.0f, 0.0f};
  warp_merge(a);
  if (threadIdx.x == 0) {
    // nn/module.py:BatchNorm's float32 arithmetic, operation by operation
    const float mean = a.mean;
    const float var = __fdiv_rn(a.m2, (float)g.NHW);
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    const float inv = __fmul_rn(rstd, weight[c]);
    stat[c] = mean;
    stat[g.C + c] = rstd;
    stat[2 * g.C + c] = inv;
    stat[3 * g.C + c] = __fsub_rn(bias[c], __fmul_rn(mean, inv));
    running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(momentum, mean));
    running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                               __fmul_rn(momentum, __fmul_rn(var, bessel)));
  }
}

template <typename T, int V, bool Act, bool Rows>
__global__ void __launch_bounds__(kThreads, kApplyBlocks)
    bn_silu_apply_kernel(const T* __restrict__ x, Layout lx, Geometry g,
                         const float* __restrict__ stat, T* __restrict__ y) {
  const Walk<V, Rows> w(g);
  const Layout ly = Walk<V, Rows>::dense(g);
  float inv[V], shift[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = w.channel(j);
    inv[j] = round_to<T>(stat[2 * g.C + c]);
    shift[j] = round_to<T>(stat[3 * g.C + c]);
  }
  for (unsigned base = w.first; base < w.end; base += w.step * kUnroll) {
    Vec<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned idx = base + u * w.step;
      if (idx < w.end) v[u].load(x + w.offset(idx, lx));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned idx = base + u * w.step;
      if (idx < w.end) {
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float z = affine<T>(v[u][j], inv[j], shift[j]);
          o[j] = Act ? silu(z) : z;
        }
        store_vec<T, V>(y + w.offset(idx, ly), o);
      }
    }
  }
}

// The per-channel values a backward kernel needs, for this thread's channels.
template <typename T, int V, bool Rows>
struct GradConsts {
  float mean[V], rstd[V], inv[V], inv_t[V], shift_t[V];
  __device__ GradConsts(const Walk<V, Rows>& w, const Geometry& g, const float* stat) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = w.channel(j);
      mean[j] = stat[c];
      rstd[j] = stat[g.C + c];
      inv[j] = stat[2 * g.C + c];
      inv_t[j] = round_to<T>(inv[j]);
      shift_t[j] = round_to<T>(stat[3 * g.C + c]);
    }
  }
};

// g (the gradient at the BatchNorm's output) and xhat of one value; z is
// the forward's, rounded as it was.
template <typename T, bool Act>
__device__ __forceinline__ void grad_at(float x, float dy, float mean, float rstd, float inv_t,
                                        float shift_t, float& gv, float& xh) {
  gv = Act ? dy * silu_grad(affine<T>(x, inv_t, shift_t)) : dy;
  xh = (x - mean) * rstd;
}

template <typename T, int V, bool Act, bool Rows, bool DyPlanes>
__global__ void __launch_bounds__(kThreads, GradTuning<Rows>::blocks)
    bn_silu_grad_reduce_kernel(const T* __restrict__ dy, Layout ld, const T* __restrict__ x,
                               Layout lx, Geometry g, const float* __restrict__ stat,
                               float2* __restrict__ part) {
  const Walk<V, Rows> w(g);
  const GradConsts<T, V, Rows> k(w, g, stat);
  float2 acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = make_float2(0.0f, 0.0f);
  constexpr int U = GradTuning<Rows>::unroll;
  for (unsigned base = w.first; base < w.end; base += w.step * U) {
    Vec<T, V> xv[U], dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned idx = base + u * w.step;
      if (idx < w.end) {
        xv[u].load(x + w.offset(idx, lx));
        if constexpr (DyPlanes) {
          dv[u].gather(dy + w.offset(idx, ld), ld.sc);
        } else {
          dv[u].load(dy + w.offset(idx, ld));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * w.step < w.end) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float gv, xh;
          grad_at<T, Act>(xv[u][j], dv[u][j], k.mean[j], k.rstd[j], k.inv_t[j], k.shift_t[j],
                          gv, xh);
          acc[j].x += gv;
          acc[j].y = __fmaf_rn(gv, xh, acc[j].y);
        }
      }
    }
  }
  store_sums<V, Rows>(w, g, acc, part);
}

// A block a channel, summing as the statistics' finalize merges: dbias,
// dweight and coef = (sum g / n, sum g * xhat / n).
__global__ void __launch_bounds__(kThreads)
    bn_silu_grad_finalize_kernel(const float2* __restrict__ part, Geometry g,
                                 float* __restrict__ dweight, float* __restrict__ dbias,
                                 float* __restrict__ coef) {
  const int c = blockIdx.x;
  float2 a = make_float2(0.0f, 0.0f);
#pragma unroll 4
  for (int k = threadIdx.x; k < g.P; k += kThreads) {
    const float2 q = part[(long long)c * g.P + k];
    a.x += q.x;
    a.y += q.y;
  }
  __shared__ float2 warps[kWarps];
  a = warp_sum(a);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  a = warp_sum(threadIdx.x < kWarps ? warps[threadIdx.x] : make_float2(0.0f, 0.0f));
  if ((threadIdx.x & 31) == 0) {
    dbias[c] = a.x;
    dweight[c] = a.y;
    coef[c] = a.x / (float)g.NHW;
    coef[g.C + c] = a.y / (float)g.NHW;
  }
}

template <typename T, int V, bool Act, bool Rows, bool DyPlanes>
__global__ void __launch_bounds__(kThreads, GradTuning<Rows>::blocks)
    bn_silu_dx_kernel(const T* __restrict__ dy, Layout ld, const T* __restrict__ x, Layout lx,
                      Geometry g, const float* __restrict__ stat, const float* __restrict__ coef,
                      T* __restrict__ dx) {
  const Walk<V, Rows> w(g);
  const Layout lo = Walk<V, Rows>::dense(g);
  const GradConsts<T, V, Rows> k(w, g, stat);
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = w.channel(j);
    a[j] = coef[c];
    b[j] = coef[g.C + c];
  }
  constexpr int U = GradTuning<Rows>::unroll;
  for (unsigned base = w.first; base < w.end; base += w.step * U) {
    Vec<T, V> xv[U], dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned idx = base + u * w.step;
      if (idx < w.end) {
        xv[u].load(x + w.offset(idx, lx));
        if constexpr (DyPlanes) {
          dv[u].gather(dy + w.offset(idx, ld), ld.sc);
        } else {
          dv[u].load(dy + w.offset(idx, ld));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned idx = base + u * w.step;
      if (idx < w.end) {
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float gv, xh;
          grad_at<T, Act>(xv[u][j], dv[u][j], k.mean[j], k.rstd[j], k.inv_t[j], k.shift_t[j],
                          gv, xh);
          o[j] = k.inv[j] * __fmaf_rn(-xh, b[j], gv - a[j]);
        }
        store_vec<T, V>(dx + w.offset(idx, lo), o);
      }
    }
  }
}

// planar: a block a (chunk, channel); rows: a block a (chunk, tile of up to
// kThreads vectors of channels).
dim3 grid_of(const Geometry& g, int rows, int vec_values) {
  const int units = rows ? (g.C / vec_values + kThreads - 1) / kThreads : g.C;
  return dim3((unsigned)g.P, (unsigned)units);
}


}  // namespace

// LAUNCH(T, V, ...) for the input's dtype (0 float32, 1 bfloat16) and vec
// (16-byte vectors, or single values); the layout's template arguments follow.
#define BN_SILU_TYPES(dtype, vec, LAUNCH, ...)     \
  do {                                             \
    if ((dtype) == 0) {                            \
      if (vec) {                                   \
        LAUNCH(float, 4, __VA_ARGS__);             \
      } else {                                     \
        LAUNCH(float, 1, __VA_ARGS__);             \
      }                                            \
    } else {                                       \
      if (vec) {                                   \
        LAUNCH(__nv_bfloat16, 8, __VA_ARGS__);     \
      } else {                                     \
        LAUNCH(__nv_bfloat16, 1, __VA_ARGS__);     \
      }                                            \
    }                                              \
  } while (0)

// The forward's layouts: rows, or planar.
#define BN_SILU_DISPATCH(dtype, vec, rows, LAUNCH)   \
  do {                                               \
    if (rows) {                                      \
      BN_SILU_TYPES(dtype, vec, LAUNCH, true);       \
    } else {                                         \
      BN_SILU_TYPES(dtype, vec, LAUNCH, false);      \
    }                                                \
  } while (0)

// The backward's: planar; rows; rows with dy in NCHW planes.
#define BN_SILU_DISPATCH_GRAD(dtype, vec, rows, dy_planes, LAUNCH) \
  do {                                                             \
    if (!(rows)) {                                                 \
      BN_SILU_TYPES(dtype, vec, LAUNCH, false, false);             \
    } else if (dy_planes) {                                        \
      BN_SILU_TYPES(dtype, vec, LAUNCH, true, true);               \
    } else {                                                       \
      BN_SILU_TYPES(dtype, vec, LAUNCH, true, false);              \
    }                                                              \
  } while (0)

extern "C" {

// dtype: 0 float32, 1 bfloat16. vec: every value of x (and dy) lies in a
// whole 16-byte vector along the plane (planar) or the row (rows). (sxn, sxc,
// sxp) / (sdn, sdc, sdp): element strides of an image, a channel and a
// position of x / dy (sxp = 1 planar, sxc = 1 rows). dy_planes: dy in NCHW
// planes against a rows x (a vector of dy is read value by value, sdc apart). y and dx are written
// dense in x's layout family. part is (C, P) float2, stat (4, C) float32
// (mean, rstd, inv, shift), coef (2, C) float32. Each runs on `stream` and
// returns cudaGetLastError() (0 on success).

// The statistics: bn_silu_stats_kernel, then bn_silu_finalize_kernel.
int cerberus_bn_silu_stats(const void* x, long long sxn, long long sxc, long long sxp, int dtype,
                           int vec, int rows, int C, int HW, long long NHW, long long L, int P,
                           float* part, const float* weight, const float* bias, float eps,
                           float keep, float momentum, float bessel, float* running_mean,
                           float* running_var, float* stat, void* stream) {
  const Geometry g{C, HW, NHW, L, P};
  const Layout lx{sxn, sxc, sxp};
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V, R)                                                              \
  bn_silu_stats_kernel<T, V, R><<<grid_of(g, rows, V), kThreads, 0, s>>>(            \
      static_cast<const T*>(x), lx, g, reinterpret_cast<float2*>(part))
  BN_SILU_DISPATCH(dtype, vec, rows, LAUNCH);
#undef LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_silu_finalize_kernel<<<C, kThreads, 0, s>>>(
      reinterpret_cast<const float2*>(part), g, weight, bias, eps, keep, momentum, bessel,
      running_mean, running_var, stat);
  return (int)cudaGetLastError();
}

int cerberus_bn_silu_apply(const void* x, long long sxn, long long sxc, long long sxp, int dtype,
                           int vec, int rows, int C, int HW, long long NHW, long long L, int P,
                           const float* stat, int act, void* y, void* stream) {
  const Geometry g{C, HW, NHW, L, P};
  const Layout lx{sxn, sxc, sxp};
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V, R)                                                                   \
  (act ? bn_silu_apply_kernel<T, V, true, R> : bn_silu_apply_kernel<T, V, false, R>)     \
      <<<grid_of(g, rows, V), kThreads, 0, s>>>(static_cast<const T*>(x), lx, g, stat,    \
                                                 static_cast<T*>(y))
  BN_SILU_DISPATCH(dtype, vec, rows, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The gradient's sums: bn_silu_grad_reduce_kernel, then
// bn_silu_grad_finalize_kernel.
int cerberus_bn_silu_grad_reduce(const void* dy, long long sdn, long long sdc, long long sdp,
                                 const void* x, long long sxn, long long sxc, long long sxp,
                                 int dy_planes, int dtype, int vec, int rows, int C, int HW,
                                 long long NHW,
                                 long long L, int P, const float* stat, int act, float* part,
                                 float* dweight, float* dbias, float* coef, void* stream) {
  const Geometry g{C, HW, NHW, L, P};
  const Layout ld{sdn, sdc, sdp}, lx{sxn, sxc, sxp};
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V, R, DP)                                                                \
  (act ? bn_silu_grad_reduce_kernel<T, V, true, R, DP>                                      \
       : bn_silu_grad_reduce_kernel<T, V, false, R, DP>)<<<grid_of(g, rows, V), kThreads, 0, \
                                                          s>>>(                             \
      static_cast<const T*>(dy), ld, static_cast<const T*>(x), lx, g, stat,                 \
      reinterpret_cast<float2*>(part))
  BN_SILU_DISPATCH_GRAD(dtype, vec, rows, dy_planes, LAUNCH);
#undef LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_silu_grad_finalize_kernel<<<C, kThreads, 0, s>>>(
      reinterpret_cast<const float2*>(part), g, dweight, dbias, coef);
  return (int)cudaGetLastError();
}

int cerberus_bn_silu_dx(const void* dy, long long sdn, long long sdc, long long sdp, const void* x,
                        long long sxn, long long sxc, long long sxp, int dy_planes, int dtype,
                        int vec, int rows,
                        int C, int HW, long long NHW, long long L, int P, const float* stat,
                        const float* coef, int act, void* dx, void* stream) {
  const Geometry g{C, HW, NHW, L, P};
  const Layout ld{sdn, sdc, sdp}, lx{sxn, sxc, sxp};
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(T, V, R, DP)                                                                \
  (act ? bn_silu_dx_kernel<T, V, true, R, DP> : bn_silu_dx_kernel<T, V, false, R, DP>)    \
      <<<grid_of(g, rows, V), kThreads, 0, s>>>(static_cast<const T*>(dy), ld,             \
                                                 static_cast<const T*>(x), lx, g, stat, coef, \
                                                 static_cast<T*>(dx))
  BN_SILU_DISPATCH_GRAD(dtype, vec, rows, dy_planes, LAUNCH);
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
