// Task-aligned assigner (TAL) for Hopper (sm_90a): three kernels per assignment.
//
// Replaces cerberusdet_tpu/ops/tal_pallas.py:_pass1_kernel and _pass2_kernel.
// The results equal those of the plain formulation
// (cerberusdet_tpu_torch/train/tal.py:TaskAlignedAssigner): fg_mask,
// target_gt_idx, target_labels and target_bboxes exactly, target_scores to the
// last bit as long as both sides round alike (see "Exactness").
//
// The TPU kernels carry per-anchor accumulators across a sequential grid axis
// of gt tiles. Here blocks run in parallel, and pass 1 reduces in two
// directions (the top-k along a gt row over all N anchors; the positive
// count, first positive gt and argmax overlap down an anchor column over all
// M gts), so the work is split by direction:
//
//   tal_select  one block per (image, gt row). A gt that is not valid writes
//               -1s and ends. A valid one computes its row of
//               metric = align * in_gt into shared memory (N * 4 B), then
//               picks the first-occurrence top-k: each thread keeps the best
//               of its own strided anchors (scanned in index order), a
//               (value desc, index asc) warp-shuffle and block reduction
//               gives the winner, and only the winner's owner rescans. It
//               writes sel (B, M, k): the anchor index where the anchor is
//               inside the gt, else -1.
//   tal_assign  a block per 256 anchors of an image. The block gathers the
//               sel entries that fall in its anchor range into shared-memory
//               counters (atomicAdd for the count, atomicMin for the first
//               positive gt: both exact in any order). Phase 1, a thread per
//               anchor: no positive -> gt 0, background; one -> that gt;
//               several -> listed in shared memory. Phase 2, a warp per
//               listed anchor: the first-occurrence argmax of the clipped
//               CIoU over ALL M rows, valid or not (the plain
//               select_highest_overlaps), the lanes taking rows m = lane,
//               lane + 32, ... and a (value desc, index asc) shuffle joining
//               them. A lone thread scanning all M rows for such an anchor
//               made its 31 neighbours wait, and the flagship's large,
//               overlapping gt boxes make such anchors common. Either phase
//               writes the gt index, fg, the clipped label and the gt box,
//               keeps align at its gt, and folds align and CIoU into the
//               gt's maxima pos (B, M, 2) with atomicMax on the int bits
//               (exact: the values are >= +0).
//   tal_norm    one thread per (image, anchor, class): target_scores =
//               (fg and class == label) ? align * pos_ov / (pos_align + eps) : 0.
//
// What bounds it on this card: neither bytes nor operations. At the flagship
// shapes (B 8, M 300 with 40 valid, N 8400) the work is ~2.7 M (gt, anchor)
// pairs, ~0.2 G fp32 operations, and ~12 MB in and out; the three launches,
// the k dependent block reductions of tal_select and the M-row argmax of
// each multiply claimed anchor in tal_assign set the time.
//
// Exactness: the CIoU follows the plain version's operation order,
// arctan(w / (h + eps)) arrives precomputed per box, every operation is an
// explicitly rounded __f*_rn intrinsic (and the file is compiled with
// --fmad=false), alpha = 0.5 is a correctly rounded sqrt and beta an integer
// power taken as a left-to-right product, as the plain version takes them.
// Inputs are finite (sigmoid scores, decoded boxes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kCiouEps = 1e-7f;
constexpr float kFourOverPi2 = (float)(4.0 / (3.14159265358979323846 * 3.14159265358979323846));
constexpr float kOnePlusEps = (float)(1.0 + 1e-7);
constexpr float kInGtEps = 1e-9f;

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// clip(CIoU(g, p), 0) of one gt box g and one predicted box p (xyxy), with
// at_g = arctan(w_g / (h_g + eps)) and at_p likewise; ops/boxes.py:bbox_iou order.
__device__ __forceinline__ float ciou_clip(float4 g, float4 p, float at_g, float at_p) {
  const float w1 = __fsub_rn(g.z, g.x), h1 = __fadd_rn(__fsub_rn(g.w, g.y), kCiouEps);
  const float w2 = __fsub_rn(p.z, p.x), h2 = __fadd_rn(__fsub_rn(p.w, p.y), kCiouEps);
  const float iw = fmaxf(__fsub_rn(fminf(g.z, p.z), fmaxf(g.x, p.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(g.w, p.w), fmaxf(g.y, p.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      __fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(w1, h1), __fmul_rn(w2, h2)), inter), kCiouEps);
  const float iou = __fdiv_rn(inter, uni);
  const float cw = __fsub_rn(fmaxf(g.z, p.z), fminf(g.x, p.x));
  const float ch = __fsub_rn(fmaxf(g.w, p.w), fminf(g.y, p.y));
  const float c2 = __fadd_rn(__fadd_rn(sq(cw), sq(ch)), kCiouEps);
  const float dx = __fsub_rn(__fsub_rn(__fadd_rn(p.x, p.z), g.x), g.z);
  const float dy = __fsub_rn(__fsub_rn(__fadd_rn(p.y, p.w), g.y), g.w);
  const float rho2 = __fmul_rn(__fadd_rn(sq(dx), sq(dy)), 0.25f);  // exact: / 4
  const float v = __fmul_rn(kFourOverPi2, sq(__fsub_rn(at_p, at_g)));
  const float alpha = __fdiv_rn(v, __fadd_rn(__fsub_rn(v, iou), kOnePlusEps));
  const float ciou = __fsub_rn(iou, __fadd_rn(__fdiv_rn(rho2, c2), __fmul_rn(v, alpha)));
  return fmaxf(ciou, 0.f);
}

// sqrt(s) * ov^beta, the power as ((ov * ov) * ov) ... left to right.
__device__ __forceinline__ float align_metric(float s, float ov, int beta) {
  float p = ov;
  for (int i = 1; i < beta; ++i) p = __fmul_rn(p, ov);
  return __fmul_rn(__fsqrt_rn(s), p);
}

__device__ __forceinline__ bool inside(float2 a, float4 g) {
  const float d = fminf(fminf(__fsub_rn(a.x, g.x), __fsub_rn(a.y, g.y)),
                        fminf(__fsub_rn(g.z, a.x), __fsub_rn(g.w, a.y)));
  return d > kInGtEps;
}

__device__ __forceinline__ int clip_label(int64_t l, int nc) {
  return (int)(l < 0 ? 0 : (l > nc - 1 ? nc - 1 : l));
}

// (a better than b): larger value, ties to the lower index.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// ---------------------------------------------------------------- tal_select
__global__ void __launch_bounds__(kThreads)
tal_select_kernel(const float* __restrict__ scores, const float4* __restrict__ pd_boxes,
                  const float2* __restrict__ anchors, const float* __restrict__ at_pd,
                  const int64_t* __restrict__ labels, const float4* __restrict__ gt_boxes,
                  const float* __restrict__ at_gt, const uint8_t* __restrict__ mask_gt,
                  int N, int M, int nc, int k, int beta, int32_t* __restrict__ sel) {
  extern __shared__ float metric[];  // N floats
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int pick;

  const int m = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * M + m;
  int32_t* out = sel + row * k;
  if (!mask_gt[row]) {
    for (int j = tid; j < k; j += kThreads) out[j] = -1;
    return;
  }
  const float4 g = gt_boxes[row];
  const float atg = at_gt[row];
  const int label = clip_label(labels[row], nc);
  const float* sc = scores + (size_t)b * N * nc + label;
  const float4* pb = pd_boxes + (size_t)b * N;
  const float* atp = at_pd + (size_t)b * N;

  // the row, and each thread's best (first max in index order)
  float bv = __int_as_float(0xff800000);  // -inf
  int bi = N;
  for (int n = tid; n < N; n += kThreads) {
    float v = 0.f;
    if (inside(anchors[n], g))
      v = align_metric(sc[(size_t)n * nc], ciou_clip(g, pb[n], atg, atp[n]), beta);
    metric[n] = v;
    if (v > bv) { bv = v; bi = n; }
  }
  for (int r = 0; r < k; ++r) {
    float v = bv;
    int i = bi;
    warp_best(v, i);
    if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? red_v[lane] : __int_as_float(0xff800000);
      i = lane < kWarps ? red_i[lane] : N;
      warp_best(v, i);
      if (lane == 0) {
        pick = i;
        out[r] = (i < N && inside(anchors[i], g)) ? i : -1;
      }
    }
    __syncthreads();
    const int j = pick;
    if (j < N && j % kThreads == tid) {  // the owner drops its pick and rescans
      metric[j] = __int_as_float(0xff800000);
      bv = __int_as_float(0xff800000);
      bi = N;
      for (int n = tid; n < N; n += kThreads) {
        const float w = metric[n];
        if (w > bv) { bv = w; bi = n; }
      }
    }
    // red_v / red_i / pick are rewritten only after the next round's first
    // barrier, which every thread reaches after reading `pick`
  }
}

// The outputs of anchor a (flat over B x N) resolved to gt t of its image:
// the gt index, fg, the clipped label and the gt box; for a positive anchor
// align at t, folded with the CIoU ov into t's maxima pos (atomicMax on the
// int bits, exact: the values are >= +0).
__device__ __forceinline__ void write_target(size_t a, int t, bool fg, float ov,
                                             const float* __restrict__ scores, int nc,
                                             int beta, const float4* s_box,
                                             const int* s_label, size_t gb,
                                             int64_t* __restrict__ tgt_out,
                                             uint8_t* __restrict__ fg_out,
                                             int64_t* __restrict__ label_out,
                                             float4* __restrict__ box_out,
                                             float* __restrict__ align_out,
                                             float* __restrict__ pos) {
  const int label = s_label[t];
  tgt_out[a] = t;
  fg_out[a] = fg;
  label_out[a] = label;
  box_out[a] = s_box[t];
  float al = 0.f;
  if (fg) {
    al = align_metric(scores[a * nc + label], ov, beta);
    atomicMax(reinterpret_cast<int*>(pos) + (gb + t) * 2, __float_as_int(al));
    atomicMax(reinterpret_cast<int*>(pos) + (gb + t) * 2 + 1, __float_as_int(ov));
  }
  align_out[a] = al;
}

// ---------------------------------------------------------------- tal_assign
__global__ void __launch_bounds__(kThreads)
tal_assign_kernel(const float* __restrict__ scores, const float4* __restrict__ pd_boxes,
                  const float* __restrict__ at_pd, const int64_t* __restrict__ labels,
                  const float4* __restrict__ gt_boxes, const float* __restrict__ at_gt,
                  const int32_t* __restrict__ sel, int N, int M, int nc, int k, int beta,
                  int64_t* __restrict__ tgt_out, uint8_t* __restrict__ fg_out,
                  int64_t* __restrict__ label_out, float4* __restrict__ box_out,
                  float* __restrict__ align_out, float* __restrict__ pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);          // M
  float* s_at = reinterpret_cast<float*>(s_box + M);         // M
  int* s_label = reinterpret_cast<int*>(s_at + M);          // M
  __shared__ int s_count[kThreads];
  __shared__ int s_first[kThreads];
  __shared__ int s_multi[kThreads];  // the block's anchors that several gts claim
  __shared__ int s_n_multi;

  const int b = blockIdx.y, tid = threadIdx.x;
  const int n0 = blockIdx.x * kThreads;
  const size_t gb = (size_t)b * M;
  s_count[tid] = 0;
  s_first[tid] = 0x7fffffff;
  if (tid == 0) s_n_multi = 0;
  for (int m = tid; m < M; m += kThreads) {
    s_box[m] = gt_boxes[gb + m];
    s_at[m] = at_gt[gb + m];
    s_label[m] = clip_label(labels[gb + m], nc);
  }
  __syncthreads();
  const int32_t* sb = sel + gb * k;
  for (int e = tid; e < M * k; e += kThreads) {
    const int n = sb[e] - n0;
    if (n >= 0 && n < kThreads) {
      atomicAdd(&s_count[n], 1);
      atomicMin(&s_first[n], e / k);
    }
  }
  __syncthreads();

  // phase 1: each thread resolves its own anchor when at most one gt claims
  // it, and lists it for phase 2 when several do
  const int n = n0 + tid;
  const int count = n < N ? s_count[tid] : 0;
  if (count > 1) s_multi[atomicAdd(&s_n_multi, 1)] = tid;
  if (n < N && count <= 1) {
    const size_t a = (size_t)b * N + n;
    int t = 0;
    float ov = 0.f;
    if (count == 1) {
      t = min(s_first[tid], M - 1);
      ov = ciou_clip(s_box[t], pd_boxes[a], s_at[t], at_pd[a]);
    }
    write_target(a, t, count == 1, ov, scores, nc, beta, s_box, s_label, gb, tgt_out, fg_out,
                 label_out, box_out, align_out, pos);
  }
  __syncthreads();

  // phase 2: a warp per listed anchor; the lanes split the M rows, each keeps
  // its first maximum in index order, and a (value desc, index asc) shuffle
  // gives the first-occurrence argmax over all M rows, as a scan in order would
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = warp; j < s_n_multi; j += kWarps) {
    const size_t a = (size_t)b * N + n0 + s_multi[j];
    const float4 p = pd_boxes[a];
    const float atp = at_pd[a];
    float ov = __int_as_float(0xff800000);  // -inf
    int t = M;
    for (int m = lane; m < M; m += 32) {
      const float o = ciou_clip(s_box[m], p, s_at[m], atp);
      if (o > ov) { ov = o; t = m; }
    }
    warp_best(ov, t);
    if (lane == 0)
      write_target(a, t, true, ov, scores, nc, beta, s_box, s_label, gb, tgt_out, fg_out,
                   label_out, box_out, align_out, pos);
  }
}

// ------------------------------------------------------------------ tal_norm
__global__ void __launch_bounds__(kThreads)
tal_norm_kernel(const int64_t* __restrict__ tgt, const uint8_t* __restrict__ fg,
                const int64_t* __restrict__ label, const float* __restrict__ align,
                const float* __restrict__ pos, int N, int M, int nc, float eps,
                int64_t total, float* __restrict__ target_scores) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t a = i / nc;
  const int c = (int)(i - a * nc);
  float v = 0.f;
  if (fg[a] && c == label[a]) {
    const int64_t b = a / N;
    const float* pg = pos + (b * M + tgt[a]) * 2;
    v = __fdiv_rn(__fmul_rn(align[a], pg[1]), __fadd_rn(pg[0], eps));
  }
  target_scores[i] = v;
}

}  // namespace

extern "C" {

// Shapes: scores (B, N, nc) f32; pd_boxes (B, N, 4) f32 xyxy, 16-byte aligned;
// anchors (N, 2) f32; at_pd (B, N) f32; labels (B, M) int64; gt_boxes (B, M, 4)
// f32, 16-byte aligned; at_gt (B, M) f32; mask_gt (B, M) uint8.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).

// sel (B, M, k) int32 is written.
int cerberus_tal_select(const float* scores, const float* pd_boxes, const float* anchors,
                        const float* at_pd, const int64_t* labels, const float* gt_boxes,
                        const float* at_gt, const uint8_t* mask_gt, int B, int N, int M,
                        int nc, int k, int beta, int32_t* sel, void* stream) {
  const size_t smem = (size_t)N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tal_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tal_select_kernel<<<dim3(M, B), kThreads, smem, (cudaStream_t)stream>>>(
      scores, reinterpret_cast<const float4*>(pd_boxes),
      reinterpret_cast<const float2*>(anchors), at_pd, labels,
      reinterpret_cast<const float4*>(gt_boxes), at_gt, mask_gt, N, M, nc, k, beta, sel);
  return (int)cudaGetLastError();
}

// tgt, label (B, N) int64, fg (B, N) uint8, boxes (B, N, 4) f32 and align
// (B, N) f32 are written; pos (B, M, 2) f32 must hold +0 on entry.
int cerberus_tal_assign(const float* scores, const float* pd_boxes, const float* at_pd,
                        const int64_t* labels, const float* gt_boxes, const float* at_gt,
                        const int32_t* sel, int B, int N, int M, int nc, int k, int beta,
                        int64_t* tgt, uint8_t* fg, int64_t* label, float* boxes,
                        float* align, float* pos, void* stream) {
  const size_t smem = (size_t)M * (sizeof(float4) + sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      tal_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  tal_assign_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      scores, reinterpret_cast<const float4*>(pd_boxes), at_pd, labels,
      reinterpret_cast<const float4*>(gt_boxes), at_gt, sel, N, M, nc, k, beta, tgt, fg,
      label, reinterpret_cast<float4*>(boxes), align, pos);
  return (int)cudaGetLastError();
}

// target_scores (B, N, nc) f32 is written.
int cerberus_tal_norm(const int64_t* tgt, const uint8_t* fg, const int64_t* label,
                      const float* align, const float* pos, int B, int N, int M, int nc,
                      float eps, float* target_scores, void* stream) {
  const int64_t total = (int64_t)B * N * nc;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  tal_norm_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tgt, fg, label, align, pos, N, M, nc, eps, total, target_scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
