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
//   tal_select  a grid of what the card holds at once (8 warps a block).
//               Each block ranks the valid gt rows by a prefix count of
//               mask_gt and takes ranks j, j + G, ...: the rows that are not
//               valid cost their -1 writes, and no block waits behind them.
//               In a row each warp takes the 32-anchor chunks warp,
//               warp + 8, ... (the anchors inside a gt cluster in index, so
//               interleaving spreads them), tests all its anchors against
//               the gt first, then gathers the inside ones' score, box and
//               arctan 4 at a time and computes metric = align * in_gt into
//               shared memory as order-preserving keys (N * 4 B); each lane
//               keeps its 4 best (key desc, index asc) in registers. The
//               warp's first-occurrence top-k comes by warp reductions alone:
//               redux.sync max of the lanes' heads, min of the indices
//               holding it; the owner pops its head, and rescans its keys
//               only when its 4 run out. After one barrier one warp merges
//               the 8 sorted lists under the same order. Exact: under a
//               strict total order the global top-k lies in the union of the
//               per-warp top-k, ties at 0 included. It writes sel (B, M, k):
//               the anchor index where the anchor is inside the gt, else -1.
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
//   tal_norm    target_scores = (fg and class == label) ?
//               align * pos_ov / (pos_align + eps) : 0, a block per 256
//               anchors: each anchor's inputs read once by one thread, its
//               (class, value) staged in shared memory, and the block's
//               contiguous 256 * nc floats of output written as 16-byte
//               stores (bytes-bound: the output is 5.4 MB of the ~6.8 MB it
//               moves at the flagship shapes; the thread per (anchor, class)
//               it replaces re-read an anchor's inputs nc times, divided by
//               nc in 64 bits and stored 4 bytes a thread).
//
// What bounds it on this card: neither bytes nor operations. At the flagship
// shapes (B 8, M 300 with 40 valid, N 8400) the work is ~2.7 M (gt, anchor)
// pairs, ~0.2 G fp32 operations, and ~12 MB in and out; the three launches,
// the dependent steps of tal_select and the M-row argmax of each multiply
// claimed anchor in tal_assign set the time. tal_select took one block per
// (image, gt row): the 2080 blocks of rows that are not valid held slots the
// valid rows waited for, each lane waited on an L2 round trip for its
// anchors and another for their inputs every 4 anchors, and the top-k had k
// rounds of block-wide reductions, two barriers each, and a rescan by one
// thread. Timed apart on an H100, each of the three took longer than the
// CIoU arithmetic.
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
constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelBatch = 4;  // inside anchors whose inputs a lane gathers at once
constexpr int kLaneTop = 4;   // the best anchors a lane keeps in registers

// The top-k's key of a metric v >= 0: its bits, +0 and -0 alike, plus one,
// so that unsigned order is the metric's order and 0 lies below every
// anchor (a picked anchor, an empty entry).
__device__ __forceinline__ unsigned metric_key(float v) {
  return __float_as_uint(__fadd_rn(v, 0.f)) + 1u;
}

// (ka, ia) before (kb, ib) in the top-k's order: larger key, then lower index
__device__ __forceinline__ bool ahead(unsigned ka, unsigned ia, unsigned kb, unsigned ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Insert (kv, n) into a lane's sorted best list (entries of key 0: empty).
__device__ __forceinline__ void lane_insert(unsigned (&ck)[kLaneTop], unsigned (&ci)[kLaneTop],
                                            unsigned kv, unsigned n) {
  if (!ahead(kv, n, ck[kLaneTop - 1], ci[kLaneTop - 1])) return;
#pragma unroll
  for (int p = 0; p < kLaneTop; ++p) {
    if (ahead(kv, n, ck[p], ci[p])) {
      const unsigned tk = ck[p], ti = ci[p];
      ck[p] = kv;
      ci[p] = n;
      kv = tk;
      n = ti;
    }
  }
}

__global__ void __launch_bounds__(kSelThreads, 3)
tal_select_kernel(const float* __restrict__ scores, const float4* __restrict__ pd_boxes,
                  const float2* __restrict__ anchors, const float* __restrict__ at_pd,
                  const int64_t* __restrict__ labels, const float4* __restrict__ gt_boxes,
                  const float* __restrict__ at_gt, const uint8_t* __restrict__ mask_gt,
                  int B, int N, int M, int nc, int k, int beta, int32_t* __restrict__ sel) {
  // N keys of the row, then each warp's top-k list: k keys, k indices
  extern __shared__ unsigned key[];
  unsigned* list_key = key + N;
  unsigned* list_idx = list_key + kSelWarps * k;
  __shared__ int s_count[kSelWarps];
  __shared__ int s_rows[kSelThreads];
  __shared__ int s_nrows;
  __shared__ unsigned s_pick[kSelThreads];  // the merge's picks, at most kSelThreads a pass

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The valid rows, ranked in row order, go to the blocks in turn: block j
  // takes ranks j, j + G, ... (G = the grid, what the card holds at once),
  // so no block waits behind a row that is not valid, and each writes the
  // -1s of the rows j, j + G, ... that are not valid. Thread t ranks rows
  // [t * per, (t + 1) * per) by a block-wide prefix count. (Loads here and
  // below take clamped indices and no branch, so that the compiler issues a
  // batch of them before the first use.)
  const int BM = B * M, G = gridDim.x;
  const int per = (BM + kSelThreads - 1) / kSelThreads;
  const int r0 = min(tid * per, BM), r1 = min(r0 + per, BM);
  auto flags = [&](int base) {  // bit j: row base + j is valid (and in the slice)
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bits |= (unsigned)(mask_gt[min(base + j, BM - 1)] != 0 && base + j < r1) << j;
    return bits;
  };
  int count = 0;
  for (int base = r0; base < r1; base += 16) count += __popc(flags(base));
  int incl = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_count[warp] = incl;
  if (tid == 0) s_nrows = 0;
  __syncthreads();
  int rank = incl - count;
  for (int w = 0; w < warp; ++w) rank += s_count[w];
  for (int base = r0; base < r1; base += 16) {
    const unsigned bits = flags(base);
    for (int r = base; r < min(base + 16, r1); ++r) {
      if (bits >> (r - base) & 1) {
        if (rank % G == (int)blockIdx.x) s_rows[atomicAdd(&s_nrows, 1)] = r;
        ++rank;
      } else if (r % G == (int)blockIdx.x) {
        for (int j = 0; j < k; ++j) sel[(size_t)r * k + j] = -1;
      }
    }
  }
  __syncthreads();
  const int nrows = s_nrows;

  // a warp's anchors are the 32-anchor chunks warp, warp + kSelWarps, ...:
  // lane l's at 32 (warp + kSelWarps j) + l. Interleaved, so that the
  // anchors inside a gt, which lie in a few runs of the index (its rows of
  // each grid), spread over the warps.
  constexpr int kStride = 32 * kSelWarps;
  const int first = 32 * warp + lane;
  for (int i = 0; i < nrows; ++i) {
    const int row = s_rows[i];
    const int b = row / M;
    int32_t* out = sel + (size_t)row * k;
    const float4 g = gt_boxes[row];
    const float atg = at_gt[row];
    const int label = clip_label(labels[row], nc);
    const float* sc = scores + (size_t)b * N * nc + label;
    const float4* pb = pd_boxes + (size_t)b * N;
    const float* atp = at_pd + (size_t)b * N;

    // the keys of the lane's anchors, 32 at a time: first the in-gt test of
    // all 32 (metric 0 outside), then the inside ones' inputs gathered
    // kSelBatch at a time, so a lane waits on few dependent round trips. The
    // lane keeps its kLaneTop best (key desc, index asc) in registers.
    unsigned ck[kLaneTop], ci[kLaneTop];
#pragma unroll
    for (int p = 0; p < kLaneTop; ++p) { ck[p] = 0; ci[p] = 0xffffffffu; }
    // (seg0 is the warp's, so that every lane takes the same trips and
    // reaches the warp-wide vote below)
    for (int seg0 = 32 * warp; seg0 < N; seg0 += 32 * kStride) {
      const int seg = seg0 + lane;
      unsigned in_mask = 0;
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += 8) {
        float2 a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = anchors[min(seg + kStride * (j0 + j), N - 1)];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = seg + kStride * (j0 + j);
          if (n < N) {
            if (inside(a[j], g)) {
              in_mask |= 1u << (j0 + j);
            } else {
              key[n] = 1u;  // metric_key(0)
              lane_insert(ck, ci, 1u, n);
            }
          }
        }
      }
      // kSelBatch inside anchors at a time, all of them computed (a slot
      // past the lane's last takes anchor `first`'s inputs and is dropped),
      // so that their loads and arithmetic overlap
      while (__any_sync(0xffffffffu, in_mask)) {
        int nn[kSelBatch];
        float4 p[kSelBatch];
        float s[kSelBatch], t[kSelBatch];
#pragma unroll
        for (int u = 0; u < kSelBatch; ++u) {
          nn[u] = in_mask ? seg + kStride * (__ffs(in_mask) - 1) : -1;
          in_mask &= in_mask - 1;
          const int n = nn[u] >= 0 ? nn[u] : min(first, N - 1);
          p[u] = pb[n];
          s[u] = sc[(size_t)n * nc];
          t[u] = atp[n];
        }
#pragma unroll
        for (int u = 0; u < kSelBatch; ++u) {
          const unsigned kv = metric_key(align_metric(s[u], ciou_clip(g, p[u], atg, t[u]), beta));
          if (nn[u] >= 0) {
            key[nn[u]] = kv;
            lane_insert(ck, ci, kv, nn[u]);
          }
        }
      }
    }

    // the warp's first-occurrence top-k, by warp reductions alone: the
    // largest of the lanes' heads, the lowest index holding it; its owner
    // pops it (and marks it picked), refilling its list from its keys when
    // the list runs dry. A warp with fewer than k anchors ends its list with
    // key 0.
    unsigned* lk = list_key + warp * k;
    unsigned* li = list_idx + warp * k;
    for (int r = 0; r < k; ++r) {
      const unsigned mk = __reduce_max_sync(0xffffffffu, ck[0]);
      const unsigned mi = __reduce_min_sync(0xffffffffu, ck[0] == mk ? ci[0] : 0xffffffffu);
      if (lane == 0) { lk[r] = mk; li[r] = mi; }
      if (mk == 0) break;
      if (lane == (int)(mi & 31)) {
        key[mi] = 0;
#pragma unroll
        for (int p = 0; p + 1 < kLaneTop; ++p) { ck[p] = ck[p + 1]; ci[p] = ci[p + 1]; }
        ck[kLaneTop - 1] = 0;
        ci[kLaneTop - 1] = 0xffffffffu;
        if (ck[0] == 0) {
          for (int n = first; n < N; n += kStride) {
            const unsigned kv = key[n];
            if (kv) lane_insert(ck, ci, kv, n);
          }
        }
      }
    }
    __syncthreads();

    // one warp merges the lists, each in (key desc, index asc) order, under
    // the same order: the global top-k lies in their union, and they hold at
    // least k anchors between them where k <= N (the wrapper's k), so key-0
    // entries never win
    if (warp == 0) {
      int h = 0;
      unsigned hk = 0, hi = 0xffffffffu;
      if (lane < kSelWarps) { hk = list_key[lane * k]; hi = list_idx[lane * k]; }
      for (int r0 = 0; r0 < k; r0 += kSelThreads) {
        const int rn = min(k - r0, kSelThreads);
        for (int r = 0; r < rn; ++r) {
          const unsigned mk = __reduce_max_sync(0xffffffffu, hk);
          const unsigned mi = __reduce_min_sync(0xffffffffu, hk == mk ? hi : 0xffffffffu);
          // (mk 0: the lists ran out, which only k > N can make happen)
          if (lane == 0) s_pick[r] = mk != 0 ? mi : 0xffffffffu;
          if (hk == mk && hi == mi) {
            ++h;
            hk = h < k ? list_key[lane * k + h] : 0;
            hi = h < k ? list_idx[lane * k + h] : 0xffffffffu;
          }
        }
        __syncwarp();
        for (int r = lane; r < rn; r += 32) {
          const unsigned mi = s_pick[r];
          out[r0 + r] = mi != 0xffffffffu && inside(anchors[mi], g) ? (int32_t)mi : -1;
        }
        __syncwarp();
      }
    }
    __syncthreads();  // the lists and keys are rewritten by the next row
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
// A block per kNormAnchors consecutive anchors of the flat (B * N) range.
// Phase 1, a thread per anchor: its class (-1 for background) and value,
// each input read once, into shared memory. Phase 2: the block's output is
// the contiguous run of n * nc floats from a0 * nc, which starts 16-byte
// aligned for any nc (a0 * nc * 4 is a multiple of kNormAnchors * 4); the
// threads sweep it as float4, each element's anchor and class taken from its
// index, and store the ragged tail (fewer than 4 floats) one by one.
constexpr int kNormAnchors = kThreads;

__global__ void __launch_bounds__(kThreads)
tal_norm_kernel(const int64_t* __restrict__ tgt, const uint8_t* __restrict__ fg,
                const int64_t* __restrict__ label, const float* __restrict__ align,
                const float* __restrict__ pos, int N, int M, int nc, float eps,
                int64_t anchors, float* __restrict__ target_scores) {
  __shared__ int s_cls[kNormAnchors];
  __shared__ float s_val[kNormAnchors];
  const int64_t a0 = (int64_t)blockIdx.x * kNormAnchors;
  const int64_t a = a0 + threadIdx.x;
  int cls = -1;
  float v = 0.f;
  if (a < anchors && fg[a]) {
    const int64_t b = a / N;
    const float* pg = pos + (b * M + tgt[a]) * 2;
    cls = (int)label[a];
    v = __fdiv_rn(__fmul_rn(align[a], pg[1]), __fadd_rn(pg[0], eps));
  }
  s_cls[threadIdx.x] = cls;
  s_val[threadIdx.x] = v;
  __syncthreads();

  const int64_t left = anchors - a0;
  const int count = (left < kNormAnchors ? (int)left : kNormAnchors) * nc;
  float* out = target_scores + a0 * nc;
  const int nvec = count >> 2;
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    int e = q << 2;
    int an = e / nc, c = e - an * nc;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = s_cls[an] == c ? s_val[an] : 0.f;
      if (++c == nc) { c = 0; ++an; }
    }
    reinterpret_cast<float4*>(out)[q] = make_float4(r[0], r[1], r[2], r[3]);
  }
  for (int e = (nvec << 2) + threadIdx.x; e < count; e += kThreads) {
    const int an = e / nc;
    out[e] = s_cls[an] == e - an * nc ? s_val[an] : 0.f;
  }
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
  const size_t smem = ((size_t)N + 2 * kSelWarps * (size_t)k) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      tal_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the grid: what the card holds at once, and enough blocks that none
  // takes more than kSelThreads valid rows
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tal_select_kernel, kSelThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * M;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  grid = max(grid, (rows + kSelThreads - 1) / kSelThreads);
  grid = min(grid, rows);
  if (grid <= 0) return 0;
  tal_select_kernel<<<grid, kSelThreads, smem, (cudaStream_t)stream>>>(
      scores, reinterpret_cast<const float4*>(pd_boxes),
      reinterpret_cast<const float2*>(anchors), at_pd, labels,
      reinterpret_cast<const float4*>(gt_boxes), at_gt, mask_gt, B, N, M, nc, k, beta, sel);
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

// target_scores (B, N, nc) f32, 16-byte aligned, is written.
int cerberus_tal_norm(const int64_t* tgt, const uint8_t* fg, const int64_t* label,
                      const float* align, const float* pos, int B, int N, int M, int nc,
                      float eps, float* target_scores, void* stream) {
  const int64_t anchors = (int64_t)B * N;
  const unsigned blocks = (unsigned)((anchors + kNormAnchors - 1) / kNormAnchors);
  if (blocks == 0) return 0;
  tal_norm_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tgt, fg, label, align, pos, N, M, nc, eps, anchors, target_scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
