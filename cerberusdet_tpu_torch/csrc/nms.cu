// Batched greedy NMS for Hopper (sm_90a), one thread block per image.
//
// Replaces cerberusdet_tpu/ops/nms_pallas.py:_nms_kernel. Selection is
// identical to the plain loop (cerberusdet_tpu_torch/ops/nms_cuda.py:greedy_nms):
// max_det sequential steps, each taking the argmax of the live scores (ties to
// the lowest index), recording idx and valid = (score > 0), then zeroing the
// pick and every candidate whose IoU with it exceeds the threshold.
//
// What bounds it: not bytes (one image's candidates are K * 20 B) but the
// chain of dependent steps, and within a step the IoU test of every live
// candidate against the pick. The design keeps each step inside the SM:
//   * Candidates in shared memory. At entry the candidates with a positive
//     score are compacted, stably, into slots: box (float4), score and
//     original index, 22 B a slot, kCap = 10240 slots (220 KB). Slot order is
//     index order, so the lowest slot among equal scores is the lowest index.
//     Beyond kCap (K up to 16384, all positive) the slots continue in a
//     scratch buffer in global memory that the wrapper allocates (L2 holds
//     it); the first re-compaction that leaves kCap or fewer survivors moves
//     them all into shared memory.
//   * One barrier a step. Thread t owns slots t, t + 1024, ...: in one pass
//     it zeroes the pick and every slot the pick suppresses, and keeps the
//     best survivor (score, then slot). Two warp reductions (redux.sync: max
//     of the score bits, min of the slot among the maxima) and one exchange
//     of the 32 warp winners through shared memory give every warp the next
//     pick; the exchange buffers alternate by step parity, so no second
//     barrier is needed.
//   * Survivors re-compacted. When at most half the slots are live (or the
//     live set fits in shared memory again), a stable chunked compaction
//     (a ballot prefix a 1024-slot chunk) packs them to the front, so late
//     steps touch only the few slots still alive.
//   * A cheap rejection. Boxes that do not overlap the pick (zero width or
//     height of the intersection) have IoU 0, which no threshold >= 0
//     exceeds: their test ends after six operations. The class offsets of
//     class-aware NMS make that the common case.
//   * Scores <= 0. Positive scores are picked first. Once none is live, the
//     plain loop keeps picking the lowest-index slot of the largest live
//     value, which is 0 (or, before any pick, a negative score), and each
//     such pick zeroes the negative scores it overlaps. With no negative
//     score every later pick is index 0, invalid: those slots are written
//     directly. Otherwise the live state of all K candidates is rebuilt in
//     shared memory (0 for picked, suppressed and zero scores; a negative
//     score unless an earlier pick suppressed it) and the remaining steps run
//     as a plain argmax loop over it.
//
// Exactness: the IoU is computed in the plain version's operation order,
// area = (x2 - x1) * (y2 - y1), union = (area_pick + area_k - inter) + 1e-7,
// iou = inter / union, compiled with --fmad=false (no contraction into FMAs)
// and IEEE division; the threshold arrives as float32. Inputs are finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 10240;  // slots in shared memory: 22 B each
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// The bytes of n slots: boxes, then scores, then 16-bit indices.
__host__ __device__ constexpr size_t slot_bytes(int n) {
  return (size_t)round8(n) * (sizeof(float4) + sizeof(float) + sizeof(uint16_t));
}

// Slots s < cap in shared memory, the rest in the image's global scratch.
struct Slots {
  float4* box;
  float* sc;
  uint16_t* id;
  float4* gbox;
  float* gsc;
  uint16_t* gid;

  template <bool kOvf> __device__ __forceinline__ float4 get_box(int s) const {
    return (kOvf && s >= kCap) ? gbox[s - kCap] : box[s];
  }
  template <bool kOvf> __device__ __forceinline__ float get_sc(int s) const {
    return (kOvf && s >= kCap) ? gsc[s - kCap] : sc[s];
  }
  template <bool kOvf> __device__ __forceinline__ int get_id(int s) const {
    return (kOvf && s >= kCap) ? gid[s - kCap] : id[s];
  }
  template <bool kOvf> __device__ __forceinline__ void kill(int s) const {
    if (kOvf && s >= kCap) gsc[s - kCap] = 0.f; else sc[s] = 0.f;
  }
  __device__ __forceinline__ void put(int s, float4 b, float v, int i) const {
    if (s >= kCap) {
      gbox[s - kCap] = b; gsc[s - kCap] = v; gid[s - kCap] = (uint16_t)i;
    } else {
      box[s] = b; sc[s] = v; id[s] = (uint16_t)i;
    }
  }
};

struct Pick {
  unsigned bits;  // the score's bits (positive floats order as unsigned); 0: none
  int slot;
  int live;       // survivors, the pick included
};

struct Shared {
  unsigned m[2][kWarps];
  int s[2][kWarps];
  int c[2][kWarps];
  int cnt[2][kWarps];
};

// iou(p, q) > thr in the plain loop's order; parea = area of p.
__device__ __forceinline__ bool suppresses(float4 p, float parea, float4 q, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(q.z, p.z), fmaxf(q.x, p.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(q.w, p.w), fmaxf(q.y, p.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float area = __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
  const float uni = __fadd_rn(__fsub_rn(__fadd_rn(parea, area), inter), 1e-7f);
  return __fdiv_rn(inter, uni) > thr;
}

__device__ __forceinline__ float area_of(float4 p) {
  return __fmul_rn(__fsub_rn(p.z, p.x), __fsub_rn(p.w, p.y));
}

// Exclusive prefix of `flag` over the block's threads, in thread order, and
// the block's total. One barrier; cnt alternates between calls (`parity`).
__device__ __forceinline__ int block_prefix(bool flag, Shared& sh, int parity, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (lane == 0) sh.cnt[parity][warp] = __popc(ballot);
  __syncthreads();
  const int own = sh.cnt[parity][lane];
  int inc = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += v;
  }
  total = __shfl_sync(kFull, inc, 31);
  const int warp_before = __shfl_sync(kFull, inc - own, warp);
  return warp_before + __popc(ballot & ((1u << lane) - 1u));
}

// One step's pass over the slots [0, n): zero slot `kill` and, when
// have_pick, every slot that box p suppresses; then the block's best
// survivor and the survivor count, known to every thread. One barrier.
template <bool kOvf>
__device__ __forceinline__ Pick step_pass(const Slots& sl, int n, int kill, bool have_pick,
                                          float4 p, float thr, bool fast_reject, Shared& sh,
                                          int parity) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float parea = area_of(p);
  unsigned best = 0;
  int best_slot = kNone, live = 0;
  for (int s = tid; s < n; s += kThreads) {
    const float v = sl.get_sc<kOvf>(s);
    if (v == 0.f) continue;  // dead: a live slot holds its positive score
    bool dead = (s == kill);
    if (!dead && have_pick) {
      const float4 q = sl.get_box<kOvf>(s);
      // no overlap: IoU 0 (or 0 / 0), above no threshold >= 0
      const bool overlap = fminf(q.z, p.z) > fmaxf(q.x, p.x) &&
                           fminf(q.w, p.w) > fmaxf(q.y, p.y);
      if (overlap || !fast_reject) dead = suppresses(p, parea, q, thr);
    }
    if (dead) {
      sl.kill<kOvf>(s);
      continue;
    }
    ++live;
    const unsigned bits = __float_as_uint(v);
    if (bits > best) { best = bits; best_slot = s; }  // slots ascend: keeps the first
  }
  unsigned m = __reduce_max_sync(kFull, best);
  int slot = __reduce_min_sync(kFull, best == m ? best_slot : kNone);
  int count = __reduce_add_sync(kFull, live);
  if (lane == 0) {
    sh.m[parity][warp] = m;
    sh.s[parity][warp] = slot;
    sh.c[parity][warp] = count;
  }
  __syncthreads();
  // every warp reduces the 32 warp winners itself; the buffers alternate by
  // step, so a warp that runs ahead cannot overwrite what another still reads
  m = sh.m[parity][lane];
  slot = sh.s[parity][lane];
  count = sh.c[parity][lane];
  Pick pk;
  pk.bits = __reduce_max_sync(kFull, m);
  pk.slot = __reduce_min_sync(kFull, m == pk.bits ? slot : kNone);
  pk.live = __reduce_add_sync(kFull, count);
  return pk;
}

// Stable compaction of the live slots of [0, n), slot `drop` excluded, to
// the front; returns their count. A chunk of 1024 slots at a time: each
// thread reads its slot before the chunk's barrier and writes it after, to a
// position at or below it, so no slot is overwritten before it is read.
template <bool kOvf>
__device__ __forceinline__ int compact(const Slots& sl, int n, int drop, Shared& sh, int& phase) {
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int s = c0 + threadIdx.x;
    float v = 0.f;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = 0;
    bool live = false;
    if (s < n) {
      v = sl.get_sc<kOvf>(s);
      live = v != 0.f && s != drop;
      if (live) {
        b = sl.get_box<kOvf>(s);
        i = sl.get_id<kOvf>(s);
      }
    }
    int total;
    const int off = block_prefix(live, sh, phase++ & 1, total);
    if (live) sl.put(base + off, b, v, i);
    base += total;
  }
  __syncthreads();
  return base;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, int K,
           int max_det, float iou_thres, unsigned char* __restrict__ scratch,
           int32_t* __restrict__ idx_out, uint8_t* __restrict__ valid_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int tail_pick;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float4* bx = boxes + (size_t)b * K;
  const float* sc = scores + (size_t)b * K;
  int32_t* idx_row = idx_out + (size_t)b * max_det;
  uint8_t* valid_row = valid_out + (size_t)b * max_det;

  const int n_smem = min(K, kCap);
  const int n_ovf = max(K - kCap, 0);
  Slots sl;
  sl.box = reinterpret_cast<float4*>(smem);
  sl.sc = reinterpret_cast<float*>(sl.box + round8(n_smem));
  sl.id = reinterpret_cast<uint16_t*>(sl.sc + round8(n_smem));
  unsigned char* g = scratch + (size_t)b * slot_bytes(n_ovf);
  sl.gbox = reinterpret_cast<float4*>(g);
  sl.gsc = reinterpret_cast<float*>(sl.gbox + round8(n_ovf));
  sl.gid = reinterpret_cast<uint16_t*>(sl.gsc + round8(n_ovf));
  const bool fast_reject = !(iou_thres < 0.f);

  // ---- the positive candidates, compacted stably into slots
  int phase = 0, n = 0;
  bool neg = false;
  for (int k0 = 0; k0 < K; k0 += kThreads) {
    const int k = k0 + tid;
    const float v = k < K ? sc[k] : 0.f;
    neg |= v < 0.f;
    const bool live = v > 0.f;
    int total;
    const int off = block_prefix(live, sh, phase++ & 1, total);
    if (live) sl.put(n + off, bx[k], v, k);
    n += total;
  }
  const bool any_negative = __syncthreads_or(neg);

  // ---- positive picks: one pass and one barrier a step
  const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
  Pick pk = n > kCap ? step_pass<true>(sl, n, -1, false, none, iou_thres, fast_reject, sh, 0)
                     : step_pass<false>(sl, n, -1, false, none, iou_thres, fast_reject, sh, 0);
  int i = 0;
  for (; i < max_det && pk.bits != 0; ++i) {
    const bool ovf = n > kCap;
    const float4 p = ovf ? sl.get_box<true>(pk.slot) : sl.get_box<false>(pk.slot);
    if (tid == 0) {
      idx_row[i] = ovf ? sl.get_id<true>(pk.slot) : sl.get_id<false>(pk.slot);
      valid_row[i] = 1;
    }
    if (i + 1 == max_det) { ++i; break; }
    int kill = pk.slot;
    if ((n > kThreads && 2 * pk.live <= n) || (ovf && pk.live <= kCap)) {
      n = ovf ? compact<true>(sl, n, kill, sh, phase) : compact<false>(sl, n, kill, sh, phase);
      kill = -1;  // the pick was left out
    }
    const int parity = (i + 1) & 1;
    pk = n > kCap ? step_pass<true>(sl, n, kill, true, p, iou_thres, fast_reject, sh, parity)
                  : step_pass<false>(sl, n, kill, true, p, iou_thres, fast_reject, sh, parity);
  }
  if (i == max_det) return;
  if (!any_negative) {
    // every live value is 0: each later step picks index 0, invalid
    for (int r = i + tid; r < max_det; r += kThreads) {
      idx_row[r] = 0;
      valid_row[r] = 0;
    }
    return;
  }

  // ---- scores <= 0 remain: rebuild the live state of all K candidates
  __syncthreads();  // the slots are read no more; idx_row[0, i) is visible
  float* live = reinterpret_cast<float*>(smem);
  for (int k = tid; k < K; k += kThreads) {
    float v = sc[k];
    if (v < 0.f) {
      const float4 q = bx[k];
      for (int j = 0; j < i; ++j) {
        const float4 p = bx[idx_row[j]];
        if (suppresses(p, area_of(p), q, iou_thres)) { v = 0.f; break; }
      }
    } else {
      v = 0.f;  // picked, suppressed or 0
    }
    live[k] = v;
  }
  __syncthreads();
  for (; i < max_det; ++i) {
    // argmax over the live values, lowest index on ties
    float bs = __int_as_float(0xff800000);  // -inf
    int bi = K;
    for (int k = tid; k < K; k += kThreads) {
      const float v = live[k];
      if (v > bs) { bs = v; bi = k; }  // scanned in index order: keeps the first
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(kFull, bs, off);
      const int oi = __shfl_down_sync(kFull, bi, off);
      if (os > bs || (os == bs && oi < bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) { red_s[warp] = bs; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bs = red_s[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(kFull, bs, off);
        const int oi = __shfl_down_sync(kFull, bi, off);
        if (os > bs || (os == bs && oi < bi)) { bs = os; bi = oi; }
      }
      if (lane == 0) {
        if (bi >= K) bi = 0;  // no finite live value: mirror argmax's 0
        tail_pick = bi;
        idx_row[i] = bi;
        valid_row[i] = bs > 0.f;
      }
    }
    __syncthreads();
    const int pj = tail_pick;
    const float4 p = bx[pj];
    const float parea = area_of(p);
    for (int k = tid; k < K; k += kThreads) {
      if (live[k] == 0.f) continue;
      if (k == pj || suppresses(p, parea, bx[k], iou_thres)) live[k] = 0.f;
    }
    // the next step's first barrier orders these writes before any read of
    // another thread's values; red_s / red_i / tail_pick are rewritten only
    // after it
  }
}

}  // namespace

extern "C" {

// Bytes of global scratch an image needs for K candidates (0 when its
// positive candidates always fit in shared memory).
int cerberus_nms_scratch_bytes(int K) {
  return (int)slot_bytes(K > kCap ? K - kCap : 0);
}

// boxes (B, K, 4) float32 xyxy, 16-byte aligned; scores (B, K) float32;
// scratch B * cerberus_nms_scratch_bytes(K) bytes, 16-byte aligned (may be
// null when that is 0); idx (B, max_det) int32 and valid (B, max_det) uint8
// are written. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int cerberus_nms_f32(const float* boxes, const float* scores, int B, int K, int max_det,
                     float iou_thres, void* scratch, int32_t* idx, uint8_t* valid,
                     void* stream) {
  const size_t smem = slot_bytes(K < kCap ? K : kCap);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, K, max_det, iou_thres,
      static_cast<unsigned char*>(scratch), idx, valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
