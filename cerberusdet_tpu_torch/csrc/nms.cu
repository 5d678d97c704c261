// Batched greedy NMS for Hopper (sm_90a), one thread block per image.
//
// Replaces cerberusdet_tpu/ops/nms_pallas.py:_nms_kernel. Selection is
// identical to the plain loop (cerberusdet_tpu_torch/ops/nms_cuda.py:greedy_nms):
// max_det sequential steps, each taking the argmax of the live scores (ties to
// the lowest index), recording idx and valid = (score > 0), then zeroing the
// pick and every candidate whose IoU with it exceeds the threshold.
//
// What bounds it: not bytes (one image's candidates are K * 20 B, read from L2
// on every step) but the chain of max_det dependent steps, each a block-wide
// argmax reduction plus two barriers. The design keeps each step short:
//   * live scores stay in dynamic shared memory (K * 4 B <= 64 KB); boxes are
//     read from global memory, where L2 holds them across steps;
//   * thread t owns candidates t, t + blockDim, ...: the argmax is a local scan
//     in index order, a warp shuffle and one pass over the per-warp winners;
//   * a candidate whose score is already 0 is not read again (zeroing it is a
//     no-op), so late steps touch only the survivors;
//   * once the best live score is 0 and no score was negative, every later
//     step would pick index 0 with valid = false: those slots are written
//     directly and the loop ends.
//
// Exactness: the IoU is computed in the plain version's operation order,
// area = (x2 - x1) * (y2 - y1), union = (area_pick + area_k - inter) + 1e-7,
// iou = inter / union, compiled with --fmad=false (no contraction into FMAs)
// and IEEE division; the threshold arrives as float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Pick {
  float score;
  int idx;
};

// (a better than b): higher score, ties to the lower index.
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           int K, int max_det, float iou_thres, int32_t* __restrict__ idx_out,
           uint8_t* __restrict__ valid_out) {
  extern __shared__ float live[];
  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ Pick pick;
  __shared__ float4 pick_box;
  __shared__ int any_negative;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float4* bx = boxes + (size_t)b * K;
  const float* sc = scores + (size_t)b * K;
  int32_t* idx_row = idx_out + (size_t)b * max_det;
  uint8_t* valid_row = valid_out + (size_t)b * max_det;

  if (tid == 0) any_negative = 0;
  __syncthreads();
  int neg = 0;
  for (int k = tid; k < K; k += kThreads) {
    float s = sc[k];
    live[k] = s;
    neg |= (s < 0.f);
  }
  if (neg) any_negative = 1;
  __syncthreads();
  const bool nonneg = (any_negative == 0);

  for (int i = 0; i < max_det; ++i) {
    // ---- argmax over live scores, lowest index on ties
    float bs = __int_as_float(0xff800000);  // -inf
    int bi = K;
    for (int k = tid; k < K; k += kThreads) {
      float s = live[k];
      if (s > bs) { bs = s; bi = k; }  // scanned in index order: keeps the first
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float os = __shfl_down_sync(0xffffffffu, bs, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) { red_s[warp] = bs; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bs = red_s[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        float os = __shfl_down_sync(0xffffffffu, bs, off);
        int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
      }
      if (lane == 0) {
        if (bi >= K) bi = 0;  // every live score is -inf or NaN: mirror argmax's 0
        pick.score = bs;
        pick.idx = bi;
        pick_box = bx[bi];
        idx_row[i] = bi;
        valid_row[i] = (bs > 0.f);
      }
    }
    __syncthreads();
    const float ps = pick.score;
    const int pj = pick.idx;
    if (ps == 0.f && nonneg) {
      // all live scores are 0: every later step picks index 0, invalid
      for (int r = i + 1 + tid; r < max_det; r += kThreads) {
        idx_row[r] = 0;
        valid_row[r] = 0;
      }
      break;
    }
    // ---- suppress the pick and every live candidate overlapping it
    const float4 p = pick_box;
    const float parea = __fmul_rn(__fsub_rn(p.z, p.x), __fsub_rn(p.w, p.y));
    for (int k = tid; k < K; k += kThreads) {
      if (live[k] == 0.f) continue;
      if (k == pj) { live[k] = 0.f; continue; }
      const float4 q = bx[k];
      const float iw = fmaxf(__fsub_rn(fminf(q.z, p.z), fmaxf(q.x, p.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(q.w, p.w), fmaxf(q.y, p.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float area = __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
      const float uni = __fadd_rn(__fsub_rn(__fadd_rn(parea, area), inter), 1e-7f);
      const float iou = __fdiv_rn(inter, uni);
      if (iou > iou_thres) live[k] = 0.f;
    }
    // the next step's first barrier orders these writes before any read of
    // another thread's state; each thread reads back only its own `live`
  }
}

}  // namespace

extern "C" {

// boxes (B, K, 4) float32 xyxy, 16-byte aligned; scores (B, K) float32;
// idx (B, max_det) int32 and valid (B, max_det) uint8 are written.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int cerberus_nms_f32(const float* boxes, const float* scores, int B, int K,
                     int max_det, float iou_thres, int32_t* idx, uint8_t* valid,
                     void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, K, max_det, iou_thres, idx,
      valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
