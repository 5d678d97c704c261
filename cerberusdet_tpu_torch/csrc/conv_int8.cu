// int8 convolution for Hopper (sm_90a): s8 x s8 products summed in int32,
// then a float32 epilogue, one kernel for every quantized Conv of the port.
//
// Replaces cerberusdet_tpu/ops/conv_int8_pallas.py:_conv_kernel (the
// implicit-GEMM 3x3 / stride 1 / SAME Pallas kernel), generalised to the conv
// shapes of the int8 serving path: k in {1, 3}, stride in {1, 2}, padding
// k / 2, groups 1, dilation 1, any Ci and Co.
//
// Layouts:
//   x   (B, Ci, H, W) int8, the port's NCHW activations quantized per tensor;
//   w   (k, k, C4, Co, 4) int8 with C4 = ceil(Ci / 4): the HWIO weights with
//       four input channels packed into one 32-bit word (zero beyond Ci),
//       prepared once at quantize time (ops/conv_int8_cuda.py:pack_weight);
//   out (B, Co, Ho, Wo) int32 | float32 | bfloat16 | int8.
//
// Arithmetic, in the plain version's order (ops/conv_int8_cuda.py:conv_s8_plain):
//   acc = sum over (dy, dx, ci) of x * w, exact in int32 (|acc| <= 9 * Ci *
//         127^2 < 2^31 for Ci < 14,000), four products a __dp4a;
//   raw:  out = acc;
//   else: y = (float)acc * scale[c]; y = y + bias[c];
//         y = y / (1 + expf(-y)) when act (torch's CUDA silu);
//         float32: y; bfloat16: y rounded to nearest even;
//         int8: clip(rint(y * inv_qs), -127, 127).
// Built with --fmad=false and the __f*_rn intrinsics, so no multiply-add is
// contracted: the epilogue gives the plain version's values bit for bit.
//
// What bounds it on this card: at the path's shapes the work is 2 * MACs
// operations against int8 tensor-core peak, far above its bytes; this first
// kernel does not use the tensor cores at all. It is the simple right
// version: a block computes a 64-pixel x 64-channel output tile, staging
// 8 words (32 input channels of one tap) of the input patch and the weights
// in shared memory per step; each thread keeps a 4 x 4 tile of int32 sums
// and does 16 __dp4a per word. The pixel index runs over B * Ho * Wo, so
// tiles cross rows and images and the ragged edge is masked. Tensor cores
// (mma.sync s8 / wgmma), TMA and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTP = 64;       // output pixels a block
constexpr int kTC = 64;       // output channels a block
constexpr int kKC = 8;        // 32-bit words of the reduction a step
constexpr int kThreads = 256;
constexpr int kLoadRows = kThreads / kTP;   // words a thread loads: kKC / kLoadRows

enum Mode { kRaw = 0, kF32 = 1, kBF16 = 2, kS8 = 3 };

template <int MODE>
__global__ void __launch_bounds__(kThreads)
conv_s8_kernel(const int8_t* __restrict__ x, const int32_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               int B, int Ci, int H, int W, int Co, int Ho, int Wo, int ks,
               int stride, int pad, int act, float inv_qs, void* __restrict__ out) {
  __shared__ int32_t xs[kKC][kTP];
  __shared__ int32_t ws[kKC][kTC];

  const int tid = threadIdx.x;
  const int C4 = (Ci + 3) >> 2;
  const int K = ks * ks * C4;  // words of the reduction
  const int HoWo = Ho * Wo;
  const int P = B * HoWo;
  const int p0 = blockIdx.x * kTP;
  const int c0 = blockIdx.y * kTC;
  const size_t plane = (size_t)H * W;

  // the output pixel whose input patch this thread stages
  const int lp = tid % kTP;
  const int lk = tid / kTP;
  const int pg = p0 + lp;
  const bool pvalid = pg < P;
  int ih0 = 0, iw0 = 0;
  const int8_t* xb = x;
  if (pvalid) {
    const int b = pg / HoWo;
    const int r = pg - b * HoWo;
    const int oh = r / Wo;
    ih0 = oh * stride - pad;
    iw0 = (r - oh * Wo) * stride - pad;
    xb = x + (size_t)b * Ci * plane;
  }
  // the output channel whose weights this thread stages
  const int wc = tid % kTC;
  const bool cvalid = c0 + wc < Co;

  // this thread's 4 x 4 output tile: pixels tp + 16 i, channels tc + 16 j
  const int tp = tid % 16;
  const int tc = tid / 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kKC) {
#pragma unroll
    for (int r = 0; r < kKC / kLoadRows; ++r) {
      const int kk = lk + kLoadRows * r;
      const int k = k0 + kk;
      int32_t v = 0;
      if (pvalid && k < K) {
        const int tap = k / C4;
        const int c4 = k - tap * C4;
        const int dy = tap / ks;
        const int ih = ih0 + dy;
        const int iw = iw0 + (tap - dy * ks);
        if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
          const int ci = 4 * c4;
          const int8_t* src = xb + (size_t)ci * plane + (size_t)ih * W + iw;
          uint32_t u = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ci + j < Ci) u |= (uint32_t)(uint8_t)src[j * plane] << (8 * j);
          v = (int32_t)u;
        }
      }
      xs[kk][lp] = v;
      ws[kk][wc] = (cvalid && k < K) ? w[(size_t)k * Co + c0 + wc] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      int32_t a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][tp + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = ws[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + tp + 16 * i;
    if (p >= P) continue;
    const int b = p / HoWo;
    const int r = p - b * HoWo;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc + 16 * j;
      if (c >= Co) continue;
      const size_t o = ((size_t)b * Co + c) * HoWo + r;
      if (MODE == kRaw) {
        static_cast<int32_t*>(out)[o] = acc[i][j];
        continue;
      }
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[c]), bias[c]);
      if (act) y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
      if (MODE == kF32) {
        static_cast<float*>(out)[o] = y;
      } else if (MODE == kBF16) {
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
      } else {
        const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv_qs)), -127.f), 127.f);
        static_cast<int8_t*>(out)[o] = (int8_t)(int)q;
      }
    }
  }
}

}  // namespace

extern "C" {

// x (B, Ci, H, W) int8; w (ks, ks, ceil(Ci/4), Co, 4) int8 read as int32
// words, 4-byte aligned; scale, bias (Co,) float32; out (B, Co, Ho, Wo) of
// the type `mode` names (0 int32, 1 float32, 2 bfloat16, 3 int8) with
// Ho = (H + 2 pad - ks) / stride + 1, Wo likewise. The caller checks that
// B * Ho * Wo fits an int. Launches on `stream` and returns
// cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue) for a mode
// it does not know.
int cerberus_conv_s8(const int8_t* x, const int8_t* w, const float* scale,
                     const float* bias, int B, int Ci, int H, int W, int Co, int ks,
                     int stride, int pad, int act, int mode, float inv_qs, void* out,
                     void* stream) {
  const int Ho = (H + 2 * pad - ks) / stride + 1;
  const int Wo = (W + 2 * pad - ks) / stride + 1;
  const int P = B * Ho * Wo;
  if (P <= 0 || Co <= 0) return 0;
  const dim3 grid((P + kTP - 1) / kTP, (Co + kTC - 1) / kTC);
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* w32 = reinterpret_cast<const int32_t*>(w);
#define CERBERUS_CONV_S8_LAUNCH(M)                                                      \
  conv_s8_kernel<M><<<grid, kThreads, 0, s>>>(x, w32, scale, bias, B, Ci, H, W, Co, Ho, \
                                              Wo, ks, stride, pad, act, inv_qs, out)
  switch (mode) {
    case kRaw: CERBERUS_CONV_S8_LAUNCH(kRaw); break;
    case kF32: CERBERUS_CONV_S8_LAUNCH(kF32); break;
    case kBF16: CERBERUS_CONV_S8_LAUNCH(kBF16); break;
    case kS8: CERBERUS_CONV_S8_LAUNCH(kS8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CERBERUS_CONV_S8_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
