// int8 convolution for Hopper (sm_90a), two kernels a quantized Conv:
//
//   quant_pack_s8   NCHW float32 / bfloat16 activations -> NHWC int8 with the
//                   channels zero-padded to Ci16 = ceil(Ci / 16) * 16; int8
//                   activations, already quantized, are packed unscaled;
//   conv_s8         the implicit-GEMM conv on the int8 tensor cores, s8 x s8
//                   summed in int32, then a float32 epilogue, NCHW out.
//
// conv_s8 replaces cerberusdet_tpu/ops/conv_int8_pallas.py:_conv_kernel (the
// implicit-GEMM 3x3 / stride 1 / SAME Pallas kernel), generalised to the conv
// shapes of the int8 serving path: k in {1, 3}, stride in {1, 2}, padding
// k / 2, groups 1, dilation 1, any Ci and Co. quant_pack_s8 is the per-tensor
// activation quantize in front of it (cerberusdet_tpu/nn/module.py:
// quantize_act, which XLA fuses into its producer on the TPU), with the
// transpose to the layout the conv gathers from.
//
// Layouts (ops/conv_int8_cuda.py holds the plain versions of both kernels):
//   xq  (B, H, W, Ci16) int8: one pixel's channels at one tap are aligned
//       16-byte chunks, zero beyond Ci;
//   w   (Co, k, k, Ci16) int8, prepared once at quantize time
//       (ops/conv_int8_cuda.py:pack_weight): the reduction index is
//       K = (dy, dx, ci), contiguous for each output channel (K-major);
//   out (B, Co, Ho, Wo) int32 | float32 | bfloat16 | int8.
//
// Arithmetic, in the plain versions' order:
//   quant:  q = clip(rint(x * inv), -127, 127), inv = 1 / s_x rounded to
//           float32 (the port's 1.0 / s_x and JAX's float32 reciprocal);
//           q = x for int8 x (JAX's quantize_act passes int8 through);
//   conv:   acc = sum over (dy, dx, ci) of xq * w, exact in int32 (|acc| <=
//           9 * Ci * 127^2 < 2^31 for Ci < 14,000), so any order gives it;
//           raw:  out = acc;
//           else: y = (float)acc * (s_x * s_w[c]); y = y + bias[c];
//                 y = y / (1 + expf(-y)) when act (torch's CUDA silu);
//                 float32: y; bfloat16: y rounded to nearest even;
//                 int8: clip(rint(y * inv_qs), -127, 127).
// Built with --fmad=false and the __f*_rn intrinsics, so no multiply-add is
// contracted: both kernels give the plain versions' values bit for bit.
//
// What bounds them on this card, and what the design does about it:
// - conv_s8 is bound by operations (2 * MACs against the 1,979 TOP/s of the
//   int8 tensor cores; its bytes are 1-3% of that at the path's shapes). The
//   sums run on the tensor cores as wgmma.mma_async m64nNk32 s8 (N = 160 or
//   80) with both operands read from shared memory through descriptors. A
//   block of 2 warpgroups computes a BM x BN output tile (BM 128: a
//   warpgroup a 64-row half; BM 64 where 128 would leave SMs idle, then the
//   first warpgroup alone, since integer wgmma has no n40; BN 160 where Co
//   is a multiple of 160, else 80: the flagship's Co are all multiples of
//   80). The reduction advances 64 bytes a stage through a ring of 4 stages
//   in dynamic shared memory: cp.async.cg gathers the A tile in 16-byte
//   chunks (16 channels of one pixel at one tap; a zero fill for padding
//   pixels, the ragged pixel edge and the K tail) and the B tile from the
//   packed weights, 3 stages ahead of the MMAs. Rows are 64 bytes with the
//   16-byte chunks XOR-swizzled by (row / 2) % 4: the descriptors' 64-byte
//   swizzle mode, so the tensor cores read without bank conflicts. The
//   epilogue goes through shared memory (a padded BN x BM tile) so that the
//   NCHW store is coalesced along pixels. wgmma reads its operands from
//   shared memory, so no fragment registers are held: 128 x 160 tiles fit 2
//   blocks an SM without spilling, where mma.sync m16n8k32 fed by ldmatrix
//   spilled and was slower (PERF.md, Findings). TMA, a deeper asynchronous
//   pipeline and a persistent grid are later work.
// - quant_pack_s8 is bound by bytes (read the activations once, write a
//   quarter or half of them as int8). A block transposes a 64-pixel x
//   64-channel tile through shared memory, so the read runs along W and the
//   write along C, both coalesced; the reciprocal is taken on the card from
//   s_x's pointer (no host sync, no extra launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum Mode { kRaw = 0, kF32 = 1, kBF16 = 2, kS8 = 3 };

__device__ __forceinline__ int8_t to_s8(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// ------------------------------------------------------------ quant_pack_s8

constexpr int kQP = 64;            // pixels a block
constexpr int kQC = 64;            // channels a block
constexpr int kQThreads = 256;
constexpr int kQRow = kQC + 4;     // bytes of a pixel's row in shared memory

__device__ __forceinline__ int8_t quant(const float* p, float inv) {
  return to_s8(__fmul_rn(*p, inv));
}
__device__ __forceinline__ int8_t quant(const __nv_bfloat16* p, float inv) {
  return to_s8(__fmul_rn(__bfloat162float(*p), inv));
}
// int8 input is already quantized (with this s_x): copied, not rescaled
__device__ __forceinline__ int8_t quant(const int8_t* p, float) { return *p; }

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quant_pack_s8_kernel(const T* __restrict__ x, const float* __restrict__ s_x, int C, int HW,
                     long long sb, long long sc, long long sp, int C16,
                     int8_t* __restrict__ out) {
  __shared__ __align__(16) int8_t tile[kQP * kQRow];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kQP;
  const int c0 = blockIdx.y * kQC;
  const int b = blockIdx.z;
  const float inv = __fdiv_rn(1.f, *s_x);

  // read: a warp takes 32 neighbouring pixels of one channel; zero past Ci
  const int lp = tid % kQP;
  const int p = p0 + lp;
  for (int i = tid / kQP; i < kQC; i += kQThreads / kQP) {
    const int c = c0 + i;
    int8_t q = 0;
    if (p < HW && c < C) q = quant(x + b * sb + c * sc + p * sp, inv);
    tile[lp * kQRow + i] = q;
  }
  __syncthreads();
  // write: 16 threads a pixel, 4 channels (one 32-bit word) each
  const int wc = tid % (kQC / 4);
  const int c = c0 + 4 * wc;
  if (c >= C16) return;
  for (int j = tid / (kQC / 4); j < kQP; j += kQThreads / (kQC / 4)) {
    if (p0 + j < HW)
      *reinterpret_cast<int32_t*>(out + ((size_t)b * HW + p0 + j) * C16 + c) =
          *reinterpret_cast<const int32_t*>(tile + j * kQRow + 4 * wc);
  }
}

// ------------------------------------------------------------------ conv_s8

constexpr int kBK = 64;          // bytes of the reduction a stage: 4 chunks of 16
constexpr int kStages = 4;       // the ring: loads run 3 stages ahead of the MMAs
constexpr int kThreads = 256;    // 8 warps: 2 warpgroups
constexpr int kLoadRows = kThreads / 4;  // rows the block's threads load at once

template <int BM, int BN>
struct ConvTile {
  static constexpr int kALoads = BM * 4 / kThreads;
  static constexpr int kBLoads = (BN * 4 + kThreads - 1) / kThreads;
  static constexpr int kStageBytes = (BM + BN) * kBK;
  static constexpr int kLdo = BM + 4;   // int32 words of an output channel's row in the epilogue
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kOutBytes = BN * kLdo * 4;
  // + 512: the tiles start 512-byte aligned (the descriptors' swizzle repeats every 512)
  static constexpr int kSmem = (kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes) + 512;
  static_assert(BM % 64 == 0 && BN % 8 == 0, "tile");
};

// byte offset of 16-byte chunk c of row r in a tile of 64-byte rows: the
// chunks are XOR-swizzled by (row / 2) % 4, the 64-byte swizzle of a wgmma
// descriptor (and 8 rows' chunk c lie in 8 distinct bank groups)
__device__ __forceinline__ int swz(int r, int c) { return r * kBK + ((c ^ ((r >> 1) & 3)) << 4); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma: a warpgroup's m64nNk32 product of A and B read
// from shared memory through matrix descriptors, accumulated into its
// registers. Both tiles are K-major rows of 64 bytes, 16-byte chunks
// XOR-swizzled by (row / 2) % 4 (swz): the 64-byte swizzle mode of a
// descriptor, whose 8-row groups lie 512 bytes apart. The tiles start at
// multiples of 512 bytes; a k32 step is the start address plus 32 bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the sums across a wgmma
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<160> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void mma(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
        : "l"(a), "l"(b), "r"(1));
  }
};


template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ s_x, const float* __restrict__ s_w,
               const float* __restrict__ bias, int H, int W, int C16, int Co, int Ho, int Wo,
               int ks, int stride, int pad, int M, int act, int mode, float inv_qs,
               void* __restrict__ out) {
  using T = ConvTile<BM, BN>;
  extern __shared__ __align__(128) int8_t smem_raw[];
  int8_t* smem = smem_raw + ((512 - (smem_u32(smem_raw) & 511)) & 511);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;  // the warp within its warpgroup
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = ks * ks * C16;
  const int KT = (K + kBK - 1) / kBK;
  const int HoWo = Ho * Wo;

  // loaders: this thread's 16-byte chunk is chunk `lc` of rows lr + kLoadRows i
  const int lc = tid & 3;
  const int lr = tid >> 2;
  int a_ih0[T::kALoads], a_iw0[T::kALoads], a_img[T::kALoads];
#pragma unroll
  for (int i = 0; i < T::kALoads; ++i) {
    const int m = m0 + lr + kLoadRows * i;
    a_img[i] = -1;
    a_ih0[i] = a_iw0[i] = 0;
    if (m < M) {
      const int b = m / HoWo;
      const int r = m - b * HoWo;
      const int oh = r / Wo;
      a_ih0[i] = oh * stride - pad;
      a_iw0[i] = (r - oh * Wo) * stride - pad;
      a_img[i] = b * H * W;  // the image's first pixel
    }
  }
  // (dy, dx, channel) of this thread's chunk in the stage loaded next: the
  // reduction index is K = (dy, dx, ci), the weights' order
  int a_dy = 0, a_dx = 0, a_ci = lc * 16;
  auto advance = [&](int bytes) {
    a_ci += bytes;
    while (a_ci >= C16) {
      a_ci -= C16;
      if (++a_dx == ks) { a_dx = 0; ++a_dy; }
    }
  };
  advance(0);

  auto load_stage = [&](int slot) {
    int8_t* sa = smem + slot * T::kStageBytes;
    int8_t* sb = sa + BM * kBK;
    const bool kvalid = a_dy < ks;
    const int kb = (a_dy * ks + a_dx) * C16 + a_ci;  // offset in a weight row
#pragma unroll
    for (int i = 0; i < T::kALoads; ++i) {
      const int ih = a_ih0[i] + a_dy;
      const int iw = a_iw0[i] + a_dx;
      const bool ok = kvalid && a_img[i] >= 0 && (unsigned)ih < (unsigned)H &&
                      (unsigned)iw < (unsigned)W;
      const int8_t* src = ok ? x + (size_t)(a_img[i] + ih * W + iw) * C16 + a_ci : x;
      cp_async16(smem_u32(sa + swz(lr + kLoadRows * i, lc)), src, ok);
    }
#pragma unroll
    for (int i = 0; i < T::kBLoads; ++i) {
      const int n = lr + kLoadRows * i;
      if (n < BN) {
        const bool ok = kvalid && n0 + n < Co;
        const int8_t* src = ok ? w + (size_t)(n0 + n) * K + kb : w;
        cp_async16(smem_u32(sb + swz(n, lc)), src, ok);
      }
    }
    advance(kBK);
  };

  // this thread's sums, 4 for each n8 block j of its warpgroup's m64 x BN
  // product (a 64-row tile is the first warpgroup's alone, since integer
  // wgmma has no n40 to split 80 columns)
  constexpr int kAcc = BN / 2;
  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  const int wg = warp >> 2;  // warpgroup
  const int a_wg = BM == 128 ? 64 * wg : 0;  // its rows of the tile
  const bool wg_mma = BM == 128 || wg == 0;  // whether it computes

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();  // the landed bytes, to wgmma's reads
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages);
    cp_async_commit();

    if (wg_mma) {
      const int8_t* sa = smem + (kt % kStages) * T::kStageBytes;
      const int8_t* sb = sa + BM * kBK;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
        Wgmma<BN>::mma(acc, gmma_desc(smem_u32(sa + a_wg * kBK) + 32 * k2),
                       gmma_desc(smem_u32(sb) + 32 * k2));
      wgmma_commit_wait();
      pin(acc);  // the sums are read only after the wait
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue into shared memory as [channel][pixel] words: the int32 sums,
  // or the float32 y
  int32_t* so = reinterpret_cast<int32_t*>(smem);
  const float sx = *s_x;
  const int g = lane >> 2;
  const int t = lane & 3;
  if (wg_mma) {
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        // element (h, jj) of n8 block j: row 16 wm + g + 8 h of the
        // warpgroup's 64, column 8 j + 2 t + jj
        const int nl = 8 * j + 2 * t + jj;
        const int n = n0 + nl;
        float scale = 0.f, bn = 0.f;
        if (mode != kRaw && n < Co) {
          scale = __fmul_rn(sx, s_w[n]);
          bn = bias[n];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ml = a_wg + 16 * wm + g + 8 * h;
          const int v = acc[4 * j + 2 * h + jj];
          if (mode == kRaw) {
            so[nl * T::kLdo + ml] = v;
          } else {
            float y = __fadd_rn(__fmul_rn(__int2float_rn(v), scale), bn);
            if (act) y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
            so[nl * T::kLdo + ml] = __float_as_int(y);
          }
        }
      }
    }
  }
  __syncthreads();

  // store: a thread a pixel, threads side by side on neighbouring pixels
  const int ml = tid % BM;
  const int m = m0 + ml;
  if (m >= M) return;
  const int b = m / HoWo;
  const int r = m - b * HoWo;
  for (int nl = tid / BM; nl < BN && n0 + nl < Co; nl += kThreads / BM) {
    const size_t o = ((size_t)b * Co + n0 + nl) * HoWo + r;
    const int32_t v = so[nl * T::kLdo + ml];
    if (mode == kRaw) {
      static_cast<int32_t*>(out)[o] = v;
    } else if (mode == kF32) {
      static_cast<float*>(out)[o] = __int_as_float(v);
    } else if (mode == kBF16) {
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(__int_as_float(v));
    } else {
      static_cast<int8_t*>(out)[o] = to_s8(__fmul_rn(__int_as_float(v), inv_qs));
    }
  }
}

constexpr int kMaxDevices = 64;

template <int BM, int BN>
int launch_conv(const int8_t* x, const int8_t* w, const float* s_x, const float* s_w,
                const float* bias, int B, int H, int W, int C16, int Co, int ks, int stride,
                int pad, int act, int mode, float inv_qs, void* out, cudaStream_t s) {
  using T = ConvTile<BM, BN>;
  const int Ho = (H + 2 * pad - ks) / stride + 1;
  const int Wo = (W + 2 * pad - ks) / stride + 1;
  const int M = B * Ho * Wo;
  // the dynamic shared memory above 48 KB, set once for each device this
  // tile runs on (setting it again is harmless, so a race needs no lock)
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(conv_s8_kernel<BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return (int)e;
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const dim3 grid((M + BM - 1) / BM, (Co + BN - 1) / BN);
  conv_s8_kernel<BM, BN><<<grid, kThreads, T::kSmem, s>>>(
      x, w, s_x, s_w, bias, H, W, C16, Co, Ho, Wo, ks, stride, pad, M, act, mode, inv_qs, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, H, W) of float32 (dtype 0), bfloat16 (dtype 1) or int8 (dtype 2,
// already quantized: copied unscaled) with images sb,
// channels sc and the pixels of an (H, W) plane sp elements apart (sp 1 for
// NCHW, C for a channels-last view); s_x a float32
// scalar on the card; out (B, H, W, C16) int8 with C16 a multiple of 16 and
// >= C. Launches on `stream` and returns cudaGetLastError() (0 on success);
// 1 (cudaErrorInvalidValue) for a dtype it does not know.
int cerberus_quant_pack_s8(const void* x, int dtype, const float* s_x, int B, int C, int H,
                           int W, long long sb, long long sc, long long sp, int C16,
                           int8_t* out,
                           void* stream) {
  const int HW = H * W;
  if (B <= 0 || HW <= 0) return 0;
  const dim3 grid((HW + kQP - 1) / kQP, (C16 + kQC - 1) / kQC, B);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    quant_pack_s8_kernel<float><<<grid, kQThreads, 0, s>>>(
        static_cast<const float*>(x), s_x, C, HW, sb, sc, sp, C16, out);
  } else if (dtype == 1) {
    quant_pack_s8_kernel<__nv_bfloat16><<<grid, kQThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), s_x, C, HW, sb, sc, sp, C16, out);
  } else if (dtype == 2) {
    quant_pack_s8_kernel<int8_t><<<grid, kQThreads, 0, s>>>(
        static_cast<const int8_t*>(x), s_x, C, HW, sb, sc, sp, C16, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (B, H, W, C16) int8 and w (Co, ks, ks, C16) int8, both 16-byte aligned,
// C16 a multiple of 16; s_x a float32 scalar, s_w and bias (Co,) float32, all
// on the card; out (B, Co, Ho, Wo) of the type `mode` names (0 int32, 1
// float32, 2 bfloat16, 3 int8) with Ho = (H + 2 pad - ks) / stride + 1, Wo
// likewise. (bm, bn) is the block tile: (128 | 64, 160 | 80). The caller
// checks that B * Ho * Wo fits an int. Launches on `stream` and returns
// cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue) for a mode or
// tile it does not know.
int cerberus_conv_s8(const int8_t* x, const int8_t* w, const float* s_x, const float* s_w,
                     const float* bias, int B, int H, int W, int C16, int Co, int ks,
                     int stride, int pad, int act, int mode, float inv_qs, int bm, int bn,
                     void* out, void* stream) {
  if (mode < kRaw || mode > kS8) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Co <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CERBERUS_CONV_S8_LAUNCH(BM_, BN_)                                                      \
  if (bm == BM_ && bn == BN_)                                                                  \
    return launch_conv<BM_, BN_>(x, w, s_x, s_w, bias, B, H, W, C16, Co, ks, stride, pad, act, \
                                 mode, inv_qs, out, s);
  CERBERUS_CONV_S8_LAUNCH(128, 160)
  CERBERUS_CONV_S8_LAUNCH(128, 80)
  CERBERUS_CONV_S8_LAUNCH(64, 160)
  CERBERUS_CONV_S8_LAUNCH(64, 80)
#undef CERBERUS_CONV_S8_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
