// int8 convolution for Hopper (sm_90a), two kernels a quantized Conv:
//
//   quant_pack_s8   NCHW float32 / bfloat16 activations -> NHWC int8 with the
//                   channels zero-padded to Ci16 = ceil(Ci / 16) * 16; int8
//                   activations, already quantized, are packed unscaled;
//   conv_s8         the implicit-GEMM conv on the int8 tensor cores, s8 x s8
//                   summed in int32, then a float32 epilogue, NCHW out;
// and quant_s8, the per-tensor quantize of an NCHW tensor into int8 NCHW (a
// channel slice of a concat buffer), for the activations that int8 carries
// between the blocks and no conv epilogue quantizes (quant/ptq.py).
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
//                 int8: clip(rint(y * inv_qs), -127, 127) (the Pallas
//                 kernel's q_out, cerberusdet_tpu/ops/conv_int8_pallas.py);
//                 int8 of bf16: clip(rint(float(bf16(y)) * inv_qs), -127,
//                 127), the requantize of the value a bf16 graph hands on
//                 (JAX's Conv casts to the compute dtype, then the block's
//                 __q_out__ quantizes: cerberusdet_tpu/models/cerberus.py).
//           inv_qs = 1 / q_s rounded to float32, q_s read on the card from
//           the scale's pointer (no host value in a capture).
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
// - quant_pack_s8 is bound by bytes: read the activations once (2 B an
//   element in bf16), write one byte a pixel and Ci16 channel. So every
//   byte moves in 16-byte accesses and the transpose costs no memory
//   traffic: a lane loads 16-byte runs along the plane (8 bf16, 4 float32
//   or 16 int8 pixels) of each of 16 channels, 16 loads in flight before
//   the first use, and transposes them in registers with byte permutes
//   into one 16-byte store a pixel (a whole chunk of 16 channels, the unit
//   conv_s8 gathers). The threads take the runs so that neighbouring lanes
//   read 32 pixels of a plane and write a pixel's neighbouring chunks side
//   by side: whole sectors on both sides, and no lane idles at any Ci. The
//   rint is an addition (no conversion instruction) and the reciprocal is
//   taken on the card from s_x's pointer once per thread (no host sync, no
//   extra launch). The grid is what the card holds at once (one block an
//   SM where the input outgrows L2), its blocks looping over the runs. A
//   plane whose base or length is not a multiple of 16 bytes (a
//   letterboxed 15 x 20 map, a channel slice at an odd offset) and the
//   ragged end of every plane load element by element; a channels-last
//   view takes a kernel of its own (a thread per pixel and chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum Mode { kRaw = 0, kF32 = 1, kBF16 = 2, kS8 = 3, kS8BF16 = 4 };

constexpr int kMaxDevices = 64;

__device__ __forceinline__ int8_t to_s8(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// ------------------------------------------------------------ quant_pack_s8

constexpr int kQThreads = 256;        // 8 warps; a warp takes one item at a time
constexpr float kRound = 12582912.f;  // 1.5 * 2^23 (see code)

// raw bits of one element of T, for the scalar edge path
template <typename T> struct Raw;
template <> struct Raw<float> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };
template <> struct Raw<int8_t> { using type = uint8_t; };

// The int8 code of v as the low byte of the returned word:
// clip(rint(v * inv), -127, 127). The clip comes first (rint keeps the
// integers -127 and 127 in place, so the order does not matter) and the
// rint is the addition of 1.5 * 2^23, which rounds half to even and leaves
// the integer, two's complement, in the low mantissa bits: no conversion
// instruction (F2I runs at a quarter of the FP32 rate).
__device__ __forceinline__ uint32_t code(float v, float inv) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f), kRound));
}

// A word holding the code of element j of a 16-byte run of T (float: 4
// elements, bfloat16: 8, int8: 16, copied unscaled): in byte j % 4 for
// int8, in byte 0 otherwise (pack16 picks it out).
template <typename T>
__device__ __forceinline__ uint32_t code_word(const uint4& r, int j, float inv);
template <>
__device__ __forceinline__ uint32_t code_word<float>(const uint4& r, int j, float inv) {
  return code(__uint_as_float((&r.x)[j]), inv);
}
template <>
__device__ __forceinline__ uint32_t code_word<__nv_bfloat16>(const uint4& r, int j, float inv) {
  const uint32_t w = (&r.x)[j >> 1];
  return code(__uint_as_float(j & 1 ? w & 0xffff0000u : w << 16), inv);
}
template <>
__device__ __forceinline__ uint32_t code_word<int8_t>(const uint4& r, int j, float) {
  return (&r.x)[j >> 2];
}
// 16 bytes of codes, channel i in byte i, from the code words w[i] of
// element j (its code in byte j % 4 for int8, byte 0 otherwise)
template <typename T>
__device__ __forceinline__ uint4 pack16(const uint32_t (&w)[16], int j) {
  const int s = sizeof(T) == 1 ? j & 3 : 0;
  const uint32_t pair = (uint32_t)(s | (4 + s) << 4);  // byte s of a, then byte s of b
  uint32_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = __byte_perm(__byte_perm(w[4 * q], w[4 * q + 1], pair),
                       __byte_perm(w[4 * q + 2], w[4 * q + 3], pair), 0x5410);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The V = 16 / sizeof(T) elements p[0, V) of one plane as 16 bytes, zero at
// and past n: one 16-byte load where the run is aligned and whole (vec),
// else element by element (a plane of a misaligned length or base, and
// the ragged end of every plane).
template <typename T>
__device__ __forceinline__ uint4 load_run(const T* p, int n, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  using R = typename Raw<T>::type;
  union { uint4 u; R e[16 / sizeof(T)]; } r;
  r.u = make_uint4(0, 0, 0, 0);
  const R* q = reinterpret_cast<const R*>(p);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j)
    if (j < n) r.e[j] = q[j];
  return r.u;
}

// NCHW planes (pixels at stride 1) -> (B, HW, C16) int8, in register tiles.
// A thread takes a run of V pixels (one 16-byte load) of each of the 16
// channels of one chunk: 16 independent loads in flight, a transpose in
// registers with byte permutes, then one 16-byte store a pixel. The runs go
// to the threads in the order (image, group of 32 pixels, chunk, run in the
// group): the LP = 32 / V neighbouring lanes of a group read 32 pixels of a
// plane (a whole sector or more), and the 32 / LP lanes of a run in a warp
// write neighbouring chunks of each pixel side by side (64 to 256 bytes),
// so both sides move whole 32-byte sectors, and no lane idles at any Ci.
// (A warp that covered one chunk's plane alone stored 16-byte pieces 8 rows
// apart and ran far slower at Ci 400; groups of 16 or 64 pixels were slower
// at the path's largest inputs.)
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quant_pack_planes_kernel(const T* __restrict__ x, const float* __restrict__ s_x, int B, int C,
                         int HW, long long sb, long long sc, int C16, int vec,
                         int8_t* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LP = 32 / V;
  const float inv = sizeof(T) == 1 ? 0.f : __fdiv_rn(1.f, *s_x);
  const int K = C16 / 16;
  const int groups = (HW + 31) / 32;
  const long long items = (long long)B * groups * K * LP;
  for (long long f = (long long)blockIdx.x * kQThreads + threadIdx.x; f < items;
       f += (long long)gridDim.x * kQThreads) {
    const int pl = (int)(f % LP);
    const long long u = f / LP;
    const int c0 = 16 * (int)(u % K);
    const long long w = u / K;
    const int b = (int)(w / groups);
    const int p = ((int)(w - (long long)b * groups) * LP + pl) * V;
    const int n = HW - p;  // pixels of the plane from p on
    if (n <= 0) continue;
    const T* src = x + b * sb + p;
    uint4 raw[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      raw[i] = c0 + i < C ? load_run(src + (c0 + i) * sc, n, vec && n >= V)
                          : make_uint4(0, 0, 0, 0);  // zero codes past C
    int8_t* dst = out + ((long long)b * HW + p) * C16 + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j >= n) break;
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = code_word<T>(raw[i], j, inv);
      *reinterpret_cast<uint4*>(dst + (long long)j * C16) = pack16<T>(w, j);
    }
  }
}

// Any other layout (a channels-last view: pixels sp apart, channels sc):
// a thread per pixel and 16-channel chunk, element loads, one 16-byte store.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quant_pack_rows_kernel(const T* __restrict__ x, const float* __restrict__ s_x, int B, int C,
                       int HW, long long sb, long long sc, long long sp, int C16,
                       int8_t* __restrict__ out) {
  using R = typename Raw<T>::type;
  const float inv = sizeof(T) == 1 ? 0.f : __fdiv_rn(1.f, *s_x);
  const int K = C16 / 16;
  const long long items = (long long)B * HW * K;
  for (long long t = (long long)blockIdx.x * kQThreads + threadIdx.x; t < items;
       t += (long long)gridDim.x * kQThreads) {
    const int k = (int)(t % K);
    const long long bp = t / K;  // b * HW + pixel
    const long long b = bp / HW;
    const R* src = reinterpret_cast<const R*>(x + b * sb + (bp - b * HW) * sp);
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 16 * k + i;
      const uint4 r = make_uint4(c < C ? (uint32_t)src[c * sc] : 0u, 0, 0, 0);
      w[i] = code_word<T>(r, 0, inv);
    }
    *reinterpret_cast<uint4*>(out + bp * C16 + 16 * k) = pack16<T>(w, 0);
  }
}

// What the grid of the quant_pack_s8 kernels is sized from, found once per
// device and kernel: the SMs, the blocks of kQThreads an SM holds, the L2.
struct Card {
  int sms, per_sm, l2;
};

template <typename Kernel>
cudaError_t card(Kernel kernel, std::atomic<bool> (&ready)[kMaxDevices],
                 Card (&cache)[kMaxDevices], Card* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    Card c{};
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&c.l2, cudaDevAttrL2CacheSize, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel, kQThreads, 0);
    if (e != cudaSuccess) return e;
    if (c.per_sm < 1) c.per_sm = 1;
    cache[dev] = c;  // the same values in any racing thread
    ready[dev].store(true, std::memory_order_release);
  }
  *out = cache[dev];
  return cudaSuccess;
}

// Blocks loop over the items, so the grid is at most what the card holds at
// once (no block starts late with a full share): one block an SM where the
// input is larger than L2 and streams from HBM (fewer streams in flight ran
// faster at the path's largest inputs), every block an SM holds where it
// fits L2, as an input just written by the layer before it does.
template <typename T>
int launch_planes(const void* x, const float* s_x, int B, int C, int HW, long long sb,
                  long long sc, int C16, int vec, int8_t* out, cudaStream_t s) {
  static std::atomic<bool> ready[kMaxDevices];
  static Card cache[kMaxDevices];
  Card c;
  const cudaError_t e = card(quant_pack_planes_kernel<T>, ready, cache, &c);
  if (e != cudaSuccess) return (int)e;
  const long long bytes = (long long)B * C * HW * sizeof(T);
  const long long resident = (long long)c.sms * (bytes > c.l2 ? 1 : c.per_sm);
  const long long items = (long long)B * ((HW + 31) / 32) * (C16 / 16) * (32 / (16 / sizeof(T)));
  const long long blocks = (items + kQThreads - 1) / kQThreads;
  quant_pack_planes_kernel<T><<<(unsigned)(blocks < resident ? blocks : resident), kQThreads, 0,
                                s>>>(static_cast<const T*>(x), s_x, B, C, HW, sb, sc, C16, vec,
                                     out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, const float* s_x, int B, int C, int HW, long long sb,
                long long sc, long long sp, int C16, int8_t* out, cudaStream_t s) {
  static std::atomic<bool> ready[kMaxDevices];
  static Card cache[kMaxDevices];
  Card c;
  const cudaError_t e = card(quant_pack_rows_kernel<T>, ready, cache, &c);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)c.sms * c.per_sm;
  const long long blocks = ((long long)B * HW * (C16 / 16) + kQThreads - 1) / kQThreads;
  quant_pack_rows_kernel<T><<<(unsigned)(blocks < resident ? blocks : resident), kQThreads, 0,
                              s>>>(static_cast<const T*>(x), s_x, B, C, HW, sb, sc, sp, C16,
                                   out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant_pack(const void* x, const float* s_x, int B, int C, int HW, long long sb,
                      long long sc, long long sp, int C16, int vec, int8_t* out,
                      cudaStream_t s) {
  return sp == 1 ? launch_planes<T>(x, s_x, B, C, HW, sb, sc, C16, vec, out, s)
                 : launch_rows<T>(x, s_x, B, C, HW, sb, sc, sp, C16, out, s);
}

// ------------------------------------------------------------------ quant_s8

// NCHW planes (row-major pixels sp apart) -> int8 NCHW planes, quantized
// with code() (int8 input copied as it is), written at the output's own
// image and channel strides: a contiguous tensor, or a channel slice of the
// int8 concat buffer its consumer reads, so that the concat moves no other
// bytes. Block (x, c, b) takes 128 runs of V = 16 / sizeof(T) pixels of
// plane (b, c): one 16-byte load a run where the plane's pixels are at
// stride 1 and its runs aligned (vec), one V-byte store where the output's
// are (vec_out), element by element otherwise (a channels-last input, the
// ragged end of every plane).
constexpr int kCThreads = 128;

template <typename T>
__device__ __forceinline__ uint4 load_run_strided(const T* p, int n, long long sp, bool vec) {
  if (sp == 1) return load_run(p, n, vec);
  using R = typename Raw<T>::type;
  union { uint4 u; R e[16 / sizeof(T)]; } r;
  r.u = make_uint4(0, 0, 0, 0);
  const R* q = reinterpret_cast<const R*>(p);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j)
    if (j < n) r.e[j] = q[j * sp];
  return r.u;
}

template <int V> struct Bytes;
template <> struct Bytes<4> { using type = uint32_t; };
template <> struct Bytes<8> { using type = uint2; };
template <> struct Bytes<16> { using type = uint4; };

template <typename T>
__global__ void __launch_bounds__(kCThreads)
quant_nchw_kernel(const T* __restrict__ x, const float* __restrict__ s_x, int HW, long long sb,
                  long long sc, long long sp, int vec, int8_t* __restrict__ out, long long ob,
                  long long oc, int vec_out) {
  constexpr int V = 16 / sizeof(T);
  const float inv = sizeof(T) == 1 ? 0.f : __fdiv_rn(1.f, *s_x);
  const int p = (blockIdx.x * kCThreads + threadIdx.x) * V;
  if (p >= HW) return;
  const int n = HW - p;  // pixels of the plane from p on
  const uint4 r = load_run_strided(x + blockIdx.z * sb + blockIdx.y * sc + p * sp, n, sp,
                                   vec && n >= V);
  union { typename Bytes<V>::type v; uint8_t b[V]; } o;
#pragma unroll
  for (int j = 0; j < V; ++j)
    o.b[j] = (uint8_t)(code_word<T>(r, j, inv) >> (sizeof(T) == 1 ? 8 * (j & 3) : 0));
  int8_t* dst = out + blockIdx.z * ob + blockIdx.y * oc + p;
  if (vec_out && n >= V) {
    *reinterpret_cast<typename Bytes<V>::type*>(dst) = o.v;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) dst[j] = (int8_t)o.b[j];
  }
}

template <typename T>
int launch_quant_nchw(const void* x, const float* s_x, int B, int C, int HW, long long sb,
                      long long sc, long long sp, int vec, int8_t* out, long long ob,
                      long long oc, int vec_out, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long runs = (HW + V - 1) / V;
  const dim3 grid((unsigned)((runs + kCThreads - 1) / kCThreads), C, B);
  quant_nchw_kernel<T><<<grid, kCThreads, 0, s>>>(static_cast<const T*>(x), s_x, HW, sb, sc,
                                                  sp, vec, out, ob, oc, vec_out);
  return (int)cudaGetLastError();
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
               int ks, int stride, int pad, int M, int act, int mode,
               const float* __restrict__ q_s, void* __restrict__ out) {
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
  const float inv = mode >= kS8 ? __fdiv_rn(1.f, *q_s) : 0.f;
  for (int nl = tid / BM; nl < BN && n0 + nl < Co; nl += kThreads / BM) {
    const size_t o = ((size_t)b * Co + n0 + nl) * HoWo + r;
    const int32_t v = so[nl * T::kLdo + ml];
    if (mode == kRaw) {
      static_cast<int32_t*>(out)[o] = v;
    } else if (mode == kF32) {
      static_cast<float*>(out)[o] = __int_as_float(v);
    } else if (mode == kBF16) {
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(__int_as_float(v));
    } else if (mode == kS8) {
      static_cast<int8_t*>(out)[o] = to_s8(__fmul_rn(__int_as_float(v), inv));
    } else {
      const float yb = __bfloat162float(__float2bfloat16_rn(__int_as_float(v)));
      static_cast<int8_t*>(out)[o] = to_s8(__fmul_rn(yb, inv));
    }
  }
}

template <int BM, int BN>
int launch_conv(const int8_t* x, const int8_t* w, const float* s_x, const float* s_w,
                const float* bias, int B, int H, int W, int C16, int Co, int ks, int stride,
                int pad, int act, int mode, const float* q_s, void* out,
                cudaStream_t s) {
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
      x, w, s_x, s_w, bias, H, W, C16, Co, Ho, Wo, ks, stride, pad, M, act, mode, q_s, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, H, W) of float32 (dtype 0), bfloat16 (dtype 1) or int8 (dtype 2,
// already quantized: copied unscaled) with images sb, channels sc and the
// pixels of an (H, W) plane sp elements apart (sp 1 for NCHW planes, C for a
// channels-last view); s_x a float32 scalar on the card; out (B, H, W, C16)
// int8, 16-byte aligned, with C16 a multiple of 16 and >= C. For sp 1, vec
// (1 or 0) says that x, sb and sc put every plane at a multiple of 16
// bytes, so that whole runs take 16-byte loads. Launches on `stream` and
// returns cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue) for
// a dtype it does not know.
int cerberus_quant_pack_s8(const void* x, int dtype, const float* s_x, int B, int C, int H,
                           int W, long long sb, long long sc, long long sp, int C16, int vec,
                           int8_t* out, void* stream) {
  const int HW = H * W;
  if (B <= 0 || HW <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_quant_pack<float>(x, s_x, B, C, HW, sb, sc, sp, C16, vec, out, s);
  if (dtype == 1)
    return launch_quant_pack<__nv_bfloat16>(x, s_x, B, C, HW, sb, sc, sp, C16, vec, out, s);
  if (dtype == 2)
    return launch_quant_pack<int8_t>(x, s_x, B, C, HW, sb, sc, sp, C16, vec, out, s);
  return (int)cudaErrorInvalidValue;
}

// x (B, C, H, W) of float32 (dtype 0), bfloat16 (dtype 1) or int8 (dtype 2,
// copied as it is) with images sb, channels sc and the pixels of an (H, W)
// plane sp elements apart (row-major); s_x a float32 scalar on the card; out
// int8 with images ob and channels oc bytes apart, planes at stride 1. vec
// (1 or 0) says that sp is 1 and x, sb and sc put every plane at a multiple
// of 16 bytes, vec_out
// that out, ob and oc put every plane at a multiple of 16 / sizeof(dtype)
// bytes. B and C at most 65535. Launches on `stream` and returns
// cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue) for a dtype
// it does not know or a B or C out of range.
int cerberus_quant_s8(const void* x, int dtype, const float* s_x, int B, int C, int H, int W,
                      long long sb, long long sc, long long sp, int vec, int8_t* out,
                      long long ob, long long oc, int vec_out, void* stream) {
  const int HW = H * W;
  if (B <= 0 || C <= 0 || HW <= 0) return 0;
  if (B > 65535 || C > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_quant_nchw<float>(x, s_x, B, C, HW, sb, sc, sp, vec, out, ob, oc, vec_out, s);
  if (dtype == 1)
    return launch_quant_nchw<__nv_bfloat16>(x, s_x, B, C, HW, sb, sc, sp, vec, out, ob, oc,
                                            vec_out, s);
  if (dtype == 2)
    return launch_quant_nchw<int8_t>(x, s_x, B, C, HW, sb, sc, sp, vec, out, ob, oc, vec_out,
                                     s);
  return (int)cudaErrorInvalidValue;
}

// x (B, H, W, C16) int8 and w (Co, ks, ks, C16) int8, both 16-byte aligned,
// C16 a multiple of 16; s_x a float32 scalar, s_w and bias (Co,) float32, all
// on the card; out (B, Co, Ho, Wo) of the type `mode` names (0 int32, 1
// float32, 2 bfloat16, 3 int8 of y, 4 int8 of bf16(y)) with Ho = (H + 2 pad -
// ks) / stride + 1, Wo likewise. Modes 3 and 4 multiply by 1 / *q_s, q_s a
// float32 scalar on the card (null for the other modes). (bm, bn) is the
// block tile: (128 | 64, 160 | 80). The caller checks that B * Ho * Wo fits
// an int. Launches on `stream` and returns cudaGetLastError() (0 on
// success); 1 (cudaErrorInvalidValue) for a mode or tile it does not know,
// or for mode 3 or 4 without q_s.
int cerberus_conv_s8(const int8_t* x, const int8_t* w, const float* s_x, const float* s_w,
                     const float* bias, int B, int H, int W, int C16, int Co, int ks,
                     int stride, int pad, int act, int mode, const float* q_s, int bm,
                     int bn, void* out, void* stream) {
  if (mode < kRaw || mode > kS8BF16 || (mode >= kS8 && q_s == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Co <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define CERBERUS_CONV_S8_LAUNCH(BM_, BN_)                                                      \
  if (bm == BM_ && bn == BN_)                                                                  \
    return launch_conv<BM_, BN_>(x, w, s_x, s_w, bias, B, H, W, C16, Co, ks, stride, pad, act, \
                                 mode, q_s, out, s);
  CERBERUS_CONV_S8_LAUNCH(128, 160)
  CERBERUS_CONV_S8_LAUNCH(128, 80)
  CERBERUS_CONV_S8_LAUNCH(64, 160)
  CERBERUS_CONV_S8_LAUNCH(64, 80)
#undef CERBERUS_CONV_S8_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
