// Fused tracker decode tail for Hopper (sm_90a) on the tensor cores: fp32 or
// bf16 activations, fp32 accumulation.
//
// Replaces the TPU kernel yolo_puncture_tpu/ops/pallas/decode_tail.py:_kernel
// (decode_tail_pallas).  Per (frame n, object o) cell it computes the mask
// decoder's tail [2x nearest upsample -> 3x3 conv dec8 -> BN -> SiLU -> + f8p ->
// 2x upsample -> 3x3 conv dec4 -> BN -> SiLU -> 1x1 head -> + skip plane] in the
// subpixel-packed form: a 3x3 conv after a 2x nearest upsample is, for each of
// the four output parities (di, dj), a 2x2 conv on the LOW-resolution input
// (parity group g = 2*di + dj, its tap t = 2*a + b on packed row di + a and
// column dj + b; the other five packed taps of a group are zero and are not
// multiplied here).  The zero border is that of the packed low-resolution input.
//
//   stage 1 (dec8): y8[cell, 2i+di, 2j+dj, :] = T(silu(conv * g8 + b8)) + f8p[n, 2i+di, 2j+dj, :]
//   stage 2 (dec4): out[cell, 2i+di, 2j+dj]   = dot(T(silu(conv * g4 + b4)), w_out) + oskip[n, 2i+di, 2j+dj]
//
// T(.) rounds to the activation type where the TPU body does (after the first
// SiLU and before the head); the skip plane oskip = f4p . w_out + bias is made
// outside, as are the weight tiles and the BN affines.
//
// Layouts (contiguous, channels last, T = float or __nv_bfloat16):
//   hidden (N*No, H16, W16, 128) T    f8p (N, H8, W8, 64) T    oskip (N, H4, W4) fp32
//   a8, a4 (2, 256) = scale row, bias row    w_out (64) fp32
//   y8 scratch (N*No, H8, W8, 64) T    out (N*No, H4, W4) fp32
//   t8, t4: the weight tiles (below), made once per set of weights on the host
//
// Bound: operations.  With the zero taps left out a cell needs
// 2*4*(H16*W16*128 + H8*W8*64)*256 FLOP: 1.27 GFLOP at 30 x 54, 25.5 GFLOP for
// the serving window's 20 cells:
//   bf16   25.5 GFLOP / 989 TFLOP/s                                  = 0.026 ms
//   fp32   3 * 25.5 GFLOP / 495 TFLOP/s (three TF32 products per fp32
//          product, see below)                                      = 0.155 ms
// against 0.019 ms (fp32) for the bytes of the whole function.
//
// Design.  Each stage is an implicit GEMM per parity group: M = low-resolution
// pixels, N = the group's 64 output channels, K = 4 taps x Cin, on wgmma with
// the weights as the B operand from shared memory and the activations as the A
// operand FROM REGISTERS.
//   * A work item is one cell, one parity group and a tile of 32 x 8 pixels.
//     A block is persistent (one per SM) and walks items blockIdx.x,
//     blockIdx.x + gridDim.x, ...: 384 threads = two consumer warpgroups (each
//     two m64 tiles of 8 x 8 pixels, 64 accumulators a thread) and one producer
//     warp, which gives its registers away (setmaxnreg) and runs ahead of the
//     consumers across items over a ring of shared-memory stages with
//     mbarriers, so an item's epilogue overlaps the next item's loads.
//   * The shifted patch.  Tap (a, b) reads the tile shifted by one pixel, which
//     no fixed-stride wgmma descriptor over a staged patch can express.  So
//     per chunk of 128 bytes of channels (32 fp32 / 64 bf16) the producer
//     brings the (32+1) x (8+1) halo patch ONCE with one 4-D TMA load over
//     (channel, W, H, cell), box origin (r0 - 1 + di, c0 - 1 + dj): TMA
//     zero-fills outside the image, negative coordinates included, which is
//     exactly the packed zero border.  A thread then reads its own fragment
//     rows at the shifted addresses with two 16-byte loads a row (the TMA's
//     128-byte swizzle makes them conflict-free) and feeds wgmma from
//     registers; nothing is reloaded per tap.
//   * The weights are static, so the host lays them out once as finished
//     shared-memory images: per (group, chunk, tap, plane) a K-major tile of 64
//     rows (output channel) x 128 bytes (k) with the 128-byte swizzle already
//     applied, fetched with one plain bulk copy per chunk, no tensor map and no
//     per-call pre-pass.  Both the k order and the n order inside a tile are
//     the host's to choose: k slots are ordered so that the 32 bytes a thread
//     loads from a patch row are its A fragments of all four k-steps as they
//     stand, and output channels so that a thread's 16 accumulator columns of a
//     pixel are channels 16c .. 16c+15 (c = lane % 4): the epilogue works on
//     16-byte vectors, and the head's 64-channel dot is 16 FMAs and two shuffles.
//   * fp32 runs as three error-compensated TF32 products ("3xTF32"): x is
//     split into hi = tf32(x), lo = x - hi; a*b = lo_a*hi_b + hi_a*lo_b +
//     hi_a*hi_b, the dropped lo*lo term 2^-22 of the product.  The weight tiles
//     carry a hi and a lo plane; the activations are split in registers after
//     the shared-memory load.  One TF32 product alone misses the 2e-4 the
//     kernel is held to (3.8e-3 at the serving window).  The tensor core
//     truncates when it adds into its accumulator, so a tile's 48 wgmma of a
//     chunk (4 taps x 3 products x 4 k-steps) are summed from zero and added
//     to the running sum with an ordinary rounded add: 2.1e-5 against the plain
//     version where the running accumulator gives 6.6e-5 (and is 13 % faster:
//     64 registers fewer, no spills).  A chunk is eight units (tap, tile) of 12
//     wgmma, each a commit group; tile t's fragments live in buffer t, so unit
//     u + 1 is loaded and split while unit u multiplies.
//   * bf16 runs as stored: wgmma m64n64k16, fp32 accumulation in the tensor
//     core.  Its products are short (16 wgmma per tile and chunk) and its
//     epilogue, bound by the special-function unit (16 results a clock an SM),
//     is as long as an item's products.  So the bf16 loop goes tile by tile and
//     takes each epilogue a tile late, while the next tile's wgmma run, with
//     the epilogue's device-memory reads asked for a step earlier still; and
//     SiLU is x/2 * (1 + tanh(x/2)) with tanh.approx, one special-function
//     operation instead of two.  The fp32 loop has no registers for a second
//     set of accumulators and finishes each item before it starts the next.
//   * The epilogue's constants (BN scale and bias rows, head weights) sit in
//     shared memory.  SiLU in fp32 is x * rcp.approx(1 + ex2.approx(..)); the
//     true division and expf took more instruction slots than a bf16 stage's wgmma
//     took tensor time.
//   * Two stages with the stride-8 tensor through device memory (33 MB in fp32
//     there and back at the window); the stride-4 64-channel per-object tensor,
//     four times that size, never leaves registers.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (serving window, 20 cells of
// 30 x 54): fp32 0.30 ms (the CUDA-core version before it 0.85), bf16 0.10 ms
// (0.88).  What is left: all SMs reach their epilogues together, so stage 1's
// reads of the skip and writes of the stride-8 tensor come in bursts; 560 and
// 2240 equal items on 132 SMs leave the last round part empty.

#include <cuda.h>  // CUtensorMap and its enums; the encoder in libcuda is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CD = 64;               // output channels per parity group
constexpr int TW = 8;                // tile columns: an m64 tile is 8 x 8 pixels
constexpr int MT = 2;                // m64 tiles a consumer warpgroup
constexpr int TH = 2 * MT * 8;       // tile rows of a block: 32
constexpr int PW = TW + 1;           // patch columns
constexpr int kPatchPix = (TH + 1) * PW;
constexpr int kPatchBytes = (kPatchPix * 128 + 1023) / 1024 * 1024;
constexpr int kTileBytes = CD * 128;  // one weight tile: 64 rows of 128 bytes
constexpr int kThreads = 384;         // two consumer warpgroups and the producer's
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int KC = 32;      // channels per chunk: 128 bytes
  static constexpr int PLANES = 2;   // hi and lo
  static constexpr int STAGES = 2;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int KC = 64;
  static constexpr int PLANES = 1;
  static constexpr int STAGES = 3;
};

// a stage: the halo patch, then the four taps' tiles of every plane; after the stages
// the barriers, the epilogue's constants (BN scale and bias rows, the head's weights),
// and 1024 bytes to align the first stage
constexpr int kConstFloats = 2 * 4 * CD + CD;
template <typename T>
struct Smem {
  static constexpr int kStage = kPatchBytes + 4 * Cfg<T>::PLANES * kTileBytes;
  static constexpr int kBytes = Cfg<T>::STAGES * kStage + 16 * Cfg<T>::STAGES + 4 * kConstFloats + 1024;
};


// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// Returns once the barrier has left the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// contiguous bytes (a multiple of 16, both ends 16-byte aligned) from device memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are 128 bytes, 128-byte
// swizzle: start address, leading (16) and stride (1024: 8 rows) byte offsets in units
// of 16 bytes, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
// returns once at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory"); }

#define DT_F8(d, i)                                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define DT_F32(d) DT_F8(d, 0), DT_F8(d, 8), DT_F8(d, 16), DT_F8(d, 24)

// d (64 x 64, fp32) += A (64 x 8 TF32 in registers) * B^T (64 x 8, K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const float* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : DT_F32(d)
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16 bf16 in registers) * B^T (64 x 16, K-major in shared memory)
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : DT_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Makes the registers opaque to the compiler at this point: it neither moves their
// reads and writes across an asynchronous wgmma that still owns them, nor reuses what
// it computed from them before.
__device__ __forceinline__ void pin(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// hi = x rounded to TF32 (10 mantissa bits, ties away from zero), lo = x - hi, which is
// exact; the tensor core drops the low 13 bits of lo.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

// ---------------------------------------------------------------------------
// the epilogue's vectors: 16 channels of one pixel

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(p + 4 * i);
    v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + 8 * i);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(p + 4 * i) = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p + 8 * i) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}


// ---------------------------------------------------------------------------
// one stage

struct Item {
  int cell, g, r0, c0;
};

__device__ __forceinline__ Item decode_item(int item, int tiles_x, int tiles_y) {
  Item it;
  it.c0 = (item % tiles_x) * TW;
  item /= tiles_x;
  it.r0 = (item % tiles_y) * TH;
  item /= tiles_y;
  it.g = item & 3;
  it.cell = item >> 2;
  return it;
}

// What an epilogue needs besides the accumulators.
template <typename T>
struct Epilogue {
  const float* consts;  // shared memory: BN scale row (256), bias row (256), head weights (64)
  const T* skip;
  const float* oskip;
  T* y;
  float* out;
  int H, W, No;
};

// SiLU of the activation type.  fp32: ex2.approx and rcp.approx, each within 2^-22
// relative (the true division and expf took more instruction slots than a bf16 stage's wgmma
// took tensor time).  bf16: x/2 * (1 + tanh(x/2)) with tanh.approx, ONE special-function
// operation instead of two, its 2^-11 relative error an eighth of the bf16 rounding that
// follows; the epilogue is bound by the special-function unit's 16 results a clock.
template <typename T>
__device__ __forceinline__ float silu(float x);
template <>
__device__ __forceinline__ float silu<float>(float x) { return x * __fdividef(1.f, 1.f + __expf(-x)); }
template <>
__device__ __forceinline__ float silu<__nv_bfloat16>(float x) {
  const float h = 0.5f * x;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// A quad lane's 16 channels of a parity group's BN scale and bias and of the head's weights.
struct GroupConsts {
  float sc[16], bi[16], wo[16];

  __device__ __forceinline__ void load(const float* consts, int g, int c, bool head) {
    load16(consts + g * CD + 16 * c, sc);
    load16(consts + 4 * CD + g * CD + 16 * c, bi);
    if (head) load16(consts + 2 * 4 * CD + 16 * c, wo);
  }
};

// One fragment row of one m64 tile: tile pixel (pi, gq) of item `it`, whose 64 channels
// sit in the quad's four threads, 16 each (accumulator column 8j + 2c + e is channel
// 16c + 2j + e, the weight tiles' row order).
template <typename T, bool HEAD>
struct EpilogueRow {
  bool live;
  size_t o;                  // the pixel's offset in the output, in pixels
  float sk[HEAD ? 1 : 16];   // stage 1: the skip's 16 channels; stage 2: the skip plane's value

  // asks device memory for what the row needs
  __device__ __forceinline__ void load(const Epilogue<T>& ep, const Item& it, int pi, int gq, int c) {
    const int i = it.r0 + pi, j = it.c0 + gq;
    const size_t plane = static_cast<size_t>(4 * ep.H) * ep.W;
    live = i < ep.H && j < ep.W;
    o = static_cast<size_t>(2 * i + (it.g >> 1)) * (2 * ep.W) + (2 * j + (it.g & 1));
    const size_t on = static_cast<size_t>(it.cell / ep.No) * plane + o;  // in the frame's skip
    o += static_cast<size_t>(it.cell) * plane;
    if constexpr (HEAD) {
      sk[0] = live && c == 0 ? ep.oskip[on] : 0.f;
    } else {
      if (live) load16(ep.skip + on * CD + 16 * c, sk);
    }
  }

  // BN affine, SiLU, round to T, depth-to-space, then the skip (stage 1) or the head's
  // dot and the skip plane (stage 2); r is the row's place in the accumulator fragment
  __device__ __forceinline__ void finish(const Epilogue<T>& ep, const float (&acc)[32], int r, int c,
                                         const GroupConsts& k) const {
    float v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      v[q] = round_to<T>(silu<T>(fmaf(acc[4 * (q >> 1) + 2 * r + (q & 1)], k.sc[q], k.bi[q])));
    if constexpr (HEAD) {
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) part = fmaf(v[q], k.wo[q], part);
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      if (live && c == 0) ep.out[o] = part + sk[0];
    } else if (live) {
#pragma unroll
      for (int q = 0; q < 16; ++q) v[q] += sk[q];
      store16(ep.y + o * CD + 16 * c, v);
    }
  }
};

// x (cells, H, W, CIN) through map_x -> HEAD ? out (cells, 2H, 2W) fp32 : y (cells, 2H, 2W, CD) in T.
// tiles: (4 groups, CIN / KC chunks, 4 taps, PLANES, 64, 128 bytes).
template <typename T, int CIN, bool HEAD>
__global__ void __launch_bounds__(kThreads, 1)
tail_stage_kernel(const __grid_constant__ CUtensorMap map_x, const uint8_t* __restrict__ tiles,
                  const float* __restrict__ aff, const T* __restrict__ skip,
                  const float* __restrict__ wout, const float* __restrict__ oskip,
                  T* __restrict__ y, float* __restrict__ out,
                  int H, int W, int No, int tiles_x, int tiles_y, int n_items) {
  constexpr bool kFp32 = std::is_same<T, float>::value;
  constexpr int KC = Cfg<T>::KC, PLANES = Cfg<T>::PLANES, STAGES = Cfg<T>::STAGES;
  constexpr int NCHUNK = CIN / KC;
  constexpr int kStage = Smem<T>::kStage;
  constexpr int kWeightBytes = 4 * PLANES * kTileBytes;  // one (group, chunk): four taps, every plane

  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes of ADDRESS: the stages start on one
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t smem_base = smem_u32(smem);
  const uint32_t full = smem_base + STAGES * kStage;  // a stage's barrier is + 8 * stage
  const uint32_t empty = full + 8 * STAGES;
  float* consts = reinterpret_cast<float*>(smem + STAGES * kStage + 16 * STAGES);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive, plus the bytes it announced
      mbar_init(empty + 8 * s, 8);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < kConstFloats; i += kThreads)
    consts[i] = i < 2 * 4 * CD ? aff[i] : (HEAD ? wout[i - 2 * 4 * CD] : 0.f);
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one lane works, all four warps give up their registers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8 && lane == 0) {
      int stage = 0;
      uint32_t phase = 1;  // the stages start empty: the first round of waits passes
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = decode_item(item, tiles_x, tiles_y);
        const int di = it.g >> 1, dj = it.g & 1;
        for (int chunk = 0; chunk < NCHUNK; ++chunk) {
          mbar_wait(empty + 8 * stage, phase);
          const uint32_t dst = smem_base + stage * kStage;
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kPatchPix * 128 + kWeightBytes);
          // patch pixel (pr, pc) is input pixel (r0 - 1 + di + pr, c0 - 1 + dj + pc), zeros outside
          tma_load(dst, &map_x, bar, chunk * KC, it.c0 - 1 + dj, it.r0 - 1 + di, it.cell);
          bulk_load(dst + kPatchBytes, tiles + static_cast<size_t>(it.g * NCHUNK + chunk) * kWeightBytes,
                    kWeightBytes, bar);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, w = warp & 3;
    const int gq = lane >> 2, c = lane & 3;  // fragment row and quad lane
    // the thread's rows of m64 tile t are tile pixels (8 * (wg * MT + t) + 2 * w + r, gq), r = 0, 1
    const int pi0 = 8 * wg * MT + 2 * w;

    const Epilogue<T> ep{consts, skip, oskip, y, out, H, W, No};
    int stage = 0;
    uint32_t phase = 0;

    if constexpr (kFp32) {
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = decode_item(item, tiles_x, tiles_y);
        float acc[MT][32];
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

        for (int chunk = 0; chunk < NCHUNK; ++chunk) {
          mbar_wait(full + 8 * stage, phase);
          const uint8_t* patch = smem + stage * kStage;
          const uint32_t wt = smem_base + stage * kStage + kPatchBytes;
            float part[MT][32];
  #pragma unroll
            for (int t = 0; t < MT; ++t)
  #pragma unroll
              for (int i = 0; i < 32; ++i) part[t][i] = 0.f;
            // Eight units (tap, m64 tile t), each 12 wgmma in a group of its own.  Tile t's
            // fragments live in buffer t, so while unit u multiplies, unit u + 1 is loaded and
            // split, and buffer t is written again only once unit u - 2 has completed.
            float hi[MT][16], lo[MT][16];
  #pragma unroll
            for (int u = 0; u < 4 * MT; ++u) {
              const int tap = u / MT, t = u % MT;
              if (u >= MT) wgmma_wait<MT - 1>();
              // rows r = 0, 1 at the tap's shift: 8 channels each, the A fragments of four k-steps
  #pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int pix = (pi0 + 8 * t + r + (tap >> 1)) * PW + gq + (tap & 1);
                const uint8_t* row = patch + pix * 128;
                const float4 v0 = *reinterpret_cast<const float4*>(row + (((2 * c) ^ (pix & 7)) << 4));
                const float4 v1 = *reinterpret_cast<const float4*>(row + (((2 * c + 1) ^ (pix & 7)) << 4));
                const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  #pragma unroll
                for (int s = 0; s < 4; ++s) {
                  split_tf32(v[2 * s], hi[t][4 * s + r], lo[t][4 * s + r]);
                  split_tf32(v[2 * s + 1], hi[t][4 * s + 2 + r], lo[t][4 * s + 2 + r]);
                }
              }
              wgmma_fence();
  #pragma unroll
              for (int prod = 0; prod < 3; ++prod)  // lo * hi, hi * lo, hi * hi: plane 0 is hi, 1 is lo
  #pragma unroll
                for (int s = 0; s < 4; ++s)
                  wgmma_tf32(part[t], (prod == 0 ? lo[t] : hi[t]) + 4 * s,
                             kmajor_desc(wt + (tap * PLANES + (prod == 1)) * kTileBytes + 32 * s));
              wgmma_commit();
            }
            wgmma_wait<0>();
  #pragma unroll
            for (int t = 0; t < MT; ++t) {
              pin(part[t]);
  #pragma unroll
              for (int i = 0; i < 32; ++i) acc[t][i] += part[t][i];
            }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        // all four rows ask device memory first
        EpilogueRow<T, HEAD> rows[MT][2];
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int r = 0; r < 2; ++r) rows[t][r].load(ep, it, pi0 + 8 * t + r, gq, c);
        GroupConsts k;
        k.load(consts, it.g, c, HEAD);
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int r = 0; r < 2; ++r) rows[t][r].finish(ep, acc[t], r, c, k);
      }
    } else {
      // bf16: the wgmma of a (tile, chunk) are short, and the epilogue, bound by the
      // special-function unit, is as long as an item's products.  So the epilogue is taken
      // a tile late, while the next tile's wgmma run: tile 0 of an item multiplies while
      // tile 1 of the item before is finished, tile 1 multiplies while tile 0 is finished.
      // An item's chunks stay in their stages until both tiles have read them
      // (NCHUNK <= STAGES - 1, so the producer still runs a chunk ahead).
      static_assert(kFp32 || NCHUNK < STAGES, "an item's chunks must fit the ring");
      constexpr int RPS = 2 / NCHUNK;  // fragment rows finished per (tile, chunk) step
      float acc[MT][32];
      // the rows the next step finishes: their skip values are asked for a step ahead, so
      // that device memory answers while that step's fragments are loaded and multiplied
      EpilogueRow<T, HEAD> pend[RPS];
      int pend_g = 0;
      bool pend_ok = false;
      Item prev = {0, 0, 0, 0};
      bool have_prev = false;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const Item it = decode_item(item, tiles_x, tiles_y);
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          constexpr int kLast = MT - 1;
          const int done = t == 0 ? kLast : t - 1;  // the tile that finished last: prev's or this item's
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
#pragma unroll
          for (int chunk = 0; chunk < NCHUNK; ++chunk) {
            const int st = stage + chunk < STAGES ? stage + chunk : stage + chunk - STAGES;
            if (t == 0) mbar_wait(full + 8 * st, stage + chunk < STAGES ? phase : phase ^ 1);
            const uint8_t* patch = smem + st * kStage;
            const uint32_t wt = smem_base + st * kStage + kPatchBytes;
            uint32_t a[4][16];
#pragma unroll
            for (int tap = 0; tap < 4; ++tap)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int pix = (pi0 + 8 * t + r + (tap >> 1)) * PW + gq + (tap & 1);
                const uint8_t* row = patch + pix * 128;
                const uint4 v0 = *reinterpret_cast<const uint4*>(row + (((2 * c) ^ (pix & 7)) << 4));
                const uint4 v1 = *reinterpret_cast<const uint4*>(row + (((2 * c + 1) ^ (pix & 7)) << 4));
                const uint32_t v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                  a[tap][4 * s + r] = v[2 * s];
                  a[tap][4 * s + 2 + r] = v[2 * s + 1];
                }
              }
            wgmma_fence();
#pragma unroll
            for (int tap = 0; tap < 4; ++tap)
#pragma unroll
              for (int s = 0; s < 4; ++s)
                wgmma_bf16(acc[t], a[tap] + 4 * s, kmajor_desc(wt + tap * kTileBytes + 32 * s));
            wgmma_commit();
            // meanwhile: this step's share of the rows of the tile that finished last ...
            if (pend_ok) {
              GroupConsts k;
              k.load(consts, pend_g, c, HEAD);
#pragma unroll
              for (int i = 0; i < RPS; ++i) pend[i].finish(ep, acc[done], chunk * RPS + i, c, k);
            }
            // ... and the question to device memory for the next step's rows: the same tile's
            // next rows, or the first rows of the tile that is multiplying now
            if (chunk + 1 < NCHUNK) {
              if (pend_ok) {
                const Item& of = t == 0 ? prev : it;
#pragma unroll
                for (int i = 0; i < RPS; ++i) pend[i].load(ep, of, pi0 + 8 * done + (chunk + 1) * RPS + i, gq, c);
              }
            } else {
#pragma unroll
              for (int i = 0; i < RPS; ++i) pend[i].load(ep, it, pi0 + 8 * t + i, gq, c);
              pend_g = it.g;
              pend_ok = true;
            }
            wgmma_wait<0>();
            pin(acc[t]);
            if (t == kLast) {  // both tiles have read the chunk
              __syncwarp();
              if (lane == 0) mbar_arrive(empty + 8 * st);
            }
          }
        }
#pragma unroll
        for (int chunk = 0; chunk < NCHUNK; ++chunk)
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        prev = it;
        have_prev = true;
      }
      if (have_prev) {  // the last item's last tile
        GroupConsts k;
        k.load(consts, prev.g, c, HEAD);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r >= RPS) pend[0].load(ep, prev, pi0 + 8 * (MT - 1) + r, gq, c);
          pend[r % RPS].finish(ep, acc[MT - 1], r, c, k);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process already runs on
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || v <= 0)
      v = 132;
    return v;
  }();
  return n;
}

// x (cells, H, W, CIN) of T cut into halo patches of one chunk of channels, 128-byte
// swizzle, zeros outside the tensor
template <typename T, int CIN>
bool patch_map(CUtensorMap* map, const void* x, int cells, int H, int W) {
  constexpr bool kFp32 = std::is_same<T, float>::value;
  const cuuint64_t dims[4] = {CIN, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(cells)};
  cuuint64_t strides[3];
  cuuint64_t bytes = sizeof(T);
  for (int i = 0; i < 3; ++i) strides[i] = bytes *= dims[i];
  const cuuint32_t box[4] = {Cfg<T>::KC, PW, TH + 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_tiled()(map, kFp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int CIN, bool HEAD>
int launch_stage(const T* x, const void* tiles, const float* aff, const T* skip, const float* wout,
                 const float* oskip, T* y, float* out, int cells, int No, int H, int W, cudaStream_t stream) {
  auto kernel = tail_stage_kernel<T, CIN, HEAD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  if (!patch_map<T, CIN>(&map, x, cells, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_items = 4ll * cells * tiles_x * tiles_y;
  if (n_items > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sm_count() ? n_items : sm_count());
  kernel<<<grid, kThreads, Smem<T>::kBytes, stream>>>(map, static_cast<const uint8_t*>(tiles), aff, skip, wout,
                                                      oskip, y, out, H, W, No, tiles_x, tiles_y,
                                                      static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tail(const void* hidden, const void* f8p, const float* oskip, const void* t8, const float* a8,
                const void* t4, const float* a4, const float* wout, void* y8, float* out, int N, int No,
                int H16, int W16, cudaStream_t stream) {
  const int cells = N * No;
  int rc = launch_stage<T, 128, false>(static_cast<const T*>(hidden), t8, a8, static_cast<const T*>(f8p),
                                       nullptr, nullptr, static_cast<T*>(y8), nullptr,
                                       cells, No, H16, W16, stream);
  if (rc != 0) return rc;
  return launch_stage<T, 64, true>(static_cast<const T*>(y8), t4, a4, nullptr, wout, oskip,
                                   nullptr, out, cells, No, 2 * H16, 2 * W16, stream);
}

}  // namespace

extern "C" {

// Launches both stages on `stream`; returns the CUDA error code (0 on
// success).  Compiled for Cin == 128 and Cd == 64 (the published decoder
// widths); the Python wrapper refuses other widths before calling.  t8 and t4
// are the weight tiles of the activation type (fp32: hi and lo planes of TF32;
// bf16: one plane), y8 is scratch of N*No*H8*W8*64 elements of that type.  All
// pointers are 16-byte aligned.
int decode_tail(const void* hidden, const void* f8p, const float* oskip, const void* t8,
                const float* a8, const void* t4, const float* a4, const float* wout,
                void* y8, float* out, int N, int No, int H16, int W16, int Cin, int Cd,
                int is_bf16, void* stream) {
  if (Cin != 128 || Cd != CD || N <= 0 || No <= 0 || H16 <= 0 || W16 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {hidden, f8p, t8, t4, static_cast<const void*>(a8), static_cast<const void*>(a4),
                        static_cast<const void*>(wout), static_cast<const void*>(y8)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tail<__nv_bfloat16>(hidden, f8p, oskip, t8, a8, t4, a4, wout, y8, out, N, No, H16, W16, s);
  return launch_tail<float>(hidden, f8p, oskip, t8, a8, t4, a4, wout, y8, out, N, No, H16, W16, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
