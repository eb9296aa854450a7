// Fused tracker decode tail for Hopper (sm_90a): fp32 or bf16 activations,
// fp32 weights and accumulation.
//
// Replaces the TPU kernel yolo_puncture_tpu/ops/pallas/decode_tail.py:_kernel
// (decode_tail_pallas).  Per (frame n, object o) cell it computes the mask
// decoder's tail [2x nearest upsample -> 3x3 conv dec8 -> BN -> SiLU -> + f8p ->
// 2x upsample -> 3x3 conv dec4 -> BN -> SiLU -> 1x1 head -> + skip plane] in the
// subpixel-packed form: a 3x3 conv after a 2x nearest upsample is, for each of
// the four output parities (di, dj), a 2x2 conv on the LOW-resolution input
// (packed weights (3, 3, Cin, 4*Cd), parity group g = 2*di + dj in channels
// g*Cd .. g*Cd+Cd-1, its taps on packed rows di, di+1 and columns dj, dj+1; the
// other five taps of a group are zero and are not multiplied here).  The zero
// border is that of the packed low-resolution input.
//
//   stage 1 (dec8): y8[cell, 2i+di, 2j+dj, :] = T(silu(conv * g8 + b8)) + f8p[n, 2i+di, 2j+dj, :]
//   stage 2 (dec4): out[cell, 2i+di, 2j+dj]   = dot(T(silu(conv * g4 + b4)), w_out) + oskip[n, 2i+di, 2j+dj]
//
// T(.) rounds to the activation type where the TPU body does (after the first
// SiLU and before the head); the skip plane oskip = f4p . w_out + bias is made
// outside, as are the packed weights and the BN affines.
//
// Layouts (contiguous, channels last, T = float or __nv_bfloat16):
//   hidden (N*No, H16, W16, 128) T    f8p (N, H8, W8, 64) T    oskip (N, H4, W4) fp32
//   w8 (3, 3, 128, 256), w4 (3, 3, 64, 256), a8, a4 (2, 256) = scale row, bias row,
//   w_out (64) fp32    y8 scratch (N*No, H8, W8, 64) T    out (N*No, H4, W4) fp32
//
// Why two stages.  The TPU kernel holds a whole cell in fast memory; its
// stride-8 padded buffer alone is 62 x 110 x 64 values, 1.7 MB in fp32, against
// 227 KB of shared memory per block here.  So space is tiled, and the stride-8
// 64-channel tensor (33 MB in fp32 at the serving window) goes through device
// memory once between the stages, where every tile finds its halo.  The
// stride-4 64-channel per-object tensor, four times that size, never leaves
// registers: stage 2 reduces it to one logit per pixel in its epilogue.
//
// Bound: operations.  With the zero taps left out a cell needs
// 2*4*(H16*W16*128 + H8*W8*64)*256 FLOP: 1.27 GFLOP at 30 x 54, 25.5 GFLOP for
// the serving window's 20 cells, 0.38 ms at the H100's 67 TFLOP/s fp32 rate
// (TF32 is not used); the bytes of the whole function (17 MB hidden, 8 MB f8p,
// 33 MB f4p for the skip plane, 2 MB of weights, 2 MB out) take 0.019 ms.
// Multiplying all nine packed taps, as the TPU kernel does, would be 57 GFLOP.
//
// Design.  One block computes, for one cell and one parity group, a tile of
// 8 x 16 low-resolution pixels by 64 output channels as an implicit GEMM with
// K = 4 taps x Cin.  Per chunk of 32 input channels it stages the 9 x 17 input
// patch (zero outside the image) and the 4 x 32 x 64 weights in shared memory.
// The 256 threads are a 16 x 16 grid: thread (ty, tx) owns the tile's column ty
// (8 pixels) and channels 4*tx .. 4*tx+3, 32 accumulators.  In stage 2 the 16
// threads that share a pixel are half a warp, so the 64-channel head product is
// four shuffles.  Tensor cores and TMA are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int TH = 8;         // tile rows (low-resolution pixels)
constexpr int TW = 16;        // tile columns
constexpr int KC = 32;        // input channels per chunk
constexpr int CD = 64;        // output channels per parity group
constexpr int LDX = KC + 4;   // padded channel row of the input patch
constexpr int PATCH = (TH + 1) * (TW + 1);
constexpr size_t kSharedBytes = sizeof(float) * (PATCH * LDX + 4 * KC * CD);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// x (cells, H, W, CIN) -> HEAD ? out (cells, 2H, 2W) fp32 : y (cells, 2H, 2W, CD) in T.
// grid = (tiles, 4 parity groups, cells).
template <typename T, int CIN, bool HEAD>
__global__ void __launch_bounds__(kThreads, 2)
subpix_stage_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ aff, const T* __restrict__ skip,
                    const float* __restrict__ wout, const float* __restrict__ oskip,
                    T* __restrict__ y, float* __restrict__ out,
                    int H, int W, int No, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                 // (PATCH, LDX)
  float* Ws = Xs + PATCH * LDX;     // (4 taps, KC, CD)

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // channels 4*tx .. 4*tx+3
  const int ty = tid >> 4;          // tile column
  const int r0 = (blockIdx.x / tiles_x) * TH;
  const int c0 = (blockIdx.x % tiles_x) * TW;
  const int g = blockIdx.y;
  const int di = g >> 1, dj = g & 1;
  const int cell = blockIdx.z;
  const int n = cell / No;
  const T* xc = x + static_cast<size_t>(cell) * H * W * CIN;

  float acc[TH][4];
#pragma unroll
  for (int j = 0; j < TH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < CIN; k0 += KC) {
    __syncthreads();  // the previous chunk is no longer read
    // patch pixel (pr, pc) is input pixel (r0 - 1 + di + pr, c0 - 1 + dj + pc)
    for (int i = tid; i < PATCH * (KC / 4); i += kThreads) {
      const int k4 = i % (KC / 4), pix = i / (KC / 4);
      const int r = r0 - 1 + di + pix / (TW + 1);
      const int c = c0 - 1 + dj + pix % (TW + 1);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r >= 0 && r < H && c >= 0 && c < W)
        v = load4(xc + (static_cast<size_t>(r) * W + c) * CIN + k0 + k4 * 4);
      *reinterpret_cast<float4*>(Xs + pix * LDX + k4 * 4) = v;
    }
    // tap t = 2a + b of this parity group sits at packed (di + a, dj + b)
    for (int i = tid; i < 4 * KC * (CD / 4); i += kThreads) {
      const int c4 = i % (CD / 4), k = (i / (CD / 4)) % KC, t = i / ((CD / 4) * KC);
      const int a = t >> 1, b = t & 1;
      const float* src = w + ((static_cast<size_t>(di + a) * 3 + (dj + b)) * CIN + k0 + k) * (4 * CD)
                         + g * CD + c4 * 4;
      *reinterpret_cast<float4*>(Ws + (t * KC + k) * CD + c4 * 4) = load4(src);
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int a = t >> 1, b = t & 1;
#pragma unroll 2
      for (int k = 0; k < KC; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wv[kk] = *reinterpret_cast<const float4*>(Ws + (t * KC + k + kk) * CD + 4 * tx);
#pragma unroll
        for (int j = 0; j < TH; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(Xs + ((j + a) * (TW + 1) + ty + b) * LDX + k);
          acc[j][0] = fmaf(xv.x, wv[0].x, acc[j][0]);
          acc[j][1] = fmaf(xv.x, wv[0].y, acc[j][1]);
          acc[j][2] = fmaf(xv.x, wv[0].z, acc[j][2]);
          acc[j][3] = fmaf(xv.x, wv[0].w, acc[j][3]);
          acc[j][0] = fmaf(xv.y, wv[1].x, acc[j][0]);
          acc[j][1] = fmaf(xv.y, wv[1].y, acc[j][1]);
          acc[j][2] = fmaf(xv.y, wv[1].z, acc[j][2]);
          acc[j][3] = fmaf(xv.y, wv[1].w, acc[j][3]);
          acc[j][0] = fmaf(xv.z, wv[2].x, acc[j][0]);
          acc[j][1] = fmaf(xv.z, wv[2].y, acc[j][1]);
          acc[j][2] = fmaf(xv.z, wv[2].z, acc[j][2]);
          acc[j][3] = fmaf(xv.z, wv[2].w, acc[j][3]);
          acc[j][0] = fmaf(xv.w, wv[3].x, acc[j][0]);
          acc[j][1] = fmaf(xv.w, wv[3].y, acc[j][1]);
          acc[j][2] = fmaf(xv.w, wv[3].z, acc[j][2]);
          acc[j][3] = fmaf(xv.w, wv[3].w, acc[j][3]);
        }
      }
    }
  }

  // epilogue: BN affine, SiLU, depth-to-space, then the skip (stage 1) or the head (stage 2)
  const int ch = g * CD + 4 * tx;
  const float4 sc = load4(aff + ch);
  const float4 bi = load4(aff + 4 * CD + ch);
  const int H2 = 2 * H, W2 = 2 * W;
  const int c = c0 + ty;
  float4 wo = make_float4(0.f, 0.f, 0.f, 0.f);
  if (HEAD) wo = load4(wout + 4 * tx);
#pragma unroll
  for (int j = 0; j < TH; ++j) {
    const int r = r0 + j;
    const bool live = r < H && c < W;
    const int oh = 2 * r + di, ow = 2 * c + dj;
    float4 v;
    v.x = round_to<T>(silu(acc[j][0] * sc.x + bi.x));
    v.y = round_to<T>(silu(acc[j][1] * sc.y + bi.y));
    v.z = round_to<T>(silu(acc[j][2] * sc.z + bi.z));
    v.w = round_to<T>(silu(acc[j][3] * sc.w + bi.w));
    if (HEAD) {
      float part = v.x * wo.x;
      part = fmaf(v.y, wo.y, part);
      part = fmaf(v.z, wo.z, part);
      part = fmaf(v.w, wo.w, part);
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (live && tx == 0) {
        const size_t o = static_cast<size_t>(oh) * W2 + ow;
        out[static_cast<size_t>(cell) * H2 * W2 + o] = part + oskip[static_cast<size_t>(n) * H2 * W2 + o];
      }
    } else if (live) {
      const size_t o = (static_cast<size_t>(oh) * W2 + ow) * CD + 4 * tx;
      const float4 s = load4(skip + static_cast<size_t>(n) * H2 * W2 * CD + o);
      store4(y + static_cast<size_t>(cell) * H2 * W2 * CD + o,
             make_float4(v.x + s.x, v.y + s.y, v.z + s.z, v.w + s.w));
    }
  }
}

template <typename T, int CIN, bool HEAD>
int launch_stage(const T* x, const float* w, const float* aff, const T* skip, const float* wout,
                 const float* oskip, T* y, float* out, int cells, int No, int H, int W,
                 cudaStream_t stream) {
  auto kernel = subpix_stage_kernel<T, CIN, HEAD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSharedBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, 4, cells);
  kernel<<<grid, kThreads, kSharedBytes, stream>>>(x, w, aff, skip, wout, oskip, y, out, H, W, No, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tail(const void* hidden, const void* f8p, const float* oskip, const float* w8,
                const float* a8, const float* w4, const float* a4, const float* wout,
                void* y8, float* out, int N, int No, int H16, int W16, cudaStream_t stream) {
  const int cells = N * No;
  int rc = launch_stage<T, 128, false>(static_cast<const T*>(hidden), w8, a8, static_cast<const T*>(f8p),
                                       nullptr, nullptr, static_cast<T*>(y8), nullptr,
                                       cells, No, H16, W16, stream);
  if (rc != 0) return rc;
  return launch_stage<T, 64, true>(static_cast<const T*>(y8), w4, a4, nullptr, wout, oskip,
                                   nullptr, out, cells, No, 2 * H16, 2 * W16, stream);
}

}  // namespace

extern "C" {

// Launches both stages on `stream`; returns the CUDA error code (0 on
// success).  Compiled for Cin == 128 and Cd == 64 (the published decoder
// widths); the Python wrapper refuses other widths before calling.  y8 is
// scratch of N*No*H8*W8*64 elements of the activation type.
int decode_tail(const void* hidden, const void* f8p, const float* oskip, const float* w8,
                const float* a8, const float* w4, const float* a4, const float* wout,
                void* y8, float* out, int N, int No, int H16, int W16, int Cin, int Cd,
                int is_bf16, void* stream) {
  if (Cin != 128 || Cd != CD || N <= 0 || No <= 0 || H16 <= 0 || W16 <= 0 || N * No > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tail<__nv_bfloat16>(hidden, f8p, oskip, w8, a8, w4, a4, wout, y8, out, N, No, H16, W16, s);
  return launch_tail<float>(hidden, f8p, oskip, w8, a8, w4, a4, wout, y8, out, N, No, H16, W16, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
