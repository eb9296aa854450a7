// Fused proto-mask decode for Hopper (sm_90a): fp32 operands and output, or
// bf16 operands and output with fp32 arithmetic.
//
// Replaces the TPU kernel yolo_puncture_tpu/ops/pallas/proto_decode.py:_kernel
// (proto_decode_pallas).  For every frame b, instance n and proto pixel p:
//
//   x = sum_m coeffs[b, n, m] * protos[b, m, p]      (fp32 accumulation)
//   v = sigmoid(x)                                   (fp32, then rounded to the
//                                                     output type)
//   v = 0 outside the box when crop (half-open: x1 <= px < x2, y1 <= py < y2)
//   v = (v > threshold) ? 1 : 0 when a threshold is given
//   out[b, n, p] = v
//
// Layouts (all contiguous; T is float or __nv_bfloat16):
//   protos (B, NM, P) T  channel-first, P = Hp * Wp: the NCHW tensor the Proto
//                        head produces, so neighbouring threads read
//                        neighbouring pixels of one channel
//   coeffs (B, N, NM) T  boxes (B, N, 4) fp32 xyxy in proto pixels   out (B, N, P) T
//
// Bound: memory.  At serving shapes (Hp = Wp = 160, NM = 32, N = 32) an fp32
// frame reads 3.28 MB of protos and writes 3.28 MB of masks against 52 MFLOP,
// about 8 FLOP per byte, far below the H100's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte); bf16 halves the bytes.
//
// Design.  A thread owns PX = 4 neighbouring pixels of one frame and holds
// their NM proto values in registers as fp32 (128 of them), loaded as one
// vector per channel (16 bytes of fp32, 8 bytes of bf16), so protos are read
// from device memory exactly once.  bf16 protos are widened once, on load (a
// shift or a mask of the 32-bit word that carries two of them), so the FMAs
// are the fp32 kernel's: with N instances a widened proto feeds N FMAs, and
// widening at every use would double the instructions of the inner loop.  (A
// 16-byte load of 8 bf16 pixels a thread would need 256 fp32 registers for
// the widened values; 8-byte loads keep a warp's access one contiguous 256-byte
// run, which coalesces as well.)  A block stages its instances' coefficients
// in shared memory as fp32 float4: one 16-byte broadcast load feeds 4
// coefficients x 4 pixels = 16 FMAs.  The loop over the instances writes
// out[b, n, p..p+3] as one vector store (16 bytes of fp32, 8 of bf16, rounded
// to nearest).  The grid is (pixel tiles, frames, instance splits): with few
// frames the instances are split over blockIdx.z so that all 132 SMs have
// work, and the second reader of a proto tile finds it in L2.  Where P is not
// a multiple of 4, or a pointer is not aligned to a vector, the same kernel
// loads and stores element by element with the ragged edge masked.
//
// The sigmoid is __fdividef(1, 1 + __expf(-x)): ex2.approx and rcp.approx, each
// within 2^-22 relative, well inside the 1e-6 the fp32 soft masks are held to
// (measured: 3e-7 against the plain version) and far inside a bf16 ulp
// (2^-8), so a bf16 mask differs from the plain version's only where the fp32
// value lies within 2^-22 of a rounding edge.  The IEEE-rounded reciprocal
// __frcp_rn is a subroutine: with it the kernel takes 19.3 us, not 12.6.  For a
// threshold t in (0, 1) the fp32 caller passes logit(t), computed in float64,
// and the kernel compares x with it: sigmoid(x) > t <=> x > logit(t), no
// exponential at all.  The bf16 kernel compares the rounded bf16 sigmoid with
// t rounded to bf16 (by the caller), as the reference does (the sigmoid is
// cast to the model's type before the threshold, and a bf16 comparison rounds
// its scalar), and so keeps the exponential.
//
// No tensor cores: the product is K = 32 deep, the kernel is bound by its
// bytes, and the fp32 soft masks are held to 1e-6, which a TF32 product (10
// mantissa bits) misses a thousandfold and three compensated ones would buy
// nothing: measured with loads and stores compiled out
// (scripts/kernel_experiments_torch.py), the FMAs, the crop test and the
// sigmoid take 9.8 of the kernel's 12.6 us at the serving shape (B = 4); the
// loads add 2.3 us, a block's load phase not overlapping its arithmetic, the
// stores nothing.  Six warps an SM leave the instruction slots part empty.
// bf16 operands on wgmma would not help either: K = 32 is two k-steps of a
// 64-row tile, and the kernel is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NM = 32;       // prototypes
constexpr int PX = 4;        // pixels a thread
constexpr int kThreads = 128;
constexpr int kChunk = 32;   // instances staged in shared memory at a time

enum Mode { kSoft = 0, kSigmoidThreshold = 1, kLogitThreshold = 2 };

// element access for T = float and T = __nv_bfloat16: PX elements as one vector
// (16 or 8 bytes), one element, and the rounding of an fp32 value to T
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void load_vec(const float* p, float (&v)[PX]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[PX]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));  // element 0 in the low half of x.x
  v[0] = bf16_lo(x.x); v[1] = bf16_hi(x.x); v[2] = bf16_lo(x.y); v[3] = bf16_hi(x.y);
}
__device__ __forceinline__ float load_one(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float4 load_coef4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load_coef4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(x.x), bf16_hi(x.x), bf16_lo(x.y), bf16_hi(x.y));
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[PX]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[PX]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float, float v) { return v; }
__device__ __forceinline__ float round_to(__nv_bfloat16, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
proto_decode_kernel(const T* __restrict__ protos, const T* __restrict__ coeffs,
                    const float* __restrict__ boxes, T* __restrict__ out,
                    int N, int Wp, int P, int crop, float threshold) {
  __shared__ float4 s_coef[kChunk][NM / 4];
  __shared__ float4 s_box[kChunk];

  const int b = blockIdx.y;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * PX;
  const bool live = p0 < P;

  float pr[NM][PX];
  const T* pb = protos + static_cast<size_t>(b) * NM * P;
  if (VEC) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (live) {
        load_vec(pb + static_cast<size_t>(m) * P + p0, pr[m]);
      } else {
#pragma unroll
        for (int e = 0; e < PX; ++e) pr[m][e] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < PX; ++e) pr[m][e] = p0 + e < P ? load_one(pb + static_cast<size_t>(m) * P + p0 + e) : 0.f;
  }
  float px[PX], py[PX];
#pragma unroll
  for (int e = 0; e < PX; ++e) {
    px[e] = static_cast<float>((p0 + e) % Wp);
    py[e] = static_cast<float>((p0 + e) / Wp);
  }

  // this block's instances: the blockIdx.z-th share of N, in chunks of kChunk
  const int per = (N + gridDim.z - 1) / gridDim.z;
  const int n_begin = blockIdx.z * per, n_end = min(N, n_begin + per);
  const T* cb = coeffs + static_cast<size_t>(b) * N * NM;
  const float* bb = boxes + static_cast<size_t>(b) * N * 4;
  T* ob = out + static_cast<size_t>(b) * N * P;

  for (int n0 = n_begin; n0 < n_end; n0 += kChunk) {
    const int nc = min(kChunk, n_end - n0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < nc * (NM / 4); i += blockDim.x)
      s_coef[i / (NM / 4)][i % (NM / 4)] = load_coef4(cb + static_cast<size_t>(n0) * NM + 4 * i);
    for (int i = threadIdx.x; i < nc; i += blockDim.x)
      s_box[i] = *reinterpret_cast<const float4*>(bb + static_cast<size_t>(n0 + i) * 4);
    __syncthreads();
    if (!live) continue;
#pragma unroll 2
    for (int i = 0; i < nc; ++i) {
      float acc[PX];
#pragma unroll
      for (int e = 0; e < PX; ++e) acc[e] = 0.f;
#pragma unroll
      for (int m4 = 0; m4 < NM / 4; ++m4) {
        const float4 c = s_coef[i][m4];  // every lane reads the same 16 bytes: one broadcast
#pragma unroll
        for (int e = 0; e < PX; ++e) {
          acc[e] = fmaf(c.x, pr[4 * m4 + 0][e], acc[e]);
          acc[e] = fmaf(c.y, pr[4 * m4 + 1][e], acc[e]);
          acc[e] = fmaf(c.z, pr[4 * m4 + 2][e], acc[e]);
          acc[e] = fmaf(c.w, pr[4 * m4 + 3][e], acc[e]);
        }
      }
      const float4 bx = s_box[i];
      float v[PX];
#pragma unroll
      for (int e = 0; e < PX; ++e) {
        const bool inside = !crop || (px[e] >= bx.x && px[e] < bx.z && py[e] >= bx.y && py[e] < bx.w);
        if (MODE == kLogitThreshold) {
          v[e] = inside && acc[e] > threshold ? 1.f : 0.f;
        } else {
          // the soft value in the output type: a bf16 mask is thresholded after rounding
          float s = round_to(T(), __fdividef(1.f, 1.f + __expf(-acc[e])));
          s = inside ? s : 0.f;
          v[e] = MODE == kSoft ? s : (s > threshold ? 1.f : 0.f);
        }
      }
      T* dst = ob + static_cast<size_t>(n0 + i) * P + p0;
      if (VEC) {
        store_vec(dst, v);
      } else {
#pragma unroll
        for (int e = 0; e < PX; ++e)
          if (p0 + e < P) store_one(dst + e, v[e]);
      }
    }
  }
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

template <typename T, int MODE>
void launch(bool vec, dim3 grid, cudaStream_t s, const T* protos, const T* coeffs,
            const float* boxes, T* out, int N, int Wp, int P, int crop, float threshold) {
  if (vec)
    proto_decode_kernel<T, MODE, true><<<grid, kThreads, 0, s>>>(protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  else
    proto_decode_kernel<T, MODE, false><<<grid, kThreads, 0, s>>>(protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
}

template <typename T>
int decode(const T* protos, const T* coeffs, const float* boxes, T* out, int B, int N, int nm,
           int Hp, int Wp, int crop, int mode, float threshold, void* stream) {
  if (nm != NM || B <= 0 || N <= 0 || Hp <= 0 || Wp <= 0 || B > 65535 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = Hp * Wp;
  const int tiles = (P + kThreads * PX - 1) / (kThreads * PX);
  // Fewer blocks than SMs (one or two frames): the instances are shared out over
  // blockIdx.z, at least 8 a block.  With more blocks than SMs (four frames at
  // 160 x 160 are 200) sharing out was measured slower: the L2 re-reads of the
  // protos cost more than the idle SMs.
  int n_split = 1;
  while (tiles * B * n_split < sm_count() && 2 * n_split * 8 <= N) n_split *= 2;
  constexpr uintptr_t kVecBytes = PX * sizeof(T);
  const bool vec = P % PX == 0 && reinterpret_cast<uintptr_t>(protos) % kVecBytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % kVecBytes == 0;
  if (reinterpret_cast<uintptr_t>(coeffs) % kVecBytes != 0 || reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid(tiles, B, n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kSoft) launch<T, kSoft>(vec, grid, s, protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  else if (mode == kSigmoidThreshold)
    launch<T, kSigmoidThreshold>(vec, grid, s, protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  else launch<T, kLogitThreshold>(vec, grid, s, protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entries launch on `stream` and return cudaGetLastError() (0 on success).
// Only nm == 32 is compiled (the YOLO segment head's prototype count); the
// Python wrapper refuses other widths before calling.  mode: 0 soft masks, 1
// binary by sigmoid(x) > threshold, 2 binary by x > threshold (the caller
// passes logit(t); fp32 only: the bf16 entry refuses it, since a bf16 mask is
// thresholded after its sigmoid is rounded, and takes t rounded to bf16).
int proto_decode_f32(const float* protos, const float* coeffs, const float* boxes, float* out,
                     int B, int N, int nm, int Hp, int Wp, int crop, int mode,
                     float threshold, void* stream) {
  return decode<float>(protos, coeffs, boxes, out, B, N, nm, Hp, Wp, crop, mode, threshold, stream);
}

// protos, coeffs and out are bf16 (__nv_bfloat16); boxes fp32.
int proto_decode_bf16(const void* protos, const void* coeffs, const float* boxes, void* out,
                      int B, int N, int nm, int Hp, int Wp, int crop, int mode,
                      float threshold, void* stream) {
  if (mode == kLogitThreshold) return static_cast<int>(cudaErrorInvalidValue);
  return decode<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(protos),
                               static_cast<const __nv_bfloat16*>(coeffs), boxes,
                               static_cast<__nv_bfloat16*>(out), B, N, nm, Hp, Wp, crop, mode, threshold,
                               stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
