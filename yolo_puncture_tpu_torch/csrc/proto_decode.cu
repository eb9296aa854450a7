// Fused proto-mask decode for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel yolo_puncture_tpu/ops/pallas/proto_decode.py:_kernel
// (proto_decode_pallas).  For every frame b, instance n and proto pixel p:
//
//   x = sum_m coeffs[b, n, m] * protos[b, m, p]
//   v = sigmoid(x)
//   v = 0 outside the box when crop (half-open: x1 <= px < x2, y1 <= py < y2)
//   v = (v > threshold) ? 1 : 0 when a threshold is given
//   out[b, n, p] = v
//
// Layouts (all contiguous fp32):
//   protos (B, NM, P)  channel-first, P = Hp * Wp: the NCHW tensor the Proto
//                      head produces, so neighbouring threads read
//                      neighbouring pixels of one channel
//   coeffs (B, N, NM)  boxes (B, N, 4) xyxy in proto pixels   out (B, N, P)
//
// Bound: memory.  At serving shapes (Hp = Wp = 160, NM = 32, N = 32) a frame
// reads 3.28 MB of protos and writes 3.28 MB of masks against 52 MFLOP, about
// 8 FLOP per byte, far below the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s
// = 20 FLOP/byte).
//
// Design.  A thread owns PX = 4 neighbouring pixels of one frame and holds
// their NM proto values in registers (128 of them), loaded as 16-byte vectors,
// so protos are read from device memory exactly once and a warp moves 512
// bytes per load or store instruction.  A block stages its instances'
// coefficients in shared memory as float4: one 16-byte broadcast load feeds
// 4 coefficients x 4 pixels = 16 FMAs.  The loop over the instances writes
// out[b, n, p..p+3] as one 16-byte store.  The grid is
// (pixel tiles, frames, instance splits): with few frames the instances are
// split over blockIdx.z so that all 132 SMs have work, and the second reader
// of a proto tile finds it in L2.  Where P is not a multiple of 4, or a
// pointer is not 16-byte aligned, the same kernel loads and stores element by
// element with the ragged edge masked.
//
// The sigmoid is __fdividef(1, 1 + __expf(-x)): ex2.approx and rcp.approx, each
// within 2^-22 relative, well inside the 1e-6 the soft masks are held to
// (measured: 3e-7 against the plain version).  The IEEE-rounded reciprocal
// __frcp_rn is a subroutine: with it the kernel takes 19.3 us, not 12.6.  For a threshold t in (0, 1) the caller passes logit(t), computed in
// float64, and the kernel compares x with it: sigmoid(x) > t <=> x > logit(t),
// no exponential at all.
//
// No tensor cores: the product is K = 32 deep, the kernel is bound by its
// bytes, and the soft masks are held to 1e-6, which a TF32 product (10
// mantissa bits) misses a thousandfold and three compensated ones would buy
// nothing: measured with loads and stores compiled out
// (scripts/kernel_experiments_torch.py), the FMAs, the crop test and the
// sigmoid take 9.8 of the kernel's 12.6 us at the serving shape (B = 4); the
// loads add 2.3 us, a block's load phase not overlapping its arithmetic, the
// stores nothing.  Six warps an SM leave the instruction slots part empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NM = 32;       // prototypes
constexpr int PX = 4;        // pixels a thread
constexpr int kThreads = 128;
constexpr int kChunk = 32;   // instances staged in shared memory at a time

enum Mode { kSoft = 0, kSigmoidThreshold = 1, kLogitThreshold = 2 };

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
proto_decode_kernel(const float* __restrict__ protos, const float* __restrict__ coeffs,
                    const float* __restrict__ boxes, float* __restrict__ out,
                    int N, int Wp, int P, int crop, float threshold) {
  __shared__ float4 s_coef[kChunk][NM / 4];
  __shared__ float4 s_box[kChunk];

  const int b = blockIdx.y;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * PX;
  const bool live = p0 < P;

  float pr[NM][PX];
  const float* pb = protos + static_cast<size_t>(b) * NM * P;
  if (VEC) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) v = __ldg(reinterpret_cast<const float4*>(pb + static_cast<size_t>(m) * P + p0));
      pr[m][0] = v.x; pr[m][1] = v.y; pr[m][2] = v.z; pr[m][3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < PX; ++e) pr[m][e] = p0 + e < P ? __ldg(pb + static_cast<size_t>(m) * P + p0 + e) : 0.f;
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
  const float* cb = coeffs + static_cast<size_t>(b) * N * NM;
  const float* bb = boxes + static_cast<size_t>(b) * N * 4;
  float* ob = out + static_cast<size_t>(b) * N * P;

  for (int n0 = n_begin; n0 < n_end; n0 += kChunk) {
    const int nc = min(kChunk, n_end - n0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < nc * (NM / 4); i += blockDim.x)
      s_coef[i / (NM / 4)][i % (NM / 4)] =
          *reinterpret_cast<const float4*>(cb + static_cast<size_t>(n0) * NM + 4 * i);
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
          float s = __fdividef(1.f, 1.f + __expf(-acc[e]));
          s = inside ? s : 0.f;
          v[e] = MODE == kSoft ? s : (s > threshold ? 1.f : 0.f);
        }
      }
      float* dst = ob + static_cast<size_t>(n0 + i) * P + p0;
      if (VEC) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < PX; ++e)
          if (p0 + e < P) dst[e] = v[e];
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

template <int MODE>
void launch(bool vec, dim3 grid, cudaStream_t s, const float* protos, const float* coeffs,
            const float* boxes, float* out, int N, int Wp, int P, int crop, float threshold) {
  if (vec)
    proto_decode_kernel<MODE, true><<<grid, kThreads, 0, s>>>(protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  else
    proto_decode_kernel<MODE, false><<<grid, kThreads, 0, s>>>(protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Only
// nm == 32 is compiled (the YOLO segment head's prototype count); the Python
// wrapper refuses other widths before calling.  mode: 0 soft masks, 1 binary
// by sigmoid(x) > threshold, 2 binary by x > threshold (the caller passes
// logit(t)).
int proto_decode_f32(const float* protos, const float* coeffs, const float* boxes, float* out,
                     int B, int N, int nm, int Hp, int Wp, int crop, int mode,
                     float threshold, void* stream) {
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
  const bool vec = P % PX == 0 && reinterpret_cast<uintptr_t>(protos) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(coeffs) % 16 != 0 || reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid(tiles, B, n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kSoft) launch<kSoft>(vec, grid, s, protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  else if (mode == kSigmoidThreshold)
    launch<kSigmoidThreshold>(vec, grid, s, protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  else launch<kLogitThreshold>(vec, grid, s, protos, coeffs, boxes, out, N, Wp, P, crop, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
