// Fused proto-mask decode for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel yolo_puncture_tpu/ops/pallas/proto_decode.py:_kernel
// (proto_decode_pallas).  For every frame b, instance n and proto pixel p:
//
//   v = sigmoid(sum_m coeffs[b, n, m] * protos[b, m, p])
//   v = 0 outside the box when crop (half-open: x1 <= px < x2, y1 <= py < y2)
//   v = (v > threshold) ? 1 : 0 when a threshold is given
//   out[b, n, p] = v
//
// Layouts (all contiguous fp32):
//   protos (B, NM, P)  channel-first, P = Hp * Wp: the NCHW tensor the Proto
//                      head produces, so a warp reads 32 neighbouring pixels of
//                      one channel in one coalesced transaction
//   coeffs (B, N, NM)  boxes (B, N, 4) xyxy in proto pixels   out (B, N, P)
//
// Bound: memory.  At serving shapes (Hp = Wp = 160, NM = 32, N = 32) a frame
// reads 3.28 MB of protos and writes 3.28 MB of masks against 52 MFLOP, about
// 8 FLOP per byte, far below the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s
// = 20 FLOP/byte).  Design: one thread per (frame, pixel) holds that pixel's
// NM proto values in registers, so protos are read from device memory exactly
// once; a block stages a chunk of the frame's coefficients and boxes in shared
// memory (every thread of a warp reads the same word: a broadcast), and loops
// over the instances writing out[b, n, p] coalesced along p.  No tensor cores:
// the product is K = 32 deep and the kernel is bound by its bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // instances staged in shared memory at a time

template <int NM>
__global__ void __launch_bounds__(kThreads)
proto_decode_kernel(const float* __restrict__ protos, const float* __restrict__ coeffs,
                    const float* __restrict__ boxes, float* __restrict__ out,
                    int N, int Wp, int P, int crop, int use_threshold, float threshold) {
  __shared__ float s_coef[kChunk][NM];
  __shared__ float4 s_box[kChunk];

  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;

  float pr[NM];
  const float* pb = protos + static_cast<size_t>(b) * NM * P;
#pragma unroll
  for (int m = 0; m < NM; ++m) pr[m] = live ? __ldg(pb + static_cast<size_t>(m) * P + p) : 0.f;
  const float px = live ? static_cast<float>(p % Wp) : 0.f;
  const float py = live ? static_cast<float>(p / Wp) : 0.f;

  const float* cb = coeffs + static_cast<size_t>(b) * N * NM;
  const float* bb = boxes + static_cast<size_t>(b) * N * 4;
  float* ob = out + static_cast<size_t>(b) * N * P;

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int nc = min(kChunk, N - n0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < nc * NM; i += kThreads)
      s_coef[i / NM][i % NM] = cb[static_cast<size_t>(n0) * NM + i];
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      const float* bx = bb + static_cast<size_t>(n0 + i) * 4;
      s_box[i] = make_float4(bx[0], bx[1], bx[2], bx[3]);
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < nc; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < NM; ++m) acc = fmaf(s_coef[i][m], pr[m], acc);
      float v = 1.f / (1.f + expf(-acc));
      if (crop) {
        const float4 bx = s_box[i];
        const bool inside = px >= bx.x && px < bx.z && py >= bx.y && py < bx.w;
        v = inside ? v : 0.f;
      }
      if (use_threshold) v = v > threshold ? 1.f : 0.f;
      ob[static_cast<size_t>(n0 + i) * P + p] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Only
// nm == 32 is compiled (the YOLO segment head's prototype count); the Python
// wrapper refuses other widths before calling.
int proto_decode_f32(const float* protos, const float* coeffs, const float* boxes, float* out,
                     int B, int N, int nm, int Hp, int Wp, int crop, int use_threshold,
                     float threshold, void* stream) {
  if (nm != 32) return static_cast<int>(cudaErrorInvalidValue);
  const int P = Hp * Wp;
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  proto_decode_kernel<32><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      protos, coeffs, boxes, out, N, Wp, P, crop, use_threshold, threshold);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
