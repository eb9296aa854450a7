// Memory-attention readout for Hopper (sm_90a): online softmax over the memory,
// fp32 or bf16 inputs, fp32 logits, statistics and accumulators.
//
// Replaces the TPU kernel yolo_puncture_tpu/ops/pallas/mem_attention.py:_kernel
// (memory_readout_pallas).  For every object o and query row q:
//
//   s_m  = valid[m] ? dot(query[q, :], keys[m, :]) * Ck^-0.5 : -inf
//   out[o, q, :] = sum_m exp(s_m - max_m s) * values[o, m, :] / max(sum_m exp(s_m - max s), 1e-9)
//
// computed in one pass over the memory with a running max and sum, the
// accumulator rescaled whenever the max moves.  A row with no valid element
// never leaves max = -inf: its shift is taken as 0, every p is exp(-inf) = 0,
// and the result is 0 / 1e-9 = exact 0, never NaN.
//
// Layouts (contiguous, T = float or __nv_bfloat16, one type for all three):
//   query (Q, 64)   keys (M, 64)   values (No, M, CV)   valid (M,) one byte each
//   out (No, Q, CV) in T.  CV = 128, the published value width (a template
//   parameter, any multiple of 64).
//
// Bound: operations.  At the serving window (Q = 8100, M = 12968, No = 4,
// CV = 128) the function needs 2*Q*M*(64 + No*CV) = 121 GFLOP against 33 MB of
// inputs and 17 MB of output: 1.8 ms at the H100's 67 TFLOP/s fp32 rate outside
// the tensor cores (TF32 is not used), 0.015 ms for the bytes.
//
// Design.  No*CV = 512 accumulator columns per query are too many for one
// block's registers at a useful query tile, so the object goes on the grid: a
// block owns 64 queries of ONE object, and the 64-wide logits are recomputed
// for each object.  That is 2*Q*M*No*(64 + CV) = 161 GFLOP, a third more than
// the bound counts, and buys four times as many blocks: at the per-frame shape
// (Q = 1620) the grid is 26 x 4 = 104 blocks instead of 26 on 132 SMs, and each
// thread keeps 32 accumulators instead of 128, so two blocks fit on an SM and
// one block's loads overlap the other's arithmetic.  The alternative, all
// objects in one block with CV split over the warps, saves the recomputation
// but leaves three quarters of the card idle per frame.
//
// A block of 256 threads is a 16 x 16 grid: thread (ty, tx) owns query rows
// 4*ty .. 4*ty+3; in the logit tile it owns memory columns tx + 16*j, in the
// accumulator value columns 64*h + 4*tx .. +3.  The 16 threads that share a row
// are half a warp, so the row max and row sum are four shuffles.  Key and value
// tiles of 64 memory elements are staged through shared memory as fp32 (bf16
// is widened on the way in), edges are bounds-checked instead of padded, and a
// tile with no valid element is skipped before its keys and values are read:
// while the ring is filling, the work follows the number of valid slots.
// Tensor cores (wgmma on bf16) and TMA are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int CK = 64;        // key width
constexpr int TQ = 64;        // queries per block
constexpr int TM = 64;        // memory elements per tile
constexpr int LDK = CK + 4;   // padded row of the query and key tiles
constexpr int LDP = TM + 4;   // padded row of the weight tile

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

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int CV>
constexpr size_t shared_bytes() {
  return sizeof(float) * (TQ * LDK + TM * LDK + TM * CV + TQ * LDP);
}

template <typename T, int CV>
__global__ void __launch_bounds__(kThreads, 2)
memory_readout_kernel(const T* __restrict__ query, const T* __restrict__ keys,
                      const T* __restrict__ values, const unsigned char* __restrict__ valid,
                      T* __restrict__ out, int Q, int M, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // (TQ, LDK)
  float* Ks = Qs + TQ * LDK;         // (TM, LDK)
  float* Vs = Ks + TM * LDK;         // (TM, CV)
  float* Ps = Vs + TM * CV;          // (TQ, LDP)
  __shared__ unsigned char s_valid[TM];

  constexpr int NH = CV / 64;        // 4-column groups per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  const int obj = blockIdx.y;
  const T* vbase = values + static_cast<size_t>(obj) * M * CV;

  for (int i = tid; i < TQ * (CK / 4); i += kThreads) {
    const int r = i / (CK / 4), c4 = i % (CK / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Q) v = load4(query + static_cast<size_t>(q0 + r) * CK + c4 * 4);
    *reinterpret_cast<float4*>(Qs + r * LDK + c4 * 4) = v;
  }

  float m_run[4], l_run[4], acc[4][NH * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NH * 4; ++c) acc[i][c] = 0.f;
  }

  for (int m0 = 0; m0 < M; m0 += TM) {
    __syncthreads();  // the previous tile is no longer read (and Qs is written)
    int any = 0;
    if (tid < TM) {
      const int m = m0 + tid;
      const unsigned char v = m < M ? valid[m] : 0;
      s_valid[tid] = v;
      any = v;
    }
    if (!__syncthreads_or(any)) continue;  // every element masked: the tile adds nothing

    for (int i = tid; i < TM * (CK / 4); i += kThreads) {
      const int r = i / (CK / 4), c4 = i % (CK / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) v = load4(keys + static_cast<size_t>(m0 + r) * CK + c4 * 4);
      *reinterpret_cast<float4*>(Ks + r * LDK + c4 * 4) = v;
    }
    for (int i = tid; i < TM * (CV / 4); i += kThreads) {
      const int r = i / (CV / 4), c4 = i % (CV / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) v = load4(vbase + static_cast<size_t>(m0 + r) * CV + c4 * 4);
      *reinterpret_cast<float4*>(Vs + r * CV + c4 * 4) = v;
    }
    __syncthreads();

    // logits: rows 4*ty + i, memory columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < CK; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LDK + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDK + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax: the 16 threads of a row are half a warp
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s_valid[tx + 16 * j] ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float shift = m_new == -INFINITY ? 0.f : m_new;       // a row still fully masked
      const float c = m_run[i] == -INFINITY ? 0.f : expf(m_run[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - shift);                    // exp(-inf) = 0 where masked
        rs += p;
        Ps[(4 * ty + i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run[i] = l_run[i] * c + rs;
      m_run[i] = m_new;
      corr[i] = c;
    }
    __syncthreads();

    // accumulate: rows 4*ty + i, value columns 64*h + 4*tx .. +3
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NH * 4; ++c) acc[i][c] *= corr[i];
#pragma unroll 2
    for (int m = 0; m < TM; m += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * LDP + m);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(Vs + (m + mm) * CV + 64 * h + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = pick(p[i], mm);
            acc[i][4 * h + 0] = fmaf(pv, v.x, acc[i][4 * h + 0]);
            acc[i][4 * h + 1] = fmaf(pv, v.y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(pv, v.z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(pv, v.w, acc[i][4 * h + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Q) continue;
    const float denom = fmaxf(l_run[i], 1e-9f);
    T* dst = out + (static_cast<size_t>(obj) * Q + row) * CV;
#pragma unroll
    for (int h = 0; h < NH; ++h)
      store4(dst + 64 * h + 4 * tx,
             make_float4(acc[i][4 * h + 0] / denom, acc[i][4 * h + 1] / denom,
                         acc[i][4 * h + 2] / denom, acc[i][4 * h + 3] / denom));
  }
}

template <typename T, int CV>
int launch(const void* query, const void* keys, const void* values, const void* valid, void* out,
           int Q, int M, int No, cudaStream_t stream) {
  auto kernel = memory_readout_kernel<T, CV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared_bytes<CV>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Q + TQ - 1) / TQ, No);
  kernel<<<grid, kThreads, shared_bytes<CV>(), stream>>>(
      static_cast<const T*>(query), static_cast<const T*>(keys), static_cast<const T*>(values),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out), Q, M, 1.f / sqrtf(static_cast<float>(CK)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error code (0 on success).  Compiled
// for Ck == 64 and Cv == 128; the Python wrapper refuses other widths before
// calling.  No <= 65535 (a grid dimension).
int memory_readout(const void* query, const void* keys, const void* values, const void* valid,
                   void* out, int Q, int M, int No, int Ck, int Cv, int is_bf16, void* stream) {
  if (Ck != CK || Cv != 128 || No > 65535 || Q <= 0 || M <= 0 || No <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16, 128>(query, keys, values, valid, out, Q, M, No, s);
  return launch<float, 128>(query, keys, values, valid, out, Q, M, No, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
