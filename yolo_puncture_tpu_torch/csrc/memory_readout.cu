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
// never leaves max = -inf: its shift is taken as 0, every p is 2^-inf = 0, and
// the result is 0 / 1e-9 = exact 0, never NaN.
//
// Layouts (contiguous, T = float or __nv_bfloat16, one type for all three):
//   query (Q, 64)   keys (M, 64)   values (No, M, 128)   valid (M,) one byte each
//   out (No, Q, 128) in T.
//
// With affinity_bf16 each logit is rounded as the JAX package's dense readout
// rounds its (Q, M) affinity (yolo_puncture_tpu/track/network.py
// memory_readout_dense): s_m = bf16(bf16(dot) * bf16(Ck^-0.5)), for fp32 and
// bf16 inputs alike.  The max, the sum and the accumulators stay fp32.
//
// Bound: operations.  At the serving window (Q = 8100, M = 12968 of which 12960
// valid, No = 4) the function needs 2*Q*M*(64 + No*128) = 121 GFLOP against
// 24 MB (bf16) or 49 MB (fp32) of inputs and outputs:
//   bf16   121 GFLOP / 989 TFLOP/s (tensor cores, dense)      = 0.122 ms
//   fp32   3 * 121 GFLOP / 495 TFLOP/s (TF32 tensor cores, three products per
//          fp32 product, see below)                           = 0.733 ms
// and 0.007 to 0.015 ms for the bytes.
//
// Design, common to both types.
//   * The softmax weights do not depend on the object, so a block computes the
//     logits, the running max, the sum and p once for its query tile and
//     multiplies p into the values of every object it owns.  A block owns 128
//     query rows and a PAIR of objects: 2 * 128 = 256 accumulator columns, 128
//     fp32 registers a thread.  Object pairs go on the grid, so with four
//     objects the logits are computed twice (not four times): 2*Q*M*(2*64 + 512)
//     = 134 GFLOP for the 121 the function needs, and a block moves 320 values
//     from L2 per memory element for 128 rows instead of 576 for 64.  Any
//     number of objects is ceil(No / 2) pairs; the missing half of an odd pair
//     is read as zeros and not stored.
//   * A pre-pass packs the validity bytes into one 64-bit word per tile of 64
//     memory elements (element m of the tile is bit m; elements beyond M are 0).
//     The producer scans 32 words at a time and never loads a tile whose word
//     is 0: while the ring is filling, the work follows the valid slots.
//   * 384 threads: two consumer warpgroups of 64 rows each and one producer
//     warp, which gives its registers to the consumers (setmaxnreg).  The
//     producer walks the valid tiles and, for each, waits for a free stage of the
//     ring in shared memory, posts the tile's number and validity bits into the
//     stage and starts TMA loads with the 128-byte swizzle, which complete on the
//     stage's mbarrier; after the last tile it posts -1.  A consumer waits for the
//     stage, multiplies with wgmma, and releases it.  Ragged edges are zero-filled
//     by the TMA and masked by the validity bits.
//   * p never goes through shared memory: the accumulator fragment of the first
//     product has the layout of an A fragment of the second.
//   * When the grid over (query tiles, object pairs) would leave most of the 132
//     SMs idle (one frame: 13 x 2 blocks), the memory is split over blockIdx.z.
//     Each split writes its running max, its sum and its unnormalised
//     accumulator to scratch and combine_kernel merges them:
//       out = sum_z 2^(m_z - m*) acc_z / max(sum_z 2^(m_z - m*) l_z, 1e-9).
//     The number of splits comes from the caller and depends on Q alone.
//   * Exponentials are taken in base 2 (ex2.approx, relative error 2^-22): the
//     logits are scaled by Ck^-0.5 * log2(e), and the max that the splits
//     exchange is in that unit.
//
// bf16 (readout_bf16_kernel).  A stage is a tile of 64 memory elements: the key
// tile and four 64-column halves of the two objects' values, 40 KB, four stages.
// S = Q K^T is four wgmma m64n64k16 (both operands K-major in shared memory);
// after the softmax on its 32 logits a thread rounds p to bf16 (the sum is taken
// from the fp32 p, as the TPU kernel does); P V is four wgmma m64n256k16 with p in
// registers and V MN-major in shared memory (the descriptor's transpose bit).
//
// fp32 (readout_fp32_kernel).  fp32 in, fp32-class result out, on the tensor
// cores with error-compensated TF32 ("3xTF32"): every operand x is split into
// hi = tf32(x) and lo = x - hi, and a*b is taken as lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b with fp32 accumulation; the dropped lo*lo term is 2^-22 of the
// product.  wgmma reads B (and here A of the first product) from shared memory,
// so the split cannot happen on the way into registers, and it takes a TF32 B
// only with k contiguous, which for the second product is the memory index.
// So a pre-pass writes to scratch, once per call: hi and lo planes of the query
// and the keys (split_kernel), and hi and lo planes of the values TRANSPOSED to
// (No, 128, M) (split_values_kernel; tiles with no valid element skipped).  The
// main kernel then has the bf16 kernel's shape: a stage is 32 memory elements
// (one 128-byte row of TF32), 16 KB of keys and 64 KB of values, two stages
// beside 64 KB of query.  S is 3 x 8 wgmma m64n32k8; P V is, for each 64 columns,
// 3 x 4 wgmma m64n64k8 with the split p in registers.  Two details: the memory
// elements of each group of 8 are stored in the order 0 2 4 6 1 3 5 7, so that
// the logit fragment (columns 2c, 2c + 1) is the A fragment (k slots c, c + 4) as
// it stands; and the tensor core truncates when it adds into its accumulator,
// which against a long-running sum is a bias of 1e-4 relative over 13 k
// elements, so each stage's product is summed from zero and added to the
// running accumulator with an ordinary rounded add.

#include <cuda.h>  // CUtensorMap and its enums; the encoder in libcuda is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CK = 64;         // key width
// a power of 4, so that Ck^-0.5 is a power of two: the bf16 affinity's scale is then
// exact (online_softmax)
static_assert(CK > 0 && (CK & (CK - 1)) == 0 && (CK & 0x55555555) != 0, "Ck must be a power of 4");
constexpr int CV = 128;        // value width
constexpr int TM = 64;         // memory elements per tile (one validity word)
constexpr int TQ = 128;        // query rows per block
constexpr int NCOL = 2 * CV;   // accumulator columns of a block: an object pair
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// validity words and the scan over them

__global__ void pack_valid_kernel(const unsigned char* __restrict__ valid,
                                  unsigned long long* __restrict__ words, int M, int n_tiles) {
  const int tile = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const int m = tile * TM + lane;
  const unsigned lo = __ballot_sync(kFull, m < M && valid[m] != 0);
  const unsigned hi = __ballot_sync(kFull, m + 32 < M && valid[m + 32] != 0);
  if (lane == 0) words[tile] = static_cast<unsigned long long>(lo) | (static_cast<unsigned long long>(hi) << 32);
}

// Walks the tiles of [begin, end) whose validity word is not 0.  The 32 lanes of
// a warp call next() together; every warp that walks the same range sees the
// same tiles.
struct TileScan {
  const unsigned long long* words;
  int base, end;
  unsigned pending;
  unsigned long long word;

  __device__ TileScan(const unsigned long long* w, int begin, int end_)
      : words(w), base(begin - 32), end(end_), pending(0), word(0) {}

  __device__ bool next(int& tile, unsigned long long& mask) {
    const int lane = threadIdx.x & 31;
    while (pending == 0) {
      base += 32;
      if (base >= end) return false;
      word = base + lane < end ? words[base + lane] : 0ull;
      pending = __ballot_sync(kFull, word != 0ull);
    }
    const int i = __ffs(pending) - 1;
    pending &= pending - 1;
    tile = base + i;
    mask = __shfl_sync(kFull, word, i);
    return true;
  }
};

// ---------------------------------------------------------------------------
// the softmax step both kernels share

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s is a thread's fragment of a (64, 8 * NT) logit tile as wgmma lays it out: with
// g = lane / 4 and c = lane % 4, s[4j + 2r + e] is row g + 8r of the warp's 16
// rows, column 8j + 2c + e.  Scales and masks the logits (bit m of mask: column
// m is valid), updates the running max and sum of the thread's two rows, leaves
// p in s and the factor for the accumulator in corr.  Logits are in base-2
// units: s * c2 with c2 = Ck^-0.5 * log2(e); or, with kAffinity (the bf16
// affinity), bf16(s) * c2.  That is bf16(bf16(s) * bf16(Ck^-0.5)) * log2(e) bit
// for bit: Ck^-0.5 is a power of two, so bf16(Ck^-0.5) = Ck^-0.5, the product
// with it is exact and needs no second rounding, and c2 is log2(e) scaled
// exactly.  The option is a template parameter: as a run-time branch in this loop it cost the
// bf16 kernel a fifth of its time with the option off (0.326 against 0.271 ms
// at the serving window on an H100 80GB HBM3 at 700 W).
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int NT, bool kAffinity>
__device__ __forceinline__ void online_softmax(float (&s)[4 * NT], unsigned long long mask, float c2,
                                               float (&m_run)[2], float (&l_run)[2], float (&corr)[2]) {
  const bool all_valid = mask == (NT == 8 ? ~0ull : (1ull << (8 * NT % 64)) - 1ull);
  const unsigned long long mine = mask >> (2 * (threadIdx.x & 3));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[4 * j + 2 * r + e];
        v = kAffinity ? round_bf16(v) * c2 : v * c2;
        if (!all_valid && !((mine >> (8 * j + e)) & 1ull)) v = -INFINITY;
        s[4 * j + 2 * r + e] = v;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    const float shift = m_new == -INFINITY ? 0.f : m_new;  // a row still fully masked
    corr[r] = fast_exp2(m_run[r] - shift);                  // 0 while the old max is -inf
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(s[4 * j + 2 * r + e] - shift);  // 2^-inf = 0 where masked
        s[4 * j + 2 * r + e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(kFull, rs, 1);
    rs += __shfl_xor_sync(kFull, rs, 2);
    l_run[r] = l_run[r] * corr[r] + rs;
    m_run[r] = m_new;
  }
}

// acc[4j + 2r + e] is row g + 8r, column 8j + 2c + e of the block's 256 columns.
// Multiplies by the softmax correction, skipped when no row of the warp moved.
__device__ __forceinline__ void rescale(float (&acc)[128], const float (&corr)[2]) {
  if (!__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    acc[4 * j + 0] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
}

// Makes the registers opaque to the compiler at this point: it neither moves
// their reads and writes across an asynchronous wgmma that still owns them, nor
// reuses what it computed from them before.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Writes a thread's two rows (row0 and row0 + 8): the result when the memory is
// not split, else the split's unnormalised accumulator and (object pair 0 only)
// its max and sum.
template <typename T>
__device__ __forceinline__ void write_rows(const float (&acc)[128], const float (&m_run)[2],
                                           const float (&l_run)[2], int row0, int Q, int No,
                                           T* __restrict__ out, float* __restrict__ part_acc,
                                           float* __restrict__ part_stats) {
  const int c = threadIdx.x & 3;
  const int obj0 = 2 * blockIdx.y;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Q) continue;
    const float inv = split ? 1.f : 1.f / fmaxf(l_run[r], 1e-9f);
    if (split && blockIdx.y == 0 && c == 0)
      store2(part_stats + (static_cast<size_t>(blockIdx.z) * Q + row) * 2, m_run[r], l_run[r]);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int obj = obj0 + j / 16;
      if (obj >= No) continue;
      const int col = 8 * (j % 16) + 2 * c;
      const float a = acc[4 * j + 2 * r] * inv, b = acc[4 * j + 2 * r + 1] * inv;
      if (split)
        store2(part_acc + ((static_cast<size_t>(blockIdx.z) * No + obj) * Q + row) * CV + col, a, b);
      else
        store2(out + (static_cast<size_t>(obj) * Q + row) * CV + col, a, b);
    }
  }
}

// One thread per (object, query row, four columns): merges the splits.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_stats,
                               T* __restrict__ out, int Q, int No, int n_split) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(No) * Q * (CV / 4)) return;
  const int c4 = static_cast<int>(idx % (CV / 4));
  const int q = static_cast<int>((idx / (CV / 4)) % Q);
  const int obj = static_cast<int>(idx / (CV / 4) / Q);
  float m_all = -INFINITY;
  for (int z = 0; z < n_split; ++z) m_all = fmaxf(m_all, part_stats[(static_cast<size_t>(z) * Q + q) * 2]);
  const float shift = m_all == -INFINITY ? 0.f : m_all;
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < n_split; ++z) {
    const float2 st = *reinterpret_cast<const float2*>(part_stats + (static_cast<size_t>(z) * Q + q) * 2);
    const float w = fast_exp2(st.x - shift);
    if (w == 0.f) continue;  // a split with no valid element, or one far below the max
    const float4 v = *reinterpret_cast<const float4*>(
        part_acc + ((static_cast<size_t>(z) * No + obj) * Q + q) * CV + 4 * c4);
    l += w * st.y;
    a.x += w * v.x;
    a.y += w * v.y;
    a.z += w * v.z;
    a.w += w * v.w;
  }
  const float inv = 1.f / fmaxf(l, 1e-9f);
  T* dst = out + (static_cast<size_t>(obj) * Q + q) * CV + 4 * c4;
  store2(dst, a.x * inv, a.y * inv);
  store2(dst + 2, a.z * inv, a.w * inv);
}

// ---------------------------------------------------------------------------
// TMA, mbarriers, wgmma and the ring both kernels run on

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets in units of 16 bytes, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead_bytes, uint32_t stride_bytes) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(stride_bytes >> 4) << 32) | (1ull << 62);
}

// A K-major tile whose rows are 128 bytes (64 bf16 or 32 TF32): 8 rows are 1024 bytes
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return make_desc(addr, 16, 1024); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

#define MR_F8(d, i)                                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MR_F32(d, i) MR_F8(d, i), MR_F8(d, i + 8), MR_F8(d, i + 16), MR_F8(d, i + 24)

// The ring in shared memory: per stage a "full" barrier (the producer's arrive plus
// the bytes it announced), an "empty" barrier (one lane of each of the eight
// consumer warps), the tile's number (-1: the end mark) and its validity bits.
template <int STAGES>
struct Ring {
  static constexpr int kBytes = 8 * (1 + 2 * STAGES) + 16 * STAGES;
  uint32_t q_bar, full, empty;  // shared-memory addresses; a stage's barrier is + 8 * stage
  volatile long long* tile;
  volatile unsigned long long* mask;

  __device__ explicit Ring(uint8_t* base) {
    q_bar = smem_u32(base);
    full = q_bar + 8;
    empty = full + 8 * STAGES;
    tile = reinterpret_cast<volatile long long*>(base + 8 * (1 + 2 * STAGES));
    mask = reinterpret_cast<volatile unsigned long long*>(tile + STAGES);
  }

  // one thread, before the block's __syncthreads()
  __device__ void init() const {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
};

// The producer warp: lane 0 waits for the stage to be free, posts the tile and has
// load(stage, full barrier) start the copies, which complete on that barrier;
// tile < 0 is the end mark and carries no bytes.  All lanes move on to the next stage.
template <int STAGES, typename Load>
__device__ __forceinline__ void ring_post(const Ring<STAGES>& ring, int& stage, uint32_t& phase, int tile,
                                          unsigned long long mask, int bytes, Load load) {
  if ((threadIdx.x & 31) == 0) {
    mbar_wait(ring.empty + 8 * stage, phase);
    ring.tile[stage] = tile;
    ring.mask[stage] = mask;
    const uint32_t full = ring.full + 8 * stage;
    if (tile >= 0) {
      mbar_expect_tx(full, bytes);
      load(stage, full);
    } else {
      mbar_arrive(full);
    }
  }
  __syncwarp();
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// the 128-byte swizzle repeats every 1024 bytes of ADDRESS: the tiles start on one
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

constexpr int kThreads = 384;  // two consumer warpgroups and the producer's

// ---------------------------------------------------------------------------
// bf16

namespace bf {

constexpr int kStages = 4;
constexpr int kQBytes = TQ * CK * 2;             // 16 KB
constexpr int kKBytes = TM * CK * 2;             // 8 KB
constexpr int kVBox = TM * 64 * 2;               // one 64-column half of one object's values: 8 KB
constexpr int kStageBytes = kKBytes + 4 * kVBox; // 40 KB
constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
constexpr int kSmemBytes = kBarOffset + Ring<kStages>::kBytes + 1024;

// d (64 x 64, fp32) = or += A (64 x 16, K-major in shared memory) * B^T (64 x 16, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : MR_F32(d, 0)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 256, fp32) += A (64 x 16 bf16 in registers) * B (16 x 256, MN-major in shared memory)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : MR_F32(d, 0), MR_F32(d, 32), MR_F32(d, 64), MR_F32(d, 96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool kAffinity>
__global__ void __launch_bounds__(kThreads, 1)
readout_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const unsigned long long* __restrict__ words,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_stats,
                    int Q, int No, int n_tiles, int tiles_per_split, float c2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t q_smem = smem_u32(smem);
  const uint32_t stage_smem = q_smem + kQBytes;
  const Ring<kStages> ring(smem + kBarOffset);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TQ;
  const int obj0 = 2 * blockIdx.y;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: one warp works, all four give up their registers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(ring.q_bar, kQBytes);
        tma_load(q_smem, &map_q, ring.q_bar, 0, q0);
      }
      auto load = [&](int stage, uint32_t full) {
        const uint32_t k_smem = stage_smem + stage * kStageBytes;
        const int m0 = static_cast<int>(ring.tile[stage]) * TM;
        tma_load(k_smem, &map_k, full, 0, m0);
#pragma unroll
        for (int b = 0; b < 4; ++b)  // box b: object obj0 + b / 2, columns 64 * (b % 2) ..
          tma_load(k_smem + kKBytes + b * kVBox, &map_v, full, 64 * (b & 1), m0, obj0 + (b >> 1));
      };
      TileScan scan(words, t_begin, t_end);
      int stage = 0, tile;
      uint32_t phase = 1;  // the stages start empty: the first round of waits passes
      unsigned long long mask;
      while (scan.next(tile, mask)) ring_post(ring, stage, phase, tile, mask, kStageBytes, load);
      ring_post(ring, stage, phase, -1, 0ull, 0, load);
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    mbar_wait(ring.q_bar, 0);
    const uint64_t q_desc = kmajor_desc(q_smem + (warp >> 2) * (64 * CK * 2));
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(ring.full + 8 * stage, phase);
      if (ring.tile[stage] < 0) break;
      const unsigned long long mask = ring.mask[stage];
      const uint32_t k_smem = stage_smem + stage * kStageBytes;

      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      const uint64_t k_desc = kmajor_desc(k_smem);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk)  // 16 keys are 32 bytes of the row
        wgmma_m64n64k16_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk != 0);
      wgmma_commit();
      wgmma_wait();
      pin(s);

      float corr[2];
      online_softmax<8, kAffinity>(s, mask, c2, m_run, l_run, corr);
      uint32_t p[16];  // the A fragments of the four k16 steps
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      rescale(acc, corr);

      // MN-major values: 64 columns (128 bytes) a row, the next 64-column box kVBox
      // further, 8 memory rows are 1024 bytes; 16 memory rows (one k16 step) 2048
      const uint64_t v_desc = make_desc(k_smem + kKBytes, kVBox, 1024);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TM / 16; ++kk) wgmma_m64n256k16_rs(acc, p + 4 * kk, v_desc + kk * (2048 >> 4));
      wgmma_commit();
      wgmma_wait();
      pin(acc);

      if (lane == 0) mbar_arrive(ring.empty + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    write_rows(acc, m_run, l_run, q0 + 16 * warp + (lane >> 2), Q, No, out, part_acc, part_stats);
  }
}

}  // namespace bf

// ---------------------------------------------------------------------------
// fp32 as three TF32 products

namespace fp {

constexpr int TK = 32;                               // memory elements per stage: a 128-byte row of TF32
constexpr int kStages = 2;
constexpr int kQBox = TQ * 128;                      // 128 rows of 32 keys: 16 KB
constexpr int kQBytes = 4 * kQBox;                   // hi and lo planes, two halves of the 64 keys: 64 KB
constexpr int kKBox = TK * 128;                      // 4 KB
constexpr int kKBytes = 4 * kKBox;                   // 16 KB
constexpr int kVPlane = NCOL * 128;                  // 256 rows (object pair x 128 columns) of 32 elements: 32 KB
constexpr int kStageBytes = kKBytes + 2 * kVPlane;   // 80 KB
constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
constexpr int kSmemBytes = kBarOffset + Ring<kStages>::kBytes + 1024;

// hi = x rounded to TF32 (10 mantissa bits, ties away from zero), lo = x - hi, which is
// exact; the tensor core drops the low 13 bits of lo.  The rounding is two integer
// operations on the bits: cvt.rna.tf32.f32 gives the same hi at a sixteenth of the rate.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

// Where memory element i of a group of 8 sits in the transposed values, so that the
// logit fragment is the A fragment of the second product as it stands: a thread
// holds columns 2c and 2c + 1 of the logits, and k slots c and c + 4 of A.
__device__ __forceinline__ int k_slot(int i) { return (i & ~7) | ((i & 1) << 2) | ((i & 7) >> 1); }

// dst[0][i] = hi(x[i]), dst[1][i] = lo(x[i]), four values a thread
__global__ void split_kernel(const float* __restrict__ x, float* __restrict__ dst, size_t n) {
  const size_t i = 4 * (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  float4 hi, lo;
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
  *reinterpret_cast<float4*>(dst + i) = hi;
  *reinterpret_cast<float4*>(dst + n + i) = lo;
}

// values (No, M, 128) -> dst (2, No, 128, Mp): hi and lo planes, transposed (wgmma takes
// a TF32 B operand only with k contiguous), the memory elements of each group of 8 in
// k_slot order, zeros beyond M.  One block per (tile of 64 elements, object); a tile
// with no valid element is left as it is and never read.
__global__ void split_values_kernel(const float* __restrict__ values, const unsigned long long* __restrict__ words,
                                    float* __restrict__ dst, int M, int Mp, int No) {
  __shared__ float t[TM][CV + 1];
  const int tile = blockIdx.x, obj = blockIdx.y;
  if (words[tile] == 0ull) return;
  const int m0 = tile * TM;
  for (int i = threadIdx.x; i < TM * (CV / 4); i += blockDim.x) {
    const int r = i / (CV / 4), c4 = i % (CV / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < M) v = *reinterpret_cast<const float4*>(values + (static_cast<size_t>(obj) * M + m0 + r) * CV + 4 * c4);
    t[r][4 * c4 + 0] = v.x;
    t[r][4 * c4 + 1] = v.y;
    t[r][4 * c4 + 2] = v.z;
    t[r][4 * c4 + 3] = v.w;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(No) * CV * Mp;
  for (int i = threadIdx.x; i < CV * TM; i += blockDim.x) {
    const int n = i / TM, m = i % TM;  // a warp reads 32 rows of one column: 32 banks
    float hi, lo;
    split_tf32(t[m][n], hi, lo);
    const size_t at = (static_cast<size_t>(obj) * CV + n) * Mp + m0 + k_slot(m);
    dst[at] = hi;
    dst[plane + at] = lo;
  }
}

// d (64 x 32, fp32) = or += A (64 x 8 TF32, K-major in shared memory) * B^T (32 x 8, K-major)
__device__ __forceinline__ void wgmma_m64n32k8_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : MR_F8(d, 0), MR_F8(d, 8)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) = or += A (64 x 8 TF32 in registers) * B^T (64 x 8, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32], const float* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : MR_F32(d, 0)
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc_b), "r"(accumulate));
}

template <bool kAffinity>
__global__ void __launch_bounds__(kThreads, 1)
readout_fp32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const unsigned long long* __restrict__ words,
                    float* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_stats,
                    int Q, int No, int n_tiles, int tiles_per_split, float c2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  // query: box 2 * plane + half; a stage: the keys' four boxes likewise, then the
  // values' hi plane and lo plane
  const uint32_t q_smem = smem_u32(smem);
  const uint32_t stage_smem = q_smem + kQBytes;
  const Ring<kStages> ring(smem + kBarOffset);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TQ;
  const int obj0 = 2 * blockIdx.y;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(ring.q_bar, kQBytes);
#pragma unroll
        for (int b = 0; b < 4; ++b) tma_load(q_smem + b * kQBox, &map_q, ring.q_bar, 32 * (b & 1), q0, b >> 1);
      }
      auto load = [&](int stage, uint32_t full) {
        const uint32_t k_smem = stage_smem + stage * kStageBytes;
        const int m0 = static_cast<int>(ring.tile[stage]) * TK;
#pragma unroll
        for (int b = 0; b < 4; ++b) tma_load(k_smem + b * kKBox, &map_k, full, 32 * (b & 1), m0, b >> 1);
#pragma unroll
        for (int plane = 0; plane < 2; ++plane)
          tma_load(k_smem + kKBytes + plane * kVPlane, &map_v, full, m0, 0, obj0, plane);
      };
      TileScan scan(words, t_begin, t_end);
      int stage = 0, tile;
      uint32_t phase = 1;
      unsigned long long mask;
      while (scan.next(tile, mask)) {  // a stage is half a tile
        if (mask & 0xffffffffull) ring_post(ring, stage, phase, 2 * tile, mask & 0xffffffffull, kStageBytes, load);
        if (mask >> 32) ring_post(ring, stage, phase, 2 * tile + 1, mask >> 32, kStageBytes, load);
      }
      ring_post(ring, stage, phase, -1, 0ull, 0, load);
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;");  // measured: 3 % faster than 232
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    mbar_wait(ring.q_bar, 0);
    const uint32_t q_rows = q_smem + (warp >> 2) * (64 * 128);  // the warpgroup's rows of each box
    int stage = 0;
    uint32_t phase = 0;
    for (;;) {
      mbar_wait(ring.full + 8 * stage, phase);
      if (ring.tile[stage] < 0) break;
      const unsigned long long mask = ring.mask[stage];
      const uint32_t k_smem = stage_smem + stage * kStageBytes;

      // logits = q k^T as lo*hi + hi*lo + hi*hi (plane 0 is hi, 1 is lo), eight k8 steps each:
      // 8 keys are 32 bytes of a row, the second 32 keys are the next box
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int prod = 0; prod < 3; ++prod)
#pragma unroll
        for (int kk = 0; kk < CK / 8; ++kk) {
          const int box_a = 2 * (prod == 0) + kk / 4, box_b = 2 * (prod == 1) + kk / 4;
          wgmma_m64n32k8_ss(s, kmajor_desc(q_rows + box_a * kQBox + 32 * (kk % 4)),
                            kmajor_desc(k_smem + box_b * kKBox + 32 * (kk % 4)), prod + kk != 0);
        }
      wgmma_commit();
      wgmma_wait();
      pin(s);

      float corr[2];
      online_softmax<4, kAffinity>(s, mask, c2, m_run, l_run, corr);
      // A fragments of the four k8 steps: rows g and g + 8 at k slot c, then at slot c + 4
      float ph[16], pl[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(s[4 * j + 0], ph[4 * j + 0], pl[4 * j + 0]);
        split_tf32(s[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
        split_tf32(s[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
        split_tf32(s[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
      }
      rescale(acc, corr);

      // acc += p V, 64 columns at a time.  The tensor core truncates when it adds into
      // its accumulator, and against the long-running sum that is a bias of 1e-4
      // relative over 13 k elements; so the stage's product is summed from zero and
      // added to acc with a rounded fp32 add.
      const uint32_t v_smem = k_smem + kKBytes;
#pragma unroll
      for (int h = 0; h < NCOL / 64; ++h) {
        float part[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int prod = 0; prod < 3; ++prod)
#pragma unroll
          for (int kk = 0; kk < TK / 8; ++kk)
            wgmma_m64n64k8_rs(part, (prod == 0 ? pl : ph) + 4 * kk,
                              kmajor_desc(v_smem + (prod == 1) * kVPlane + h * (64 * 128) + 32 * kk), prod + kk != 0);
        wgmma_commit();
        wgmma_wait();
        pin(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[32 * h + i] += part[i];
      }

      if (lane == 0) mbar_arrive(ring.empty + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    write_rows(acc, m_run, l_run, q0 + 16 * warp + (lane >> 2), Q, No, out, part_acc, part_stats);
  }
}

}  // namespace fp

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

// A contiguous tensor of up to four dimensions (innermost first) cut into boxes with
// the 128-byte swizzle; elements outside the tensor read as zeros.
struct TensorMap {
  CUtensorMap map;
  bool ok;

  TensorMap(const void* base, bool bf16, int rank, const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4]) {
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    cuuint64_t strides[3];
    cuuint64_t bytes = bf16 ? 2 : 4;
    for (int i = 0; i < 3; ++i) strides[i] = bytes *= dims[i];
    ok = encode_tiled()(&map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                        const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
};

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// Launches on `stream`: the validity pre-pass, for fp32 the split of the operands,
// the readout and, if n_split > 1, the combine.  affinity_bf16 != 0 rounds the
// logits to bf16 as the header says, for either type.  Returns the CUDA error code (0 on
// success).  Compiled for Ck == 64 and Cv == 128; the Python wrapper refuses other
// widths before calling.  Scratch, all of it written before it is read:
//   words     ceil(M / 64) 64-bit words
//   partials  n_split * (No * Q * 128 + Q * 2) floats when n_split > 1, else unused
//   split     fp32 only: 2 * (Q * 64 + M * 64 + No * 128 * 64 * ceil(M / 64)) floats
// No <= 131070.
int memory_readout(const void* query, const void* keys, const void* values, const void* valid, void* out,
                   void* words, void* partials, void* split, int Q, int M, int No, int Ck, int Cv, int is_bf16,
                   int affinity_bf16, int n_split, void* stream) {
  const int n_tiles = (M + TM - 1) / TM;
  const int pairs = (No + 1) / 2;
  if (Ck != CK || Cv != CV || Q <= 0 || M <= 0 || No <= 0 || pairs > 65535 || n_split < 1 || n_split > 65535 ||
      (n_split > 1 && partials == nullptr) || (!is_bf16 && split == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* w = static_cast<unsigned long long*>(words);
  float* part_acc = static_cast<float*>(partials);
  float* part_stats = part_acc + static_cast<size_t>(n_split) * No * Q * CV;
  const int tiles_per_split = (n_tiles + n_split - 1) / n_split;
  const float c2 = 1.4426950408889634f / sqrtf(static_cast<float>(CK));
  const dim3 grid((Q + TQ - 1) / TQ, pairs, n_split);
  const cuuint64_t uQ = Q, uM = M, uNo = No;

  pack_valid_kernel<<<(n_tiles + 7) / 8, 256, 0, s>>>(static_cast<const unsigned char*>(valid), w, M, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (is_bf16) {
    const TensorMap map_q(query, true, 2, {CK, uQ, 1, 1}, {CK, TQ, 1, 1});
    const TensorMap map_k(keys, true, 2, {CK, uM, 1, 1}, {CK, TM, 1, 1});
    const TensorMap map_v(values, true, 3, {CV, uM, uNo, 1}, {64, TM, 1, 1});
    if (!map_q.ok || !map_k.ok || !map_v.ok) return static_cast<int>(cudaErrorInvalidValue);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    const auto kernel = affinity_bf16 ? bf::readout_bf16_kernel<true> : bf::readout_bf16_kernel<false>;
    err = allow_shared(kernel, bf::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, bf::kSmemBytes, s>>>(map_q.map, map_k.map, map_v.map, w, o, part_acc, part_stats, Q, No,
                                                  n_tiles, tiles_per_split, c2);
  } else {
    const int Mp = n_tiles * TM;
    const size_t nq = static_cast<size_t>(Q) * CK, nk = static_cast<size_t>(M) * CK;
    float* q2 = static_cast<float*>(split);
    float* k2 = q2 + 2 * nq;
    float* v2 = k2 + 2 * nk;
    fp::split_kernel<<<static_cast<unsigned>((nq / 4 + 255) / 256), 256, 0, s>>>(static_cast<const float*>(query), q2, nq);
    fp::split_kernel<<<static_cast<unsigned>((nk / 4 + 255) / 256), 256, 0, s>>>(static_cast<const float*>(keys), k2, nk);
    fp::split_values_kernel<<<dim3(n_tiles, No), 256, 0, s>>>(static_cast<const float*>(values), w, v2, M, Mp, No);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const TensorMap map_q(q2, false, 3, {CK, uQ, 2, 1}, {32, TQ, 1, 1});
    const TensorMap map_k(k2, false, 3, {CK, uM, 2, 1}, {32, fp::TK, 1, 1});
    const TensorMap map_v(v2, false, 4, {static_cast<cuuint64_t>(Mp), CV, uNo, 2}, {fp::TK, CV, 2, 1});
    if (!map_q.ok || !map_k.ok || !map_v.ok) return static_cast<int>(cudaErrorInvalidValue);
    float* o = static_cast<float*>(out);
    const auto kernel = affinity_bf16 ? fp::readout_fp32_kernel<true> : fp::readout_fp32_kernel<false>;
    err = allow_shared(kernel, fp::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, fp::kSmemBytes, s>>>(map_q.map, map_k.map, map_v.map, w, o, part_acc, part_stats, Q, No,
                                                  n_tiles, tiles_per_split, c2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);

  const size_t n_threads = static_cast<size_t>(No) * Q * (CV / 4);
  const unsigned blocks = static_cast<unsigned>((n_threads + 255) / 256);
  if (is_bf16)
    combine_kernel<<<blocks, 256, 0, s>>>(part_acc, part_stats, static_cast<__nv_bfloat16*>(out), Q, No, n_split);
  else
    combine_kernel<<<blocks, 256, 0, s>>>(part_acc, part_stats, static_cast<float*>(out), Q, No, n_split);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
