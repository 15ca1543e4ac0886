// Flash attention (forward) for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel): online-softmax attention of a
// block of queries over its keys, with causal and sliding-window masks, a
// logit softcap, a query offset and GQA, never materialising the score
// matrix in device memory. It is the prefill attention of every layer.
//
//   q    (B, Sq, H, hd)    float or bf16
//   k/v  (B, Skv, KV, hd)  same type as q; H % KV == 0, q head h reads h / (H / KV)
//   out  (B, Sq, H, hd)    same type as q
//
// Semantics, as _flash_kernel: s = (q . k) * hd**-0.5 in f32; softcap
// (cap * tanh(s / cap)) before the mask; key kpos is valid for query qpos =
// row + q_offset iff kpos < Skv, kpos <= qpos (causal) and kpos > qpos -
// window (window > 0); masked p is 0; out = acc / max(l, 1e-30), so a row
// with no valid key is 0.
//
// What bounds it on this card: operations. Prefill of qwen3-8b at S 4096
// (H 32, hd 128, causal) needs 1.375e11 FLOP for q.k and p.v, 0.139 ms at
// the tensor cores' 989 TFLOP/s in bf16; it reads ~21 MB, 6 us at 3.35 TB/s.
//
// Two designs, chosen by the entry point from the input alone (an explicit
// dispatch between two kernels written by hand, not a fallback: a launch
// that fails raises):
//
// * wgmma: bf16 at head_dim 64, 120 and 128, every model's prefill.
//   - Tensor cores for both products. S = Q K^T is wgmma m64n128k16, bf16 x
//     bf16 -> f32, Q and K read from shared memory (K key-major with hd
//     contiguous: the K-major B operand). O += P V takes P from registers:
//     the f32 S accumulator is rounded to bf16 pairs that are already in
//     wgmma's register-A layout, and V is the MN-major B operand, read as it
//     lies. This is the rounding of the JAX reference's _dense_attention:
//     bf16 operands, f32 sums, bf16 weights for p.v.
//   - A block of 256 threads owns 128 query rows of one head: 2 warpgroups
//     of 64 rows. While one warpgroup runs its softmax the other keeps the
//     tensor cores busy. Tiles of 128 keys; with hd 128, Q (32 KB) and 2
//     stages of K and V (128 KB) are 160 KB of shared memory, one block per
//     SM.
//   - TMA feeds the tiles: Q once, K and V into a ring of 2 stages with
//     mbarrier full/empty pairs; thread 0 issues the copy of tile j + 1
//     before the math of tile j, once both warpgroups are done with tile
//     j - 1. K/V are 4-D tensor maps (hd, KV, Skv, B), so a tile at the end
//     of a batch row reads zeros, never the next row's keys; hd 120 reads as
//     128 columns whose last 8 are zeros. The 128-byte swizzle of the tiles
//     is the one wgmma's descriptors name.
//   - The online softmax runs on the accumulator fragments: a row's scores
//     lie in the 4 threads of a quad, so its max is 2 shuffles and its sum is
//     reduced once, at the end. hd**-0.5 * log2(e) is one multiply and exp2
//     does the rest; with a softcap: scale, cap * tanh(s / cap), times
//     log2(e). Masks run only on tiles that cut the causal diagonal, the
//     window's edge or Skv; tiles the masks cover wholly are never loaded;
//     the heaviest causal q tiles are launched first.
//   - No atomics and no split over keys: the output is the same, bit for
//     bit, from run to run.
//   Later work (not here): a producer warpgroup with setmaxnreg, ping-pong
//   of softmax against wgmma between the warpgroups, and packing the q heads
//   that share a KV head into one block.
//
// * simt: every fp32 input (TF32 tensor cores cannot meet fp32 parity at
//   2e-5), and bf16 at head_dim 16 and 32 (the reduced test configs only).
//   Plain f32 FMAs on the CUDA cores (67 TFLOP/s at most): one block of 256
//   threads per (64 query rows, q head, batch row), the heaviest causal tiles
//   first; it walks its key tiles of 64 from the first the window can reach
//   to the last causality allows; q (pre-scaled), K (both transposed) and V
//   are staged in shared memory as f32; thread (ty, tx) of a 16 x 16 grid
//   owns score rows ty*4..+3 and columns tx*4..+3 and output rows ty*4..+3,
//   columns tx*DPT..+DPT-1, so row max and row sum are 4 shuffles; keys at or
//   past Skv are staged as 0 and masked; masked scores are -1e30 and their p
//   is set to 0.
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds; cuTensorMapEncodeTiled
// is reached through the runtime, so it needs no -lcuda either.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The simt design: fp32, and bf16 at head_dim 16 and 32
// ---------------------------------------------------------------------------
namespace simt {


constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per row of the P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 4 consecutive elements as one aligned access (16 B of f32, 8 B of bf16).
template <typename T>
struct alignas(sizeof(T) * 4) Pack4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ float4 load4(const T* __restrict__ p) {
  const Pack4<T> pk = *reinterpret_cast<const Pack4<T>*>(p);
  return make_float4(to_f32(pk.v[0]), to_f32(pk.v[1]), to_f32(pk.v[2]), to_f32(pk.v[3]));
}

// Output columns per thread, and hd padded to 16 of them (hd 120 -> 128).
template <int HD> __host__ __device__ constexpr int dpt() { return (HD + 15) / 16; }
template <int HD> __host__ __device__ constexpr int hd_pad() { return 16 * dpt<HD>(); }

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)HD * kBQ          // qt: (hd, BQ), pre-scaled
                          + (size_t)HD * kBKV       // kt: (hd, BKV)
                          + (size_t)kBKV * hd_pad<HD>()  // vs: (BKV, hd_pad)
                          + (size_t)kBKV * (kBQ + kPad));  // pt: (BKV, BQ + pad)
}

// Stage ROWS rows of one head of x (row stride `stride` elements),
// transposed, as dst[d * ROWS + r] = x[r][d] * scale; rows at or past n are
// 0 and never read. Consecutive threads take consecutive rows, so the
// shared writes do not conflict.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage_transposed(float* __restrict__ dst, const T* __restrict__ x,
                                                 int64_t stride, int n, float scale) {
  constexpr int C = HD / 4;
  for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
    const int r = i % ROWS;
    const int c = i / ROWS;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) v = load4(x + r * stride + c * 4);
    dst[(c * 4 + 0) * ROWS + r] = v.x * scale;
    dst[(c * 4 + 1) * ROWS + r] = v.y * scale;
    dst[(c * 4 + 2) * ROWS + r] = v.z * scale;
    dst[(c * 4 + 3) * ROWS + r] = v.w * scale;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv, int H,
                       int KV, int causal, int window, float softcap, int q_offset,
                       float sm_scale) {
  constexpr int DPT = dpt<HD>();
  constexpr int HDP = hd_pad<HD>();
  constexpr int PLD = kBQ + kPad;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + HD * kBQ;
  float* vs = kt + HD * kBKV;
  float* pt = vs + kBKV * HDP;

  const int qtile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qtile * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)KV * HD;
  const T* qb = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)kvh * HD;
  const T* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)kvh * HD;

  // key range this tile can see
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = q0 + nq - 1 + q_offset;
  const int kv_end = causal ? min(Skv, qpos_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, qpos_lo - window + 1) / kBKV * kBKV : 0;

  stage_transposed<T, HD, kBQ>(qt, qb, q_stride, nq, sm_scale);
  if constexpr (HDP != HD) {  // padding columns of V stay 0
    for (int i = threadIdx.x; i < kBKV * (HDP - HD); i += kThreads)
      vs[(i / (HDP - HD)) * HDP + HD + i % (HDP - HD)] = 0.f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBKV) {
    const int nk = min(kBKV, Skv - kv0);
    __syncthreads();  // the previous tile's kt / vs / pt are consumed
    stage_transposed<T, HD, kBKV>(kt, kb + kv0 * kv_stride, kv_stride, nk, 1.f);
    for (int i = threadIdx.x; i < kBKV * (HD / 4); i += kThreads) {
      const int r = i / (HD / 4);
      const int c = i % (HD / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nk) x = load4(vb + (kv0 + r) * kv_stride + c * 4);
      *reinterpret_cast<float4*>(vs + r * HDP + c * 4) = x;
    }
    __syncthreads();

    // s = q . k over hd for the thread's 4 x 4 scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kBKV + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // softcap, mask, online softmax
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + q_offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kv0 + tx * 4 + j;
        ok[j] = kpos < Skv && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        float x = s[i][j];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * PLD + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc += p . v for the thread's 4 rows x DPT columns (rows past nk have
    // p = 0 and v = 0)
#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(pt + kk * PLD + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float* vrow = vs + kk * HDP + tx * DPT;
      float vv[DPT];
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < DPT; j += 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + j);
          vv[j] = x.x;
          vv[j + 1] = x.y;
          vv[j + 2] = x.z;
          vv[j + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < DPT; ++j) vv[j] = vrow[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx * DPT + j;
      if (c < HD) ob[r * q_stride + c] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int KV, int causal, int window, float softcap, int q_offset, float sm_scale,
           cudaStream_t stream) {
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  const size_t smem = smem_bytes<HD>();
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KV, causal, window, softcap, q_offset, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The wgmma design: bf16 at head_dim 64, 120 and 128
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBQ = 128;         // query rows per block: 2 warpgroups x 64
constexpr int kBKV = 128;        // keys per tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 128;   // one 64-column bf16 block of a row: the 128-byte swizzle span
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -__builtin_huge_valf();

__host__ __device__ constexpr uint32_t q_bytes(int hdp) { return (uint32_t)kBQ * hdp * 2; }
__host__ __device__ constexpr uint32_t kv_bytes(int hdp) { return (uint32_t)kBKV * hdp * 2; }
// Q, the K and V rings, 7 mbarriers, and slack to align the tiles to 1024 B
__host__ __device__ constexpr size_t smem_bytes(int hdp) {
  return q_bytes(hdp) + 2 * kStages * (size_t)kv_bytes(hdp) + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of the barrier with this parity has completed. A
// barrier that never completes traps (a launch error) rather than hang.
__device__ __forceinline__ void mbar_spin(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 28)) __trap();
  }
}

// mbar_spin by every lane of a warp, which leaves it converged for the
// wgmma that follows.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  mbar_spin(bar, parity);
  __syncwarp();
}

// One TMA copy of a (64 columns, 1 head, rows, 1 batch row) box into shared
// memory, counted on `bar`; coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// tanh(x) = 1 - 2 / (e^2x + 1): exp2 and a fast divide, ~1e-7 absolute.
__device__ __forceinline__ float tanh_exp2(float x) {
  return 1.f - __fdividef(2.f, exp2f(x * (2.f * kLog2e)) + 1.f);
}

// d (m64 x n128, f32) (+)= A (64 x 16, K-major in shared memory) * B (16 x 128,
// K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a_desc, uint64_t b_desc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// d (m64 x n128, f32) += A (64 x 16 bf16, from registers in the accumulator
// layout) * B (16 x 128, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(1));
}

// d (m64 x n64, f32) += A (64 x 16 bf16, from registers in the accumulator
// layout) * B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2], const uint32_t (&p)[32], int kk,
                                         uint64_t b_desc);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&p)[32], int kk,
                                              uint64_t b_desc) {
  wgmma_rs_n128(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], b_desc);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&p)[32], int kk,
                                             uint64_t b_desc) {
  wgmma_rs_n64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], b_desc);
}

// One block: 128 query rows of one q head of one batch row, as two
// warpgroups of 64 rows; thread 0 also issues every TMA copy. HDP is hd
// padded to the 64-column blocks (64 or 128); TMA fills columns past hd
// with zeros, so they add nothing to q.k and give 0 columns of p.v.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                   int Sq, int Skv, int H, int KV, int hd, int causal, int window,
                   float softcap, int q_offset, float sm_scale, int n_qtiles) {
  constexpr int kCB = HDP / 64;               // 64-column blocks of a row
  constexpr uint32_t kQ = q_bytes(HDP);
  constexpr uint32_t kKV = kv_bytes(HDP);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + kQ;                 // K stage s at sk + s * kKV
  const uint32_t sv = sk + kStages * kKV;      // V stage s at sv + s * kKV
  const uint32_t bars = sv + kStages * kKV;
  const uint32_t q_bar = bars + 48;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 16 + 8 * s; };
  auto empty = [&](int s) { return bars + 32 + 8 * s; };

  // heaviest causal tiles first: the q tile is the slowest index of the grid
  const int hb = gridDim.x / n_qtiles;
  const int qtile = n_qtiles - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / (H / KV);
  const int q0 = qtile * kBQ;
  const int nq = min(kBQ, Sq - q0);

  // the key tiles some row of the block can see; the others are never read
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = q0 + nq - 1 + q_offset;
  const int kv_end = causal ? min(Skv, qpos_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, qpos_lo - window + 1) / kBKV * kBKV : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBKV - 1) / kBKV : 0;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;                   // warpgroup: rows wgi * 64 .. + 63
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                      // accumulator rows g and g + 8 of the warp's 16
  const int t4 = lane % 4;                     // accumulator columns 8j + 2 * t4 + {0, 1}

  auto load_kv = [&](int j) {
    const int s = j % kStages;
    const int kv0 = kv_begin + j * kBKV;
    mbar_expect_tx(full_k(s), kKV);
#pragma unroll
    for (int c = 0; c < kCB; ++c)
      tma_load(sk + s * kKV + c * kBKV * kRowBytes, &k_map, full_k(s), c * 64, kvh, kv0, b);
    mbar_expect_tx(full_v(s), kKV);
#pragma unroll
    for (int c = 0; c < kCB; ++c)
      tma_load(sv + s * kKV + c * kBKV * kRowBytes, &v_map, full_v(s), c * 64, kvh, kv0, b);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kWarps);             // one arrival per warp of both warpgroups
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(q_bar, kQ);
#pragma unroll
    for (int c = 0; c < kCB; ++c)
      tma_load(sq + c * kBQ * kRowBytes, &q_map, q_bar, c * 64, h, q0, b);
    load_kv(0);
  }

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;        // running max of rows g, g + 8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;                    // this thread's part of the running sums

  const int wg_lo = q0 + wgi * 64 + q_offset;  // positions of the warpgroup's rows
  const int wg_hi = wg_lo + 63;
  const int pos0 = wg_lo + warp * 16 + g;
  const int pos1 = pos0 + 8;
  const float scale_log2 = sm_scale * kLog2e;
  const float cap_in = softcap != 0.f ? sm_scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;
  const uint32_t q_wg = sq + wgi * 64 * kRowBytes;

  if (n_tiles > 0) mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int kv0 = kv_begin + j * kBKV;
    if (tid == 0 && j + 1 < n_tiles) {
      // the next tile goes into the stage tile j - 1 used, once both
      // warpgroups are done with it; its copy runs under this tile's math
      if (j + 1 >= kStages) mbar_spin(empty((j + 1) % kStages), ((j + 1 - kStages) / kStages) & 1);
      load_kv(j + 1);
    }

    // S = Q K^T over hd, 16 columns per wgmma
    float sacc[64];
    mbar_wait(full_k(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t col = (kk / 4) * (uint32_t)kBQ * kRowBytes + (kk % 4) * 32;
      const uint32_t kcol = (kk / 4) * (uint32_t)kBKV * kRowBytes + (kk % 4) * 32;
      wgmma_ss_n128(sacc, smem_desc(q_wg + col, 16, 1024),
                    smem_desc(sk + s * kKV + kcol, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // scale (and cap) into the log2 domain; masks only on tiles that cut the
    // causal diagonal, the window's edge or Skv
    if (softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sacc[i] = cap_out * tanh_exp2(sacc[i] * cap_in);
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) sacc[i] *= scale_log2;
    }
    const bool need_mask = kv0 + kBKV > Skv || (causal && kv0 + kBKV - 1 > wg_lo) ||
                           (window > 0 && kv0 <= wg_hi - window);
    if (need_mask) {
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kv0 + 8 * jj + 2 * t4 + e;
          const bool in = kpos < Skv;
          const bool ok0 = in && (!causal || kpos <= pos0) && (window <= 0 || kpos > pos0 - window);
          const bool ok1 = in && (!causal || kpos <= pos1) && (window <= 0 || kpos > pos1 - window);
          if (!ok0) sacc[4 * jj + e] = kNegInf;
          if (!ok1) sacc[4 * jj + 2 + e] = kNegInf;
        }
      }
    }

    // online softmax on the fragments: a row's 128 scores lie in the 4
    // threads of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * jj], sacc[4 * jj + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * jj + 2], sacc[4 * jj + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row with no valid key so far keeps max -inf; subtract 0 there so
    // its masked p are exp2(-inf) = 0
    const float mu0 = mx0 == kNegInf ? 0.f : mx0;
    const float mu1 = mx1 == kNegInf ? 0.f : mx1;
    const float corr0 = exp2f(m0 - mu0);
    const float corr1 = exp2f(m1 - mu1);
    m0 = mx0;
    m1 = mx1;
    uint32_t p[32];                            // P in bf16, in the register-A layout
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float p00 = exp2f(sacc[4 * jj] - mu0);
      const float p01 = exp2f(sacc[4 * jj + 1] - mu0);
      const float p10 = exp2f(sacc[4 * jj + 2] - mu1);
      const float p11 = exp2f(sacc[4 * jj + 3] - mu1);
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      p[2 * jj] = pack_bf16(p00, p01);
      p[2 * jj + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int jj = 0; jj < HDP / 8; ++jj) {
      o[4 * jj] *= corr0;
      o[4 * jj + 1] *= corr0;
      o[4 * jj + 2] *= corr1;
      o[4 * jj + 3] *= corr1;
    }

    // O += P V over the tile's keys, 16 keys per wgmma
    mbar_wait(full_v(s), parity);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      wgmma_pv<HDP>(o, p, kk,
                    smem_desc(sv + s * kKV + kk * 16 * kRowBytes, kBKV * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // out = O / l; a row with no valid key has l = 0 and O = 0
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + wgi * 64 + warp * 16 + g;
  const int64_t q_stride = (int64_t)H * hd;
  __nv_bfloat16* o0 = out + ((int64_t)b * Sq + row0) * q_stride + (int64_t)h * hd;
  __nv_bfloat16* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int jj = 0; jj < HDP / 8; ++jj) {
    const int col = 8 * jj + 2 * t4;
    if (col >= hd) continue;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A (B, S, heads, hd) bf16 tensor as 4-D (hd, heads, S, B), boxes of 64
// columns x `rows` rows of one head and batch row, 128-byte swizzle. Rows
// past S and columns past hd are out of bounds and read as 0, so a tile at
// the end of one batch row never reads the next one's.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)hd * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int KV, int hd, int causal, int window, float softcap, int q_offset,
           float sm_scale, cudaStream_t stream) {
  if (Skv == 0)  // no key at all: every row is 0 (a tensor map needs a non-empty tensor)
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * H * hd * 2, stream);
  static bool configured = false;  // the opt-in above 48 KB, once per instantiation
  const size_t smem = smem_bytes(HDP);
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, B, Sq, H, hd, kBQ);
  if (!err) err = make_map(&k_map, k, B, Skv, KV, hd, kBKV);
  if (!err) err = make_map(&v_map, v, B, Skv, KV, hd, kBKV);
  if (err) return err;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  if ((int64_t)n_qtiles * H * B >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  flash_wgmma_kernel<HDP><<<n_qtiles * H * B, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, KV, hd, causal, window,
      softcap, q_offset, sm_scale, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace wg

int launch_simt(int dtype, int hd, const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int H, int KV, int causal, int window, float softcap,
                int q_offset, float sm_scale, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
#define REPRO_SIMT(T, HD)                                                                   \
  simt::launch<T, HD>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, \
                      sm_scale, s)
  if (dtype == 0) {
    switch (hd) {
      case 16: return REPRO_SIMT(float, 16);
      case 32: return REPRO_SIMT(float, 32);
      case 64: return REPRO_SIMT(float, 64);
      case 120: return REPRO_SIMT(float, 120);
      case 128: return REPRO_SIMT(float, 128);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return REPRO_SIMT(bf16, 16);
      case 32: return REPRO_SIMT(bf16, 32);
    }
  }
#undef REPRO_SIMT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Which design the entry point launches for these inputs: 1 wgmma, 0 simt.
int repro_flash_attention_design(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 120 || hd == 128) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller has checked shapes, types, devices, contiguity and alignment.
int repro_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                          int B, int Sq, int Skv, int H, int KV, int hd, int causal, int window,
                          float softcap, int q_offset, float sm_scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv < 0 || q_offset < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (repro_flash_attention_design(dtype, hd)) {
    const int hdp = hd <= 64 ? 64 : 128;
    return hdp == 64 ? wg::launch<64>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window,
                                      softcap, q_offset, sm_scale, s)
                     : wg::launch<128>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window,
                                       softcap, q_offset, sm_scale, s);
  }
  return launch_simt(dtype, hd, q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap,
                     q_offset, sm_scale, s);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
