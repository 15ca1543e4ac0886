// Flash attention backward for Hopper (sm_90a), written by hand.
//
// No TPU kernel is replaced: the JAX package has no backward kernel. Its
// training gradient is XLA's autodiff of the jnp attention
// (src/repro/models/layers.py, _dense_attention), compiled into fused
// device code. This file computes the same function, the gradient of the
// forward in flash_attention.cu, so that the port's training path runs a
// kernel on the card where it ran PyTorch ops (ref.flash_attention_bwd,
// which stays the plain version the kernel is held to).
//
//   q, do, out  (B, Sq, H, hd)    float or bf16
//   k/v         (B, Skv, KV, hd)  same type; H % KV == 0, q head h reads h / (H / KV)
//   lse         (B, H, Sq) f32    the forward's log-sum-exp of each row's
//                                 valid scores, natural base; +inf for a
//                                 row with no valid key
//   dq, dk, dv                    shaped and typed as q, k, v
//   dsum        (B, H, Sq) f32    scratch: D = rowsum(do * out)
//
// Semantics, those of the forward: s = (q . k) * hd**-0.5, softcap cap *
// tanh(s / cap), the causal, window and Skv masks at query position row +
// q_offset; p = exp(s - lse) (0 where masked), dv = p^T do, dp = do v^T,
// ds = p (dp - D) (times 1 - tanh^2 under a softcap), dk = ds^T q * scale,
// dq = ds k * scale. A row with no valid key has lse +inf, so its p and ds
// are 0 and it adds nothing; its dq is 0.
//
// What bounds it: operations. At tinyllama-1.1b's training microbatch (B 4,
// S 2,048, H 32, KV 4, hd 64, causal) the five products of a (query, key)
// pair need 10 B H hd x pairs = 1.719e11 FLOP, 0.174 ms at the tensor
// cores' 989 TFLOP/s; it moves 0.22 GB, 0.066 ms at 3.35 TB/s. This design
// does seven products a pair (S and dP are formed in both kernels), so its
// own floor is 0.243 ms.
//
// Three kernels, launched in order on one stream:
//   1. dot: D = rowsum(do * out) in f32, a warp a row.
//   2. dkv: a block a (batch row, KV head, key tile). It loops over the
//      query heads of the GQA group and, for each, the query tiles that the
//      masks leave valid for its keys, recomputes S^T = K Q^T and P^T, and
//      keeps dV += P^T dO and dK += dS^T Q in registers, so the group's sum
//      happens inside the block. K and V are loaded once; Q, dO and the
//      tile's lse and D come through a ring of stages.
//   3. dq: a block a (batch row, q head, query tile). It loops over the key
//      tiles the masks leave valid and keeps dQ += dS K in registers. Q and
//      dO are loaded once; K and V come through a ring.
// The causally heaviest tiles are launched first. Tiles the masks cover
// wholly are never loaded; the masks run only on tiles that cut the causal
// diagonal, the window's edge or Skv (rows past Sq have zero Q and dO, so
// they add nothing). No atomics and no split reduction: every sum runs in
// one fixed order, so two runs give the same gradients bit for bit. The
// tile sizes below are the only source: tests/test_torch_flash_bwd.py's
// tiled mirror reads these lines.
//
// Two designs, chosen by the entry point from the input alone:
// * wgmma: bf16 at head_dim 64, 120 and 128. Two consumer warpgroups a
//   block, each owning 64 rows (keys in dkv, queries in dq): wgmma's M.
//   TMA fills full/empty mbarrier rings of 3 stages.
//   - dkv: 128 keys a block. S^T = K Q^T and dP^T = V dO^T are SS wgmma
//     (K, V, Q and dO all K-major, as they lie), 64 x KV_SUB, KV_SUB = 64
//     queries at hd 64 and 32 at 128, from tiles of 64 queries. P^T and
//     dS^T are formed on the accumulator fragments (each column's lse and D
//     from shared memory) and rounded to bf16 pairs that are already
//     wgmma's register-A layout; then dV += P^T dO and dK += dS^T Q are RS
//     wgmma with dO and Q the MN-major B operand, read as they lie (the
//     forward's P V). K and V come by TMA once. Warp 0 fills the ring one
//     depth ahead: Q and dO by TMA, the tile's lse and D by cp.async, all on
//     one full barrier (a bulk copy or a tensor map over lse would need Sq %
//     4 == 0; rows past Sq read lse and D 0, which is harmless where Q and
//     dO are 0). The block is the two warpgroups alone, 8 warps: the dK and
//     dV sums are 128 registers a thread at hd 128, and a 9th warp would
//     put 3 warps on one SM sub-partition (16,384 registers), capping every
//     thread at 168. setmaxnreg with a producer warpgroup did not lift that
//     in ptxas's allocation here (the consumers spilled at hd 128).
//   - dq: 128 query rows a block, 64 keys a tile, and a producer warp whose
//     lane 0 issues every copy (168 registers suffice). S = Q K^T and dP =
//     dO V^T are SS wgmma m64n64k16, dS comes from the fragments with each
//     row's lse and D in registers, dQ += dS K is RS wgmma with K MN-major.
//     Q and dO come by TMA once; K and V through the ring.
//   - A warpgroup skips the math of a tile its own 64 rows do not see (the
//     causal diagonal), but still waits for and releases the stage.
//   - The score transform is compiled four ways (softcap or not, mask or
//     not), so an interior tile without a softcap runs one multiply and
//     one exp2 a pair.
//   - The 4-D tensor maps (hd, heads, S, B) read rows past S and columns
//     past hd as zeros: hd 120 is read as 128 columns whose last 8 are 0 and
//     the stores write 120. Exponents in the log2 domain (exp2 of s log2(e)
//     - lse log2(e)); dS from the f32 P, P and dS rounded to bf16 only as
//     operands.
// * simt: fp32 math on the CUDA cores for fp32 inputs (TF32 would miss the
//   2e-5 parity) and for bf16 at head_dim 16 and 32: a block of 256
//   threads, its own tiles (below), every operand staged in shared memory
//   as f32.
// Later work (not here): one kernel that forms S and dP once, with dQ
// summed across key tiles in a fixed order (semaphores), not by atomics.
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds; cuTensorMapEncodeTiled
// is reached through the runtime, so it needs no -lcuda either.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// simt
constexpr int kKvKeys = 64;      // dkv kernel: keys of a block
constexpr int kKvQueries = 32;   // dkv kernel: queries of an inner tile
constexpr int kQRows = 64;       // dq kernel: queries of a block
constexpr int kQKeys = 64;       // dq kernel: keys of an inner tile
constexpr int kSimtThreads = 256;
static_assert(kKvKeys == 4 * 16 && kKvQueries == 2 * 16, "simt dkv: 16 x 16 threads, 4 x 2 each");
static_assert(kQRows == 4 * 16 && kQKeys == 4 * 16, "simt dq: 16 x 16 threads, 4 x 4 each");
// wgmma
constexpr int kWgKvKeys = 128;    // dkv kernel: keys of a block, 64 a consumer warpgroup
constexpr int kWgKvQueries = 64;  // dkv kernel: queries of a tile of the ring
constexpr int kWgQRows = 128;     // dq kernel: queries of a block, 64 a consumer warpgroup
constexpr int kWgQKeys = 64;      // dq kernel: keys of a tile of the ring
constexpr int kWgStages = 3;      // depth of both rings
// dot
constexpr int kDotRows = 8;      // dot kernel: rows of a block, a warp each
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The score transform and the masks, shared by both designs.
struct Score {
  float scale_log2;  // hd**-0.5 * log2(e)
  float cap_in;      // hd**-0.5 / cap (0 without a softcap)
  float cap_out;     // cap * log2(e)
  int causal, window, q_offset, Skv;
};

__device__ __forceinline__ bool valid(const Score& sc, int kpos, int qpos) {
  return kpos < sc.Skv && (!sc.causal || kpos <= qpos) && (sc.window <= 0 || kpos > qpos - sc.window);
}

// p and ds of one (query, key) pair from the raw product s = q . k, dp =
// do . v, the row's lse (log2 domain) and D.
__device__ __forceinline__ void p_ds(const Score& sc, float s, float dp, bool ok, float lse2,
                                     float dsum, float& p, float& ds) {
  float x, t = 0.f;
  if (sc.cap_in != 0.f) {
    t = tanhf(s * sc.cap_in);
    x = sc.cap_out * t;
  } else {
    x = s * sc.scale_log2;
  }
  p = ok ? exp2f(x - lse2) : 0.f;
  ds = p * (dp - dsum);
  if (sc.cap_in != 0.f) ds *= 1.f - t * t;
}

// The query rows [lo, hi] that see some key of [k0, k0 + nk) (none when lo > hi).
__device__ __forceinline__ void query_rows(const Score& sc, int k0, int nk, int Sq, int& lo,
                                           int& hi) {
  lo = sc.causal ? max(0, k0 - sc.q_offset) : 0;
  int64_t h = Sq - 1;
  if (sc.window > 0) {
    const int64_t reach = (int64_t)k0 + nk - 2 + sc.window - sc.q_offset;
    h = reach < h ? reach : h;
  }
  hi = h < 0 ? -1 : (int)h;
}

// The keys [lo, hi) that some row of [q0, q0 + nq) sees.
__device__ __forceinline__ void key_cols(const Score& sc, int q0, int nq, int& lo, int& hi) {
  hi = sc.causal ? min(sc.Skv, q0 + nq + sc.q_offset) : sc.Skv;
  const int64_t first = (int64_t)q0 + sc.q_offset - sc.window + 1;
  lo = sc.window > 0 && first > 0 ? (int)first : 0;
}

// Whether a (query rows, keys) tile holds a pair the masks drop: a key past
// Skv, one past the causal diagonal, or one at or before the window's edge.
__device__ __forceinline__ bool tile_needs_mask(const Score& sc, int q0, int nqt, int k0,
                                                int nkt) {
  const int p_lo = q0 + sc.q_offset;
  const int p_hi = p_lo + nqt - 1;
  return k0 + nkt > sc.Skv || (sc.causal && k0 + nkt - 1 > p_lo) ||
         (sc.window > 0 && (int64_t)k0 <= (int64_t)p_hi - sc.window);
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(do * out), f32, (B, H, Sq)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * kDotRows)
dot_kernel(const T* __restrict__ dout, const T* __restrict__ out, float* __restrict__ dsum,
           int Sq, int H, int hd, int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * kDotRows + threadIdx.x / 32;  // row of (B, Sq, H)
  if (r >= rows) return;                                                 // warp-uniform
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += to_f32(dout[r * hd + d]) * to_f32(out[r * hd + d]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = (int)(r % H);
    const int64_t bs = r / H;
    dsum[(bs / Sq * H + h) * Sq + bs % Sq] = acc;
  }
}

// ---------------------------------------------------------------------------
// wgmma: bf16 at head_dim 64, 120 and 128
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kConsumerWarps = 8;       // two warpgroups
constexpr int kKvThreads = 256;         // dkv: the two consumer warpgroups; warp 0 fills the ring
constexpr int kQThreads = 288;          // dq: the two consumer warpgroups and a producer warp
constexpr int kRowBytes = 128;          // one 64-column bf16 block of a row: the 128-byte swizzle span
static_assert(kWgKvKeys == 2 * 64 && kWgQRows == 2 * 64, "wgmma: 64 rows a consumer warpgroup");
static_assert(kWgKvQueries == 64 && kWgQKeys == 64, "wgmma: tiles of 64 rows");

// Shared memory of a block: tiles of 64-column blocks of rows x 128 bytes,
// 1024-byte aligned (the swizzle's period), then the dkv ring's lse and D,
// then the mbarriers.
template <int HDP>
struct Geo {
  static constexpr int CB = HDP / 64;                                   // column blocks of a row
  static constexpr uint32_t KV_KEYS = (uint32_t)kWgKvKeys * HDP * 2;    // dkv: K or V
  static constexpr uint32_t KV_QT = (uint32_t)kWgKvQueries * HDP * 2;   // dkv: Q or dO of a tile
  static constexpr uint32_t KV_LD = 2 * kWgKvQueries * 4;               // dkv: lse and D of a tile
  // dkv: queries of one S^T and dP^T product; beside the dK and dV sums
  // (HDP registers a thread) S^T and dP^T are 64 x 32 at HDP 128
  static constexpr int KV_SUB = HDP == 128 ? 32 : 64;
  static constexpr size_t KV_SMEM =
      2 * (size_t)KV_KEYS + kWgStages * (2 * (size_t)KV_QT + KV_LD) + 128 + 1024;
  static constexpr uint32_t Q_ROWS = (uint32_t)kWgQRows * HDP * 2;      // dq: Q or dO
  static constexpr uint32_t Q_KT = (uint32_t)kWgQKeys * HDP * 2;        // dq: K or V of a tile
  static constexpr size_t Q_SMEM = 2 * (size_t)Q_ROWS + kWgStages * 2 * (size_t)Q_KT + 128 + 1024;
};

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

// `rows` rows of one head of a map into a tile of CB column blocks.
template <int CB>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int head, int row, int batch) {
#pragma unroll
  for (int c = 0; c < CB; ++c)
    tma_load(dst + c * rows * kRowBytes, map, bar, c * 64, head, row, batch);
}

// 4 bytes from global to shared memory; live false writes 0. The copies a
// thread has issued arrive on `bar` when they are done (the barrier counts
// that arrival in its initial count).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// d (m64 x n32, f32) (+)= A (64 x 16, K-major in shared memory) * B (16 x 32,
// K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a_desc, uint64_t b_desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// d (m64 x n64, f32) (+)= A (64 x 16, K-major in shared memory) * B (16 x 64,
// K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// S (m64 x nN) = A B^T over the depth HDP, A and B K-major tiles of CB
// column blocks; a_rows and b_rows are the rows of a column block of each
// tile (its byte stride), a and b the addresses of the first row.
template <int HDP, int N>
__device__ __forceinline__ void product_abt(float (&s)[N / 2], uint32_t a, int a_rows, uint32_t b,
                                            int b_rows) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wgmma_ss(s, smem_desc(a + (kk / 4) * a_rows * kRowBytes + (kk % 4) * 32, 16, 1024),
             smem_desc(b + (kk / 4) * b_rows * kRowBytes + (kk % 4) * 32, 16, 1024), kk > 0);
}

// acc (m64 x HDP) += A B over a depth of K: A the K / 4 registers of bf16
// pairs of a 64 x K accumulator (K / 16 k-steps of 4), B K rows of a tile
// whose column blocks hold 64 rows (MN-major: the depth is the tile's rows).
template <int HDP, int K>
__device__ __forceinline__ void product_ab(float (&acc)[HDP / 2], const uint32_t (&a)[K / 4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t desc = smem_desc(b + kk * 16 * kRowBytes, 64 * kRowBytes, 1024);
    if constexpr (HDP == 128)
      wgmma_rs_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
    else
      wgmma_rs_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc);
  }
}

// tanh(x) = 1 - 2 / (e^2x + 1): exp2 and a fast divide, ~1e-7 absolute.
__device__ __forceinline__ float tanh_exp2(float x) {
  return 1.f - __fdividef(2.f, exp2f(x * (2.f * kLog2e)) + 1.f);
}

// p = exp(s' - lse) of one pair from its raw product s = q . k and its
// row's lse (log2 domain), 0 where `ok` is false; the return is p times the
// softcap's factor 1 - tanh^2 (p without a softcap), and p itself goes to
// `p_out`. CAP and MASK are template flags, so a tile without a softcap or
// a mask runs neither.
template <bool CAP, bool MASK>
__device__ __forceinline__ float p_elem(const Score& sc, float s, float lse2, bool ok,
                                        float& p_out) {
  float x, f = 1.f;
  if constexpr (CAP) {
    const float t = tanh_exp2(s * sc.cap_in);
    x = sc.cap_out * t;
    f = 1.f - t * t;
  } else {
    x = s * sc.scale_log2;
  }
  float p = exp2f(x - lse2);
  if constexpr (MASK) p = ok ? p : 0.f;
  p_out = p;
  return CAP ? p * f : p;
}

// dkv: P^T of a 64 x (8 NJ) accumulator (rows keys, columns queries, the
// thread's columns 8 j + 2 t4 + e with lse lv[2 j + e]); P^T in bf16 pairs
// of the register-A layout into pa, P^T times the softcap's factor in
// place of s.
template <bool CAP, bool MASK, int NJ>
__device__ __forceinline__ void p_keys(float (&s)[4 * NJ], uint32_t (&pa)[2 * NJ],
                                       const float (&lv)[2 * NJ], const Score& sc, int kpos0,
                                       int qpos0) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = MASK && valid(sc, kpos0 + 8 * (e >> 1), qpos0 + 8 * j + 2 * t4 + (e & 1));
      s[4 * j + e] = p_elem<CAP, MASK>(sc, s[4 * j + e], lv[2 * j + (e & 1)], ok, p[e]);
    }
    pa[2 * j] = pack_bf16(p[0], p[1]);
    pa[2 * j + 1] = pack_bf16(p[2], p[3]);
  }
}

// dq: P of a 64 x 64 accumulator (rows queries with lse2[0], lse2[1],
// columns keys), times the softcap's factor, in place of s.
template <bool CAP, bool MASK>
__device__ __forceinline__ void p_rows(float (&s)[32], const float (&lse2)[2], const Score& sc,
                                       int kpos0, int qpos0) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = MASK && valid(sc, kpos0 + 8 * n + 2 * t4 + (e & 1), qpos0 + 8 * (e >> 1));
      float p;
      s[4 * n + e] = p_elem<CAP, MASK>(sc, s[4 * n + e], lse2[e >> 1], ok, p);
    }
}

// Rows row0 + g and row0 + g + 8 of a 64 x HDP f32 accumulator (a warp's 16
// rows; column pairs 8j + 2 t4) to global rows of hd bf16, times `mul`; rows
// at or past n and columns at or past hd are not written.
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t stride, int hd, int row0, int n,
                                           const float (&acc)[HDP / 2], float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    if (col >= hd) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + g + 8 * e;
      if (r < n)
        *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * e] * mul, acc[4 * j + 2 * e + 1] * mul);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kKvThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
           const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
           const float* __restrict__ lse, const float* __restrict__ dsum, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int Sq, int H, int KV, int B, int hd, Score sc, float scale) {
  using G = Geo<HDP>;
  constexpr int SUB = G::KV_SUB;
  constexpr int NJ = SUB / 8;  // accumulator column chunks of a product
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + G::KV_KEYS;
  const uint32_t sQ0 = sV + G::KV_KEYS;                 // stage s: Q at sQ0 + 2 s KV_QT, then dO
  const uint32_t sL0 = sQ0 + kWgStages * 2 * G::KV_QT;  // stage s: lse, then D
  const uint32_t bars = sL0 + kWgStages * G::KV_LD;
  const uint32_t kv_bar = bars;
  const float* const l_base = reinterpret_cast<const float*>(smem_raw + (sL0 - smem_u32(smem_raw)));
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * kWgStages + 8 * s; };

  // the key tile is the slowest index: the causally heaviest tiles come first
  const int per = KV * B;
  const int k0 = (int)(blockIdx.x / per) * kWgKvKeys;
  const int kvh = (int)(blockIdx.x % per) % KV;
  const int b = (int)(blockIdx.x % per) / KV;
  const int rep = H / KV;
  int r_lo, r_hi;
  query_rows(sc, k0, min(kWgKvKeys, sc.Skv - k0), Sq, r_lo, r_hi);
  const int t_lo = r_lo / kWgKvQueries;
  const int n_qt = r_lo <= r_hi ? r_hi / kWgKvQueries - t_lo + 1 : 0;
  const int n_it = rep * n_qt;  // (head, query tile) pairs, heads outer

  // The copies of (head, query tile) `it` into its stage, by warp 0: the
  // tile's lse and D by cp.async (0 past Sq, where Q and dO are 0 too, so
  // those rows add nothing), Q and dO by TMA, all counted on full(s)
  const int lane = threadIdx.x % 32;
  auto load = [&](int it) {
    const int s = it % kWgStages;
    const int h = kvh * rep + it / n_qt;
    const int q0 = (t_lo + it % n_qt) * kWgKvQueries;
    const int64_t row = ((int64_t)b * H + h) * Sq + q0;
    const uint32_t sl = sL0 + s * G::KV_LD;
    for (int i = lane; i < kWgKvQueries; i += 32) {
      const bool in = q0 + i < Sq;
      cp_async4(sl + 4 * i, lse + (in ? row + i : 0), in);
      cp_async4(sl + 4 * (kWgKvQueries + i), dsum + (in ? row + i : 0), in);
    }
    cp_async_arrive(full(s));
    if (lane == 0) {
      const uint32_t sQ = sQ0 + s * 2 * G::KV_QT;
      mbar_expect_tx(full(s), 2 * G::KV_QT);
      tma_rows<G::CB>(sQ, &q_map, full(s), kWgKvQueries, h, q0, b);
      tma_rows<G::CB>(sQ + G::KV_QT, &do_map, full(s), kWgKvQueries, h, q0, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 33);              // warp 0's 32 cp.async arrivals and the TMA bytes
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp_id = threadIdx.x / 32;
  if (warp_id == 0 && n_it > 0) {
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * G::KV_KEYS);
      tma_rows<G::CB>(sK, &k_map, kv_bar, kWgKvKeys, kvh, k0, b);
      tma_rows<G::CB>(sV, &v_map, kv_bar, kWgKvKeys, kvh, k0, b);
    }
    for (int it = 0; it < min(n_it, kWgStages - 1); ++it) load(it);
  }

  const int cw = warp_id / 4;  // consumer warpgroup: keys k0 + 64 cw ..
  const int warp = warp_id % 4, g = lane / 4, t4 = lane % 4;
  const int wk0 = k0 + 64 * cw;
  const int wnk = min(64, sc.Skv - wk0);
  int w_lo = 1, w_hi = 0;  // the query rows the warpgroup's keys see
  if (wnk > 0) query_rows(sc, wk0, wnk, Sq, w_lo, w_hi);
  const int wt_lo = w_lo / kWgKvQueries, wt_hi = w_lo <= w_hi ? w_hi / kWgKvQueries : -1;
  const int kpos0 = wk0 + 16 * warp + g;  // the thread's keys: kpos0, kpos0 + 8
  const uint32_t a_k = sK + cw * 64 * kRowBytes, a_v = sV + cw * 64 * kRowBytes;
  const bool cap = sc.cap_in != 0.f;

  float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_it > 0) mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kWgStages;
    // the copies of tile it + kWgStages - 1 go into the stage tile it - 1
    // used, once both warpgroups are done with it; they run under this
    // tile's math
    const int nx = it + kWgStages - 1;
    if (warp_id == 0 && nx < n_it) {
      if (nx >= kWgStages) mbar_spin(empty(nx % kWgStages), (nx / kWgStages - 1) & 1);
      load(nx);
    }
    const int tq = t_lo + it % n_qt;
    mbar_wait(full(s), (it / kWgStages) & 1);
    if (tq >= wt_lo && tq <= wt_hi) {
      const uint32_t sQ = sQ0 + s * 2 * G::KV_QT, sdO = sQ + G::KV_QT;
#pragma unroll 1
      for (int sub = 0; sub < kWgKvQueries / SUB; ++sub) {
        const int q0 = tq * kWgKvQueries + sub * SUB;
        const uint32_t off = sub * SUB * kRowBytes;

        // S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys
        float sacc[SUB / 2], dpacc[SUB / 2];
        wgmma_fence();
        product_abt<HDP, SUB>(sacc, a_k, kWgKvKeys, sQ + off, kWgKvQueries);
        wgmma_commit();
        product_abt<HDP, SUB>(dpacc, a_v, kWgKvKeys, sdO + off, kWgKvQueries);
        wgmma_commit();

        // the lse (log2 domain) and D of the thread's columns
        const float* l = l_base + s * (G::KV_LD / 4) + sub * SUB;
        float lv[2 * NJ], dd[2 * NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(l + 8 * j + 2 * t4);
          const float2 d2 = *reinterpret_cast<const float2*>(l + kWgKvQueries + 8 * j + 2 * t4);
          lv[2 * j] = l2.x * kLog2e;
          lv[2 * j + 1] = l2.y * kLog2e;
          dd[2 * j] = d2.x;
          dd[2 * j + 1] = d2.y;
        }
        wgmma_wait<1>();
        fence_regs(sacc);

        // P^T (bf16, register-A layout) and, in sacc, P times the softcap's factor
        uint32_t pa[NJ * 2];
        const int qpos0 = q0 + sc.q_offset;
        if (tile_needs_mask(sc, q0, SUB, wk0, 64)) {
          if (cap) p_keys<true, true, NJ>(sacc, pa, lv, sc, kpos0, qpos0);
          else p_keys<false, true, NJ>(sacc, pa, lv, sc, kpos0, qpos0);
        } else {
          if (cap) p_keys<true, false, NJ>(sacc, pa, lv, sc, kpos0, qpos0);
          else p_keys<false, false, NJ>(sacc, pa, lv, sc, kpos0, qpos0);
        }
        wgmma_wait<0>();
        fence_regs(dpacc);

        // dS^T = P (dP^T - D) (times 1 - tanh^2)
        uint32_t dsa[NJ * 2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dsa[2 * j] = pack_bf16(sacc[4 * j] * (dpacc[4 * j] - dd[2 * j]),
                                 sacc[4 * j + 1] * (dpacc[4 * j + 1] - dd[2 * j + 1]));
          dsa[2 * j + 1] = pack_bf16(sacc[4 * j + 2] * (dpacc[4 * j + 2] - dd[2 * j]),
                                     sacc[4 * j + 3] * (dpacc[4 * j + 3] - dd[2 * j + 1]));
        }

        // dV += P^T dO and dK += dS^T Q, nothing else in flight
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
        product_ab<HDP, SUB>(dv_acc, pa, sdO + off);
        product_ab<HDP, SUB>(dk_acc, dsa, sQ + off);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // the warp is done with the stage
  }

  const int64_t kv_stride = (int64_t)KV * hd;
  const int64_t out_off = (int64_t)b * sc.Skv * kv_stride + (int64_t)kvh * hd;
  store_rows<HDP>(dk + out_off, kv_stride, hd, wk0 + 16 * warp, sc.Skv, dk_acc, scale);
  store_rows<HDP>(dv + out_off, kv_stride, hd, wk0 + 16 * warp, sc.Skv, dv_acc, 1.f);
}

template <int HDP>
__global__ void __launch_bounds__(kQThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
          const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
          const float* __restrict__ lse, const float* __restrict__ dsum, bf16* __restrict__ dq,
          int Sq, int H, int KV, int B, int hd, int n_qtiles, Score sc, float scale) {
  using G = Geo<HDP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + G::Q_ROWS;
  const uint32_t sK0 = sdO + G::Q_ROWS;                 // stage s: K at sK0 + 2 s Q_KT, then V
  const uint32_t bars = sK0 + kWgStages * 2 * G::Q_KT;
  const uint32_t q_bar = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * kWgStages + 8 * s; };

  // the query tile is the slowest index: the causally heaviest tiles come first
  const int per = H * B;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x / per)) * kWgQRows;
  const int h = (int)(blockIdx.x % per) % H;
  const int b = (int)(blockIdx.x % per) / H;
  const int kvh = h / (H / KV);
  int c_lo, c_hi;
  key_cols(sc, q0, min(kWgQRows, Sq - q0), c_lo, c_hi);
  const int kv_begin = c_lo / kWgQKeys * kWgQKeys;
  const int n_kt = c_hi > kv_begin ? (c_hi - kv_begin + kWgQKeys - 1) / kWgQKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp_id = threadIdx.x / 32;
  if (warp_id == kConsumerWarps) {
    // the producer warp: its lane 0 issues every copy
    if (threadIdx.x % 32 == 0 && n_kt > 0) {
      mbar_expect_tx(q_bar, 2 * G::Q_ROWS);
      tma_rows<G::CB>(sQ, &q_map, q_bar, kWgQRows, h, q0, b);
      tma_rows<G::CB>(sdO, &do_map, q_bar, kWgQRows, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kWgStages;
        if (j >= kWgStages) mbar_spin(empty(s), (j / kWgStages - 1) & 1);
        const uint32_t sK = sK0 + s * 2 * G::Q_KT;
        const int kv0 = kv_begin + j * kWgQKeys;
        mbar_expect_tx(full(s), 2 * G::Q_KT);
        tma_rows<G::CB>(sK, &k_map, full(s), kWgQKeys, kvh, kv0, b);
        tma_rows<G::CB>(sK + G::Q_KT, &v_map, full(s), kWgQKeys, kvh, kv0, b);
      }
    }
  } else {
    const int cw = warp_id / 4;  // consumer warpgroup: rows q0 + 64 cw ..
    const int warp = warp_id % 4, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
    const int wq0 = q0 + 64 * cw;
    const int wnq = min(64, Sq - wq0);
    int w_lo = 0, w_hi = 0;  // the keys the warpgroup's rows see
    if (wnq > 0) key_cols(sc, wq0, wnq, w_lo, w_hi);
    const int row0 = wq0 + 16 * warp + g;  // the thread's rows: row0, row0 + 8
    const uint32_t a_q = sQ + cw * 64 * kRowBytes, a_do = sdO + cw * 64 * kRowBytes;
    const bool cap = sc.cap_in != 0.f;

    // the lse (log2 domain) and D of the thread's rows; +inf and 0 past Sq
    float lse2[2], dd[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = row0 + 8 * e;
      const int64_t row = ((int64_t)b * H + h) * Sq + i;
      lse2[e] = i < Sq ? lse[row] * kLog2e : INFINITY;
      dd[e] = i < Sq ? dsum[row] : 0.f;
    }

    float dq_acc[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dq_acc[i] = 0.f;

    if (n_kt > 0) mbar_wait(q_bar, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % kWgStages;
      const int kv0 = kv_begin + j * kWgQKeys;
      mbar_wait(full(s), (j / kWgStages) & 1);
      if (kv0 < w_hi && kv0 + kWgQKeys > w_lo) {
        const uint32_t sK = sK0 + s * 2 * G::Q_KT, sV = sK + G::Q_KT;

        // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows
        float sacc[32], dpacc[32];
        wgmma_fence();
        product_abt<HDP, kWgQKeys>(sacc, a_q, kWgQRows, sK, kWgQKeys);
        wgmma_commit();
        product_abt<HDP, kWgQKeys>(dpacc, a_do, kWgQRows, sV, kWgQKeys);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);

        // P, times the softcap's factor, in place of S
        const int qpos0 = row0 + sc.q_offset;
        if (tile_needs_mask(sc, wq0, 64, kv0, kWgQKeys)) {
          if (cap) p_rows<true, true>(sacc, lse2, sc, kv0, qpos0);
          else p_rows<false, true>(sacc, lse2, sc, kv0, qpos0);
        } else {
          if (cap) p_rows<true, false>(sacc, lse2, sc, kv0, qpos0);
          else p_rows<false, false>(sacc, lse2, sc, kv0, qpos0);
        }
        wgmma_wait<0>();
        fence_regs(dpacc);

        // dS = P (dP - D), then dQ += dS K
        uint32_t dsa[16];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          dsa[2 * n] = pack_bf16(sacc[4 * n] * (dpacc[4 * n] - dd[0]),
                                 sacc[4 * n + 1] * (dpacc[4 * n + 1] - dd[0]));
          dsa[2 * n + 1] = pack_bf16(sacc[4 * n + 2] * (dpacc[4 * n + 2] - dd[1]),
                                     sacc[4 * n + 3] * (dpacc[4 * n + 3] - dd[1]));
        }
        fence_regs(dq_acc);
        wgmma_fence();
        product_ab<HDP, kWgQKeys>(dq_acc, dsa, sK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // the warp is done with the stage
    }

    const int64_t q_stride = (int64_t)H * hd;
    store_rows<HDP>(dq + (int64_t)b * Sq * q_stride + (int64_t)h * hd, q_stride, hd,
                    wq0 + 16 * warp, Sq, dq_acc, scale);
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

}  // namespace wg

// ---------------------------------------------------------------------------
// simt: fp32 math, for fp32 and for bf16 at head_dim 16 and 32
// ---------------------------------------------------------------------------
namespace simt {

// Output columns per thread, and hd padded to 16 of them (hd 120 -> 128).
template <int HD> __host__ __device__ constexpr int dpt() { return (HD + 15) / 16; }
template <int HD> __host__ __device__ constexpr int ld() { return 16 * dpt<HD>() + 1; }

template <int HD>
__host__ __device__ constexpr size_t dkv_smem() {  // K, V, Q, dO, P^T, dS^T, lse, D
  return sizeof(float) * (2 * (size_t)kKvKeys * ld<HD>() + 2 * (size_t)kKvQueries * ld<HD>() +
                          2 * (size_t)kKvKeys * (kKvQueries + 1) + 2 * kKvQueries);
}
template <int HD>
__host__ __device__ constexpr size_t dq_smem() {  // Q, dO, K, V, dS, lse, D
  return sizeof(float) * (2 * (size_t)kQRows * ld<HD>() + 2 * (size_t)kQKeys * ld<HD>() +
                          (size_t)kQRows * (kQKeys + 1) + 2 * kQRows);
}

// `rows` rows of one head as f32 rows of ld<HD>() floats; rows at or past n
// and columns at or past HD are 0.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* __restrict__ dst, const T* __restrict__ src,
                                      int64_t stride, int rows, int n) {
  constexpr int LD = ld<HD>();
  for (int i = threadIdx.x; i < rows * (LD - 1); i += kSimtThreads) {
    const int r = i / (LD - 1);
    const int c = i - r * (LD - 1);
    dst[r * LD + c] = r < n && c < HD ? to_f32(src[r * stride + c]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kSimtThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int Sq, int H,
           int KV, Score sc, float scale) {
  constexpr int LD = ld<HD>();
  constexpr int DPT = dpt<HD>();
  constexpr int PLD = kKvQueries + 1;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kKvKeys * LD;
  float* q_s = v_s + kKvKeys * LD;
  float* do_s = q_s + kKvQueries * LD;
  float* p_s = do_s + kKvQueries * LD;  // P^T: (key, query)
  float* ds_s = p_s + kKvKeys * PLD;    // dS^T
  float* l_s = ds_s + kKvKeys * PLD;    // lse (log2 domain), then D
  const int k0 = blockIdx.x * kKvKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(kKvKeys, sc.Skv - k0);
  const int rep = H / KV;
  int r_lo, r_hi;
  query_rows(sc, k0, nk, Sq, r_lo, r_hi);
  const int t_lo = r_lo / kKvQueries;
  const int n_qt = r_lo <= r_hi ? r_hi / kKvQueries - t_lo + 1 : 0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // keys ty*4.., queries tx*2..
  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)KV * HD;
  const int64_t kv_off = ((int64_t)b * sc.Skv + k0) * kv_stride + (int64_t)kvh * HD;
  if (n_qt > 0) {
    stage<T, HD>(k_s, k + kv_off, kv_stride, kKvKeys, nk);
    stage<T, HD>(v_s, v + kv_off, kv_stride, kKvKeys, nk);
  }

  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int it = 0; it < rep * n_qt; ++it) {
    const int h = kvh * rep + it / n_qt;
    const int q0 = (t_lo + it % n_qt) * kKvQueries;
    const int nq = min(kKvQueries, Sq - q0);
    const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
    __syncthreads();  // the previous tile is consumed
    stage<T, HD>(q_s, q + q_off, q_stride, kKvQueries, nq);
    stage<T, HD>(do_s, dout + q_off, q_stride, kKvQueries, nq);
    if (threadIdx.x < kKvQueries) {
      const int64_t row = ((int64_t)b * H + h) * Sq + q0 + threadIdx.x;
      const bool in = (int)threadIdx.x < nq;
      l_s[threadIdx.x] = in ? lse[row] * kLog2e : INFINITY;
      l_s[kKvQueries + threadIdx.x] = in ? dsum[row] : 0.f;
    }
    __syncthreads();

    float s[4][2] = {}, dp[4][2] = {};
    for (int d = 0; d < HD; ++d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float kk = k_s[(ty * 4 + i) * LD + d], vv = v_s[(ty * 4 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(kk, q_s[(tx * 2 + j) * LD + d], s[i][j]);
          dp[i][j] = fmaf(vv, do_s[(tx * 2 + j) * LD + d], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = ty * 4 + i, col = tx * 2 + j;
        float p, ds;
        p_ds(sc, s[i][j], dp[i][j], valid(sc, k0 + key, q0 + col + sc.q_offset), l_s[col],
             l_s[kKvQueries + col], p, ds);
        p_s[key * PLD + col] = p;
        ds_s[key * PLD + col] = ds;
      }
    __syncthreads();

    for (int qq = 0; qq < kKvQueries; ++qq) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty * 4 + i) * PLD + qq], ds = ds_s[(ty * 4 + i) * PLD + qq];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dv_acc[i][c] = fmaf(p, do_s[qq * LD + tx * DPT + c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, q_s[qq * LD + tx * DPT + c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nk) continue;
    T* dkr = dk + kv_off + r * kv_stride;
    T* dvr = dv + kv_off + r * kv_stride;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx * DPT + c;
      if (col < HD) {
        dkr[col] = from_f32<T>(dk_acc[i][c] * scale);
        dvr[col] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kSimtThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, int Sq, int H, int KV, Score sc,
          float scale) {
  constexpr int LD = ld<HD>();
  constexpr int DPT = dpt<HD>();
  constexpr int SLD = kQKeys + 1;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kQRows * LD;
  float* k_s = do_s + kQRows * LD;
  float* v_s = k_s + kQKeys * LD;
  float* ds_s = v_s + kQKeys * LD;  // (query, key)
  float* l_s = ds_s + kQRows * SLD;  // lse (log2 domain), then D
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nq = min(kQRows, Sq - q0);
  int c_lo, c_hi;
  key_cols(sc, q0, nq, c_lo, c_hi);
  const int kv_begin = c_lo / kQKeys * kQKeys;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // rows ty*4.., keys tx*4..
  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)KV * HD;
  const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
  stage<T, HD>(q_s, q + q_off, q_stride, kQRows, nq);
  stage<T, HD>(do_s, dout + q_off, q_stride, kQRows, nq);
  if (threadIdx.x < kQRows) {
    const int64_t row = ((int64_t)b * H + h) * Sq + q0 + threadIdx.x;
    const bool in = (int)threadIdx.x < nq;
    l_s[threadIdx.x] = in ? lse[row] * kLog2e : INFINITY;
    l_s[kQRows + threadIdx.x] = in ? dsum[row] : 0.f;
  }

  float dq_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq_acc[i][c] = 0.f;

  for (int kv0 = kv_begin; kv0 < c_hi; kv0 += kQKeys) {
    const int64_t kv_off = ((int64_t)b * sc.Skv + kv0) * kv_stride + (int64_t)kvh * HD;
    __syncthreads();  // the previous tile is consumed
    stage<T, HD>(k_s, k + kv_off, kv_stride, kQKeys, sc.Skv - kv0);
    stage<T, HD>(v_s, v + kv_off, kv_stride, kQKeys, sc.Skv - kv0);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < HD; ++d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qq = q_s[(ty * 4 + i) * LD + d], oo = do_s[(ty * 4 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qq, k_s[(tx * 4 + j) * LD + d], s[i][j]);
          dp[i][j] = fmaf(oo, v_s[(tx * 4 + j) * LD + d], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 4 + i, key = tx * 4 + j;
        float p, ds;
        p_ds(sc, s[i][j], dp[i][j], valid(sc, kv0 + key, q0 + row + sc.q_offset), l_s[row],
             l_s[kQRows + row], p, ds);
        ds_s[row * SLD + key] = ds;
      }
    __syncthreads();

    for (int kk = 0; kk < kQKeys; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(ty * 4 + i) * SLD + kk];
#pragma unroll
        for (int c = 0; c < DPT; ++c)
          dq_acc[i][c] = fmaf(ds, k_s[kk * LD + tx * DPT + c], dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    T* dqr = dq + q_off + r * q_stride;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx * DPT + c;
      if (col < HD) dqr[col] = from_f32<T>(dq_acc[i][c] * scale);
    }
  }
}

}  // namespace simt

// The opt-in above 48 KB of dynamic shared memory, once per kernel.
template <typename K>
int configure(K kernel, size_t smem, bool& done) {
  if (!done) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *dq, *dk, *dv;
  float* dsum;
  int B, Sq, Skv, H, KV;
  Score sc;
  float scale;
  cudaStream_t stream;
};

template <typename T>
int launch_dot(const Args& a, int hd) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  dot_kernel<T><<<(unsigned)((rows + kDotRows - 1) / kDotRows), 32 * kDotRows, 0, a.stream>>>(
      static_cast<const T*>(a.dout), static_cast<const T*>(a.out), a.dsum, a.Sq, a.H, hd, rows);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_wgmma(const Args& a, int hd) {
  using G = wg::Geo<HDP>;
  using bf16 = __nv_bfloat16;
  static bool dkv_done = false, dq_done = false;
  int err = configure(wg::dkv_kernel<HDP>, G::KV_SMEM, dkv_done);
  if (!err) err = configure(wg::dq_kernel<HDP>, G::Q_SMEM, dq_done);
  const int n_kt = (a.Skv + kWgKvKeys - 1) / kWgKvKeys;
  const int n_qt = (a.Sq + kWgQRows - 1) / kWgQRows;
  if (!err &&
      ((int64_t)n_kt * a.KV * a.B >= (1ll << 31) || (int64_t)n_qt * a.H * a.B >= (1ll << 31)))
    err = (int)cudaErrorInvalidConfiguration;
  // D first: its launch also makes the device's context current on this
  // thread, which the driver's map encoding needs (autograd runs the
  // backward on a thread of its own)
  if (!err) err = launch_dot<bf16>(a, hd);
  // the dkv kernel's maps: Q and dO in tiles of kWgKvQueries rows, K and V
  // in blocks of kWgKvKeys; the dq kernel's: Q and dO in blocks of
  // kWgQRows, K and V in tiles of kWgQKeys
  CUtensorMap kv_q, kv_do, kv_k, kv_v, q_q, q_do, q_k, q_v;
  if (!err) err = wg::make_map(&kv_q, a.q, a.B, a.Sq, a.H, hd, kWgKvQueries);
  if (!err) err = wg::make_map(&kv_do, a.dout, a.B, a.Sq, a.H, hd, kWgKvQueries);
  if (!err) err = wg::make_map(&kv_k, a.k, a.B, a.Skv, a.KV, hd, kWgKvKeys);
  if (!err) err = wg::make_map(&kv_v, a.v, a.B, a.Skv, a.KV, hd, kWgKvKeys);
  if (!err) err = wg::make_map(&q_q, a.q, a.B, a.Sq, a.H, hd, kWgQRows);
  if (!err) err = wg::make_map(&q_do, a.dout, a.B, a.Sq, a.H, hd, kWgQRows);
  if (!err) err = wg::make_map(&q_k, a.k, a.B, a.Skv, a.KV, hd, kWgQKeys);
  if (!err) err = wg::make_map(&q_v, a.v, a.B, a.Skv, a.KV, hd, kWgQKeys);
  if (err) return err;
  wg::dkv_kernel<HDP><<<n_kt * a.KV * a.B, wg::kKvThreads, G::KV_SMEM, a.stream>>>(
      kv_q, kv_do, kv_k, kv_v, static_cast<const float*>(a.lse), a.dsum,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.H, a.KV, a.B, hd, a.sc, a.scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  wg::dq_kernel<HDP><<<n_qt * a.H * a.B, wg::kQThreads, G::Q_SMEM, a.stream>>>(
      q_q, q_do, q_k, q_v, static_cast<const float*>(a.lse), a.dsum, static_cast<bf16*>(a.dq),
      a.Sq, a.H, a.KV, a.B, hd, n_qt, a.sc, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_simt(const Args& a) {
  static bool dkv_done = false, dq_done = false;
  const size_t kv_smem = simt::dkv_smem<HD>(), q_smem = simt::dq_smem<HD>();
  int err = configure(simt::dkv_kernel<T, HD>, kv_smem, dkv_done);
  if (!err) err = configure(simt::dq_kernel<T, HD>, q_smem, dq_done);
  if (!err) err = launch_dot<T>(a, HD);
  if (err) return err;
  const dim3 kv_grid((a.Skv + kKvKeys - 1) / kKvKeys, a.KV, a.B);
  simt::dkv_kernel<T, HD><<<kv_grid, kSimtThreads, kv_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse), a.dsum,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.H, a.KV, a.sc, a.scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 q_grid((a.Sq + kQRows - 1) / kQRows, a.H, a.B);
  simt::dq_kernel<T, HD><<<q_grid, kSimtThreads, q_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse), a.dsum,
      static_cast<T*>(a.dq), a.Sq, a.H, a.KV, a.sc, a.scale);
  return (int)cudaGetLastError();
}

int launch_any(int dtype, int hd, bool use_wgmma, const Args& a) {
  using bf16 = __nv_bfloat16;
  if (use_wgmma) return hd <= 64 ? launch_wgmma<64>(a, hd) : launch_wgmma<128>(a, hd);
  if (dtype == 0) {
    switch (hd) {
      case 16: return launch_simt<float, 16>(a);
      case 32: return launch_simt<float, 32>(a);
      case 64: return launch_simt<float, 64>(a);
      case 120: return launch_simt<float, 120>(a);
      case 128: return launch_simt<float, 128>(a);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return launch_simt<bf16, 16>(a);
      case 32: return launch_simt<bf16, 32>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Which design the entry point launches for these inputs: 1 wgmma, 0 simt.
int repro_flash_attention_bwd_design(int dtype, int hd) {
  return dtype == 1 && (hd == 64 || hd == 120 || hd == 128) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. dsum: (B, H, Sq) f32 scratch. Returns a
// cudaError_t (0 on success); the caller has checked shapes, types,
// devices, contiguity and alignment.
int repro_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                              const void* out, const void* lse, const void* dout, void* dq,
                              void* dk, void* dv, void* dsum, int B, int Sq, int Skv, int H,
                              int KV, int hd, int causal, int window, float softcap,
                              int q_offset, float sm_scale, void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sq < 0 || Skv < 0 || q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t esize = dtype == 0 ? 4 : 2;
  if (Sq == 0 || Skv == 0 || H == 0) {  // no pair: every gradient is 0
    cudaError_t e = cudaMemsetAsync(dq, 0, (size_t)B * Sq * H * hd * esize, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dk, 0, (size_t)B * Skv * KV * hd * esize, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, (size_t)B * Skv * KV * hd * esize, s);
    return (int)e;
  }
  // a window wider than every row's reach is no window
  const int64_t reach = (int64_t)Sq + q_offset + 1;
  Score sc;
  sc.scale_log2 = sm_scale * kLog2e;
  sc.cap_in = softcap != 0.f ? sm_scale / softcap : 0.f;
  sc.cap_out = softcap * kLog2e;
  sc.causal = causal;
  sc.window = window > reach ? (int)reach : window;
  sc.q_offset = q_offset;
  sc.Skv = Skv;
  const Args a{q, k, v, out, lse, dout, dq, dk, dv, static_cast<float*>(dsum),
               B, Sq, Skv, H, KV, sc, sm_scale, s};
  return launch_any(dtype, hd, repro_flash_attention_bwd_design(dtype, hd) != 0, a);
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
