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
// does seven products a pair (S and dP are formed in both kernels) and runs
// them on mma.sync, not wgmma: it is the simple design that is right.
//
// Three kernels, launched in order on one stream:
//   1. dot: D = rowsum(do * out) in f32, a warp a row.
//   2. dkv: a block of 4 warps a (batch row, KV head, tile of kKvKeys keys).
//      It loops over the query heads of the GQA group and, for each, the
//      query tiles of kKvQueries rows that the masks leave valid for its
//      keys, recomputes S^T = K Q^T and P^T, and keeps dV += P^T dO and
//      dK += dS^T Q in registers (warp w: keys 16w..16w+15), so the group's
//      sum happens inside the block. K and V stay in shared memory; Q, dO
//      and the tile's lse and D come through a 2-stage cp.async ring.
//   3. dq: a block a (batch row, q head, tile of kQRows queries), the
//      heaviest causal tiles first. It loops over the key tiles of kQKeys
//      keys the masks leave valid and keeps dQ += dS K in registers. Q and
//      dO stay in shared memory; K and V come through a 2-stage ring.
// Tiles the masks cover wholly are never loaded; the masks run only on
// tiles that cut the causal diagonal, the window's edge or Skv (rows past
// Sq have zero Q and dO and lse +inf, so they add nothing). No atomics and
// no split reduction: every sum runs in one fixed order, so two runs give
// the same gradients bit for bit. The tile sizes below are the only
// source: tests/test_torch_flash_bwd.py's tiled mirror reads these lines.
//
// Two designs, chosen by the entry point from the input alone:
// * mma: bf16 at head_dim 64, 120 and 128. Every product is mma.sync
//   m16n8k16, bf16 x bf16 -> f32, operands by ldmatrix from shared rows
//   padded to an odd number of 16-byte units (no bank conflicts); P and dS
//   come straight from the accumulator fragments, rounded to bf16, as the A
//   operand of the next product (dS from the f32 P). hd 120 is read as 128
//   columns whose last 8 are zeroed once in shared memory. Exponents in the
//   log2 domain (exp2 of s log2(e) - lse log2(e)).
// * simt: fp32 math on the CUDA cores for fp32 inputs (TF32 would miss the
//   2e-5 parity) and for bf16 at head_dim 16 and 32: a block of 256
//   threads, the same grid and tiles, every operand staged in shared memory
//   as f32.
// Later work (not here): wgmma with TMA-fed tiles and a warp-specialised
// pipeline, and one kernel that forms S and dP once.
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKvKeys = 64;      // dkv kernel: keys of a block
constexpr int kKvQueries = 32;   // dkv kernel: queries of an inner tile
constexpr int kQRows = 64;       // dq kernel: queries of a block
constexpr int kQKeys = 64;       // dq kernel: keys of an inner tile
constexpr int kDotRows = 8;      // dot kernel: rows of a block, a warp each
constexpr int kMmaThreads = 128;
constexpr int kSimtThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kKvKeys == 16 * (kMmaThreads / 32), "mma dkv: a warp owns 16 keys");
static_assert(kQRows == 16 * (kMmaThreads / 32), "mma dq: a warp owns 16 query rows");
static_assert(kKvKeys == 4 * 16 && kKvQueries == 2 * 16, "simt dkv: 16 x 16 threads, 4 x 2 each");
static_assert(kQRows == 4 * 16 && kQKeys == 4 * 16, "simt dq: 16 x 16 threads, 4 x 4 each");

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
// mma: bf16 at head_dim 64, 120 and 128
// ---------------------------------------------------------------------------
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, L1 bypassed; live false zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a.b: m16n8k16, bf16 in, f32 accumulate. a0/a2 rows 0-7, a1/a3 rows 8-15.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
struct Geo {
  static constexpr int HDP = HD <= 64 ? 64 : 128;  // hd 120 reads as 128 columns
  static constexpr int CH = HD / 8;                // 16-byte chunks of a global row
  static constexpr int CHP = HDP / 8;              // chunks the products read
  static constexpr int ROW = (CHP + 1) * 16;       // a shared row: an odd count of 16-byte units
  static constexpr int KEYS = kKvKeys * ROW;       // dkv: K or V
  static constexpr int QT = kKvQueries * ROW;      // dkv: Q or dO of a query tile
  static constexpr int KV_STAGE = 2 * QT + 2 * kKvQueries * 4;  // Q, dO, lse, D
  static constexpr int KV_SMEM = 2 * KEYS + 2 * KV_STAGE;
  static constexpr int ROWS = kQRows * ROW;        // dq: Q or dO
  static constexpr int DQ_STAGE = 2 * kQKeys * ROW;  // K, V of a key tile
  static constexpr int DQ_SMEM = 2 * ROWS + 2 * DQ_STAGE;
};

// `rows` rows of one head into shared rows at dst (row stride `stride`
// elements); rows at or past n are zero-filled, never read.
template <int HD>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src, int64_t stride,
                                          int rows, int n) {
  using G = Geo<HD>;
  for (int i = threadIdx.x; i < rows * G::CH; i += kMmaThreads) {
    const int r = i / G::CH;
    const int c = i - r * G::CH;
    const bool live = r < n;
    cp_async16(dst + r * G::ROW + c * 16, live ? src + r * stride + c * 8 : src, live);
  }
}

// hd 120: the chunk of columns 120-127 of `rows` shared rows is 0.
template <int HD>
__device__ __forceinline__ void zero_pad(unsigned char* smem, int rows) {
  using G = Geo<HD>;
  if constexpr (G::CHP > G::CH) {
    for (int r = threadIdx.x; r < rows; r += kMmaThreads)
#pragma unroll
      for (int c = G::CH; c < G::CHP; ++c)
        *reinterpret_cast<uint4*>(smem + r * G::ROW + c * 16) = make_uint4(0, 0, 0, 0);
  }
}

// acc[n] (+)= A (16 rows x 16 cols in shared rows a_row0.., cols 16 ks..)
// . B^T for N tiles of 8 rows of b (n-tile n: rows 8n..8n+7), over the
// depth HDP: the A and B of S = A B^T, both read with the depth contiguous.
template <int HDP, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], uint32_t a_base, uint32_t b_base,
                                        int row_bytes) {
  const int lane = threadIdx.x % 32;
  const int m = lane >> 3;
  const uint32_t a_row = a_base + ((m & 1) * 8 + (lane & 7)) * row_bytes + (m >> 1) * 16;
  const uint32_t b_row = b_base + ((m >> 1) * 8 + (lane & 7)) * row_bytes + (m & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_row + ks * 32);
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_row + n * 8 * row_bytes + ks * 32);
      mma_16816(acc[n], a, b[0], b[1]);
      mma_16816(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += A . B for the HDP / 8 column tiles of B: A the K16 / 16 blocks
// of 16 x 16 bf16 in a[] (the fragments of an earlier product), B K16 rows
// of HDP columns in shared rows from b_base (read transposed).
template <int HDP, int K16>
__device__ __forceinline__ void mma_ab(float (&acc)[HDP / 8][4], const uint32_t (&a)[K16][4],
                                       uint32_t b_base, int row_bytes) {
  const int lane = threadIdx.x % 32;
  const int m = lane >> 3;
  const uint32_t b_row = b_base + ((m & 1) * 8 + (lane & 7)) * row_bytes + (m >> 1) * 16;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
#pragma unroll
    for (int n = 0; n < HDP / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_row + kk * 16 * row_bytes + n * 16);
      mma_16816(acc[n], a[kk], b[0], b[1]);
      mma_16816(acc[n + 1], a[kk], b[2], b[3]);
    }
}

// The accumulator fragments of 16 x (8 N) f32 as N / 2 A operands of bf16.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 2][4], const float (&c)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Rows of 16 x HDP f32 fragments (rows row0 + g, + 8; column pairs) to
// global rows of hd bf16, times `mul`; rows at or past n are not written.
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t stride, int hd, int row0, int n,
                                           const float (&acc)[HDP / 8][4], float mul) {
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
            __floats2bfloat162_rn(acc[j][2 * e] * mul, acc[j][2 * e + 1] * mul);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
           int H, int KV, Score sc, float scale) {
  using G = Geo<HD>;
  constexpr int HDP = G::HDP;
  constexpr int NQ = kKvQueries / 8;  // n-tiles of queries
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sK = base, sV = base + G::KEYS;
  auto stage = [&](int st) { return 2 * G::KEYS + st * G::KV_STAGE; };  // byte offset

  const int k0 = blockIdx.x * kKvKeys;  // the causally heaviest key tiles come first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(kKvKeys, sc.Skv - k0);
  const int rep = H / KV;
  int r_lo, r_hi;
  query_rows(sc, k0, nk, Sq, r_lo, r_hi);
  const int t_lo = r_lo / kKvQueries;
  const int n_qt = r_lo <= r_hi ? r_hi / kKvQueries - t_lo + 1 : 0;
  const int n_it = rep * n_qt;  // (head, query tile) pairs, heads outer

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)KV * HD;

  zero_pad<HD>(smem, 2 * kKvKeys);
  zero_pad<HD>(smem + stage(0), 2 * kKvQueries);
  zero_pad<HD>(smem + stage(1), 2 * kKvQueries);
  const int64_t kv_off = ((int64_t)b * sc.Skv + k0) * kv_stride + (int64_t)kvh * HD;
  if (n_it > 0) {  // no query sees these keys: dK = dV = 0, nothing loaded
    copy_rows<HD>(sK, k + kv_off, kv_stride, kKvKeys, nk);
    copy_rows<HD>(sV, v + kv_off, kv_stride, kKvKeys, nk);
  }

  auto load_tile = [&](int it) {  // Q, dO, lse and D of (head, query tile) `it` into its stage
    const int h = kvh * rep + it / n_qt;
    const int q0 = (t_lo + it % n_qt) * kKvQueries;
    const int nq = min(kKvQueries, Sq - q0);
    const int off = stage(it % 2);
    const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
    copy_rows<HD>(base + off, q + q_off, q_stride, kKvQueries, nq);
    copy_rows<HD>(base + off + G::QT, dout + q_off, q_stride, kKvQueries, nq);
    float* l_s = reinterpret_cast<float*>(smem + off + 2 * G::QT);
    if (tid < kKvQueries) {
      const int64_t row = ((int64_t)b * H + h) * Sq + q0 + tid;
      l_s[tid] = tid < nq ? lse[row] * kLog2e : INFINITY;
      l_s[kKvQueries + tid] = tid < nq ? dsum[row] : 0.f;
    }
  };
  if (n_it > 0) load_tile(0);
  cp_async_commit();

  float dk_acc[HDP / 8][4], dv_acc[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and tile `it` are in
    __syncthreads();
    const int off = stage(it % 2);
    const uint32_t sQ = base + off, sdO = base + off + G::QT;
    const float* l_s = reinterpret_cast<const float*>(smem + off + 2 * G::QT);
    const int q0 = (t_lo + it % n_qt) * kKvQueries;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<HDP, NQ>(s, sK + 16 * w * G::ROW, sQ, G::ROW);
    mma_abt<HDP, NQ>(dp, sV + 16 * w * G::ROW, sdO, G::ROW);

    // P^T and dS^T in place of S^T and dP^T
    const bool need_mask = tile_needs_mask(sc, q0, kKvQueries, k0, kKvKeys);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);  // query of the tile
        const int kpos = k0 + 16 * w + g + 8 * (e >> 1);
        const bool ok = !need_mask || valid(sc, kpos, q0 + col + sc.q_offset);
        float p, ds;
        p_ds(sc, s[j][e], dp[j][e], ok, l_s[col], l_s[kKvQueries + col], p, ds);
        s[j][e] = p;
        dp[j][e] = ds;
      }

    // dV += P^T dO, dK += dS^T Q (P and dS rounded to bf16)
    uint32_t a[NQ / 2][4];
    to_a<NQ>(a, s);
    mma_ab<HDP, NQ / 2>(dv_acc, a, sdO, G::ROW);
    to_a<NQ>(a, dp);
    mma_ab<HDP, NQ / 2>(dk_acc, a, sQ, G::ROW);
    __syncthreads();  // the stage is free for tile it + 2
  }
  cp_async_wait<0>();

  const int64_t out_off = (int64_t)b * sc.Skv * kv_stride + (int64_t)kvh * HD;
  store_rows<HDP>(dk + out_off, kv_stride, HD, k0 + 16 * w, sc.Skv, dk_acc, scale);
  store_rows<HDP>(dv + out_off, kv_stride, HD, k0 + 16 * w, sc.Skv, dv_acc, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, bf16* __restrict__ dq, int Sq, int H, int KV, Score sc,
          float scale) {
  using G = Geo<HD>;
  constexpr int HDP = G::HDP;
  constexpr int NK = kQKeys / 8;  // n-tiles of keys
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t sQ = base, sdO = base + G::ROWS;
  auto stage = [&](int st) { return 2 * G::ROWS + st * G::DQ_STAGE; };  // byte offset

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nq = min(kQRows, Sq - q0);
  int c_lo, c_hi;
  key_cols(sc, q0, nq, c_lo, c_hi);
  const int kv_begin = c_lo / kQKeys * kQKeys;
  const int n_kt = c_hi > kv_begin ? (c_hi - kv_begin + kQKeys - 1) / kQKeys : 0;

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int64_t q_stride = (int64_t)H * HD;
  const int64_t kv_stride = (int64_t)KV * HD;

  zero_pad<HD>(smem, 2 * kQRows + 4 * kQKeys);
  const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
  if (n_kt > 0) {  // no key is seen by these rows: dQ = 0, nothing loaded
    copy_rows<HD>(sQ, q + q_off, q_stride, kQRows, nq);
    copy_rows<HD>(sdO, dout + q_off, q_stride, kQRows, nq);
  }
  auto load_tile = [&](int j) {  // K and V of key tile j into its stage
    const int kv0 = kv_begin + j * kQKeys;
    const int64_t off = ((int64_t)b * sc.Skv + kv0) * kv_stride + (int64_t)kvh * HD;
    const uint32_t dst = base + stage(j % 2);
    copy_rows<HD>(dst, k + off, kv_stride, kQKeys, sc.Skv - kv0);
    copy_rows<HD>(dst + kQKeys * G::ROW, v + off, kv_stride, kQKeys, sc.Skv - kv0);
  };
  if (n_kt > 0) load_tile(0);
  cp_async_commit();

  // the lse (log2 domain) and D of rows g and g + 8 of the warp
  float lse2[2], dd[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = q0 + 16 * w + g + 8 * e;
    const int64_t row = ((int64_t)b * H + h) * Sq + i;
    lse2[e] = i < Sq ? lse[row] * kLog2e : INFINITY;
    dd[e] = i < Sq ? dsum[row] : 0.f;
  }

  float dq_acc[HDP / 8][4];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and key tile j are in
    __syncthreads();
    const uint32_t sK = base + stage(j % 2);
    const uint32_t sV = sK + kQKeys * G::ROW;
    const int kv0 = kv_begin + j * kQKeys;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<HDP, NK>(s, sQ + 16 * w * G::ROW, sK, G::ROW);
    mma_abt<HDP, NK>(dp, sdO + 16 * w * G::ROW, sV, G::ROW);

    const bool need_mask = tile_needs_mask(sc, q0, kQRows, kv0, kQKeys);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + 8 * n + 2 * t4 + (e & 1);
        const int qpos = q0 + 16 * w + g + 8 * (e >> 1) + sc.q_offset;
        const bool ok = !need_mask || valid(sc, kpos, qpos);
        float p, ds;
        p_ds(sc, s[n][e], dp[n][e], ok, lse2[e >> 1], dd[e >> 1], p, ds);
        dp[n][e] = ds;
      }

    // dQ += dS K (dS rounded to bf16)
    uint32_t a[NK / 2][4];
    to_a<NK>(a, dp);
    mma_ab<HDP, NK / 2>(dq_acc, a, sK, G::ROW);
    __syncthreads();  // the stage is free for tile j + 2
  }
  cp_async_wait<0>();

  store_rows<HDP>(dq + ((int64_t)b * Sq) * q_stride + (int64_t)h * HD, q_stride, HD,
                  q0 + 16 * w, Sq, dq_acc, scale);
}

}  // namespace mma

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

template <int HD>
int launch_mma(const Args& a) {
  using G = mma::Geo<HD>;
  using bf16 = __nv_bfloat16;
  static bool dkv_done = false, dq_done = false;
  int err = configure(mma::dkv_kernel<HD>, G::KV_SMEM, dkv_done);
  if (!err) err = configure(mma::dq_kernel<HD>, G::DQ_SMEM, dq_done);
  if (!err) err = launch_dot<bf16>(a, HD);
  if (err) return err;
  const dim3 kv_grid((a.Skv + kKvKeys - 1) / kKvKeys, a.KV, a.B);
  mma::dkv_kernel<HD><<<kv_grid, kMmaThreads, G::KV_SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse), a.dsum,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.H, a.KV, a.sc, a.scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 q_grid((a.Sq + kQRows - 1) / kQRows, a.H, a.B);
  mma::dq_kernel<HD><<<q_grid, kMmaThreads, G::DQ_SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse), a.dsum,
      static_cast<bf16*>(a.dq), a.Sq, a.H, a.KV, a.sc, a.scale);
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

int launch_any(int dtype, int hd, bool use_mma, const Args& a) {
  using bf16 = __nv_bfloat16;
  if (use_mma) {
    switch (hd) {
      case 64: return launch_mma<64>(a);
      case 120: return launch_mma<120>(a);
      case 128: return launch_mma<128>(a);
    }
  } else if (dtype == 0) {
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

// Which design the entry point launches for these inputs: 1 mma, 0 simt.
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
