// Paged decode attention for Hopper (sm_90a), written by hand: split-K over
// pages (flash-decoding), a cp.async ring of K/V tiles, and one combine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _paged_kernel): one new token per sequence attends
// over its K/V pages, which lie scattered through the set-associative page
// pool and are found through a per-sequence page table.
//
//   q            (B, H, hd)              float or bf16
//   k/v pages    (P, page, KV, hd)       same type as q
//   page_table   (B, max_pages) int32    pool page of each logical page
//   lengths      (B,) int32              valid keys per row
//   out          (B, H, hd)              same type as q
//
// What bounds it: bytes. Decode attention does ~4 flops per byte of K/V
// (2 for q.k and 2 for p.v per key and q head, at a GQA group of 4 in bf16),
// far below the ~295 flop/byte ridge of an H100, so the least time is the
// K/V bytes of the valid keys over 3.35 TB/s. The kernel reads each valid
// key once, never touches keys at or past lengths[b] nor the table entries
// of pages past the end, and keeps a whole GQA group (up to kMaxGroup q
// heads of one KV head) in one block, so a K/V row fetched once serves
// every head of the group.
//
// TPU -> Hopper. The TPU kernel carries (m, l, acc) along a sequential page
// axis of its grid, in VMEM scratch. Blocks of a Hopper grid run in parallel
// and in no order, and one block per (row, KV head) leaves most of the 132
// SMs idle (32 blocks at B 4, KV 8). So the page axis becomes split-K:
//   * the host cuts the table into splits of a whole number of pages, from
//     the shapes alone (the wrapper's _plan_splits; lengths are never read
//     on the host, so a call can be captured in a CUDA graph), so that
//     splits x rows x KV heads reach about two blocks per SM;
//   * grid (split, KV head x group chunk, row); a block keeps its split's
//     online softmax (m, l, acc) in f32 and writes it as a partial, or, when
//     its split is the only one that holds keys of the row, the output
//     itself; a split that starts at or past lengths[b] returns at once,
//     writing nothing;
//   * a second kernel merges the partials of each (row, q head) in split
//     order, reading only the splits that hold keys of the row (their count
//     follows from lengths[b] and the plan). No atomics, a fixed order: two
//     runs are bitwise equal.
//
// Bytes in flight. A block reads its split's table entries once, up front,
// into shared memory, then streams tiles of kTile keys of K and V through
// a ring of kStages stages with cp.async.cg (16 bytes a thread, L1
// bypassed; keys past the end are zero-filled, not read). K/V rows are
// padded to an odd number of 16-byte units, so reads of 8 or 32 rows at
// one column are free of bank conflicts. At bf16 hd 128 a stage is 17 KB
// and a block 54 KB: up to four blocks share an SM, each with two tiles in
// flight while it computes on the third.
//
// Math per tile. A block's 4 warps each take 8 keys of the tile:
//   * bf16 (every model's serving dtype): mma.sync on the tensor cores with
//     the group's q heads as the rows of a 16-row A operand (rows past the
//     group are zero): S = q.k^T by m16n8k16 over hd (K rows by ldmatrix),
//     a per-warp online softmax on S's fragments (a quad shuffle for each
//     row's max and sum, exp2f with log2(e) folded into the scale), P
//     rounded to bf16 in registers as the A operand of m16n8k8 for p.v (V by
//     ldmatrix.trans); (m, l, acc) per warp in f32, the 4 warps merged once
//     per split. hd 120 reads its rows as 128 wide: the row's padding chunk
//     is zeroed once, and q's columns past 120 are 0.
//   * f32 (the parity path, 2e-5): CUDA cores; each warp takes a quarter of
//     hd for every key of the tile (lane = key), the partial dots meet in
//     shared memory, one softmax per tile and q head, then thread (key
//     group, 16-byte chunk) accumulates p.v; the key groups are summed once
//     per split.
//   A row with lengths[b] == 0 gives 0, as the Pallas kernel does
//   (acc / max(l, 1e-30) with acc == l == 0).
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // keys per tile: 8 per warp (bf16), one per lane (f32)
constexpr int kStages = 3;           // cp.async ring depth
constexpr int kMaxGroup = 8;         // q heads per block
constexpr int kMaxSplitPages = 256;  // table entries a block keeps in shared memory
constexpr int kCombineThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile * 4 == kThreads, "the copy gives each key of a tile 4 threads");
static_assert(kTile == 8 * kWarps, "the bf16 body gives each warp 8 keys of a tile");
static_assert(kMaxGroup == 2 * kWarps, "the f32 softmax gives each warp 2 q heads");

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int odd_row(int chunks) {  // 16-byte units, odd
  return chunks % 2 ? chunks + 2 : chunks + 1;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes from global to shared memory, L1 bypassed; src_bytes 0 zero-fills.
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
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
// c += a.b: m16n8k16, bf16 in, f32 accumulate. a0/a2 rows 0-7, a1/a3 rows 8-15.
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// c += a.b: m16n8k8, bf16 in, f32 accumulate. a0 rows 0-7, a1 rows 8-15.
__device__ __forceinline__ void mma_1688(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// What both bodies share: the block's split, its table entries, the copy
// of a tile, and the store of its result.

struct Split {
  int b, kvh, ng, split, n_live, k0, k_end, n_tiles;
  int64_t head0;  // first q head of the block in (B, H)
  int64_t part0;  // its partial in (B, n_splits, H)
};

__device__ __forceinline__ Split split_of(const int* lengths, int H, int KV, int page,
                                          int max_pages, int split_pages, int n_splits) {
  Split s;
  const int group = H / KV;
  const int n_chunks = ceil_div(group, kMaxGroup);
  s.split = blockIdx.x;
  s.kvh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y - s.kvh * n_chunks) * kMaxGroup;
  s.ng = min(kMaxGroup, group - g0);
  s.b = blockIdx.z;
  const int len = min(max(lengths[s.b], 0), max_pages * page);
  const int split_keys = split_pages * page;
  s.n_live = max(1, ceil_div(len, split_keys));  // splits holding keys (1 at len 0)
  s.k0 = s.split * split_keys;
  s.k_end = min(s.k0 + split_keys, len);
  s.n_tiles = max(0, ceil_div(s.k_end - s.k0, kTile));
  s.head0 = (int64_t)s.b * H + (int64_t)s.kvh * group + g0;
  s.part0 = ((int64_t)s.b * n_splits + s.split) * H + (int64_t)s.kvh * group + g0;
  return s;
}

// The split's live table entries, once (the caller synchronizes).
__device__ __forceinline__ void load_table(const Split& s, const int* page_table, int* s_tab,
                                           int page, int max_pages, int split_pages) {
  const int n_pages = ceil_div(s.k_end - s.k0, page);
  const int* table = page_table + (int64_t)s.b * max_pages + s.split * split_pages;
  for (int i = threadIdx.x; i < n_pages; i += kThreads) s_tab[i] = table[i];
}

// Tile j of the split (keys k0 + 32 j ...) into ring stage j % kStages:
// K rows, then V rows, ROW bytes apart; 4 threads per key, 16 bytes each.
template <typename T, int HD, int ROW>
__device__ __forceinline__ void issue_tile(const Split& s, int j, const T* k_pages,
                                           const T* v_pages, const int* s_tab, int page,
                                           int KV, uint32_t ring) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int CH = HD / EPC;
  const int key = threadIdx.x >> 2;
  const int rel = j * kTile + key;  // key index within the split
  const bool live = s.k0 + rel < s.k_end;
  int64_t off = (int64_t)s.kvh * HD;
  if (live) {
    const int pi = rel / page;  // the split starts on a page boundary
    off += ((int64_t)s_tab[pi] * page + (rel - pi * page)) * KV * HD;
  }
  const uint32_t dst = ring + (j % kStages) * (2 * kTile * ROW) + key * ROW;
  for (int c = threadIdx.x & 3; c < CH; c += 4) {
    cp_async16(dst + c * 16, k_pages + off + c * EPC, live);
    cp_async16(dst + kTile * ROW + c * 16, v_pages + off + c * EPC, live);
  }
}

// The split's result: the output itself when it holds the whole row, else
// its partial (m, l, acc). o(g, d) is the unnormalized sum.
template <typename T, int HD, typename O>
__device__ __forceinline__ void store_split(const Split& s, O o, const float* s_m,
                                            const float* s_l, T* out, float* part_ml,
                                            float* part_acc) {
  const bool whole_row = s.n_live == 1;
  for (int i = threadIdx.x; i < s.ng * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    if (whole_row)
      out[(s.head0 + g) * HD + d] = from_f32<T>(o(g, d) / fmaxf(s_l[g], 1e-30f));
    else
      part_acc[(s.part0 + g) * HD + d] = o(g, d);
  }
  if (!whole_row && (int)threadIdx.x < s.ng) {
    part_ml[2 * (s.part0 + threadIdx.x)] = s_m[threadIdx.x];
    part_ml[2 * (s.part0 + threadIdx.x) + 1] = s_l[threadIdx.x];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), 8 keys of each tile per warp.

template <int HD>
struct MmaGeo {
  static constexpr int CH = HD / 8;                  // 16-byte chunks of a row
  static constexpr int KSTEPS = (HD + 15) / 16;      // q.k depth steps of 16 (hd 120: 8)
  static constexpr int NT = HD < 32 ? HD / 8 : (HD / 8 + 3) / 4 * 4;  // p.v n-tiles of 8
  static constexpr int PAD = (KSTEPS * 2 > NT ? KSTEPS * 2 : NT);     // chunks read
  static constexpr int ROW = odd_row(CH) * 16;
  static_assert(PAD * 16 <= ROW, "the chunks read past hd lie in the row's padding");
  static constexpr int STAGE = 2 * kTile * ROW;
  static constexpr int RING = kStages * STAGE;
  static constexpr int RED = kWarps * kMaxGroup * HD * 4;  // per-warp acc (reuses the ring)
  static constexpr int BUF = RING > RED ? RING : RED;
  static constexpr int SMEM = BUF + 4 * (3 * kWarps * kMaxGroup + 2 * kMaxGroup) +
                              4 * kMaxSplitPages;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k_pages,
                                 const __nv_bfloat16* __restrict__ v_pages,
                                 const int* __restrict__ page_table,
                                 const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                                 int H, int KV, int page, int max_pages, int split_pages,
                                 int n_splits, float softcap, float q_scale) {
  using G = MmaGeo<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_wm = reinterpret_cast<float*>(smem + G::BUF);  // [warp][row]: m, l, merge factor
  float* s_wl = s_wm + kWarps * kMaxGroup;
  float* s_wf = s_wl + kWarps * kMaxGroup;
  float* s_m = s_wf + kWarps * kMaxGroup;
  float* s_l = s_m + kMaxGroup;
  int* s_tab = reinterpret_cast<int*>(s_l + kMaxGroup);

  const Split s = split_of(lengths, H, KV, page, max_pages, split_pages, n_splits);
  if (s.split >= s.n_live) return;  // past the row's end: the combine reads no partial
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row (q head of the group) and column pair
  const int tq = lane & 3;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);

  load_table(s, page_table, s_tab, page, max_pages, split_pages);
  if (G::PAD > G::CH) {  // hd 120: zero the padding chunk that the mma reads
    for (int r = tid; r < kStages * 2 * kTile; r += kThreads)
      for (int c = G::CH; c < G::PAD; ++c)
        *reinterpret_cast<uint4*>(smem + r * G::ROW + c * 16) = make_uint4(0, 0, 0, 0);
  }
  // q as the A operand: row gq, columns 16 ks + 2 tq (+1) and + 8; rows 8-15 are 0
  uint32_t qa[G::KSTEPS][2];
#pragma unroll
  for (int ks = 0; ks < G::KSTEPS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * ks + 2 * tq + 8 * h;
      qa[ks][h] = gq < s.ng && d < HD
                      ? *reinterpret_cast<const uint32_t*>(q + (s.head0 + gq) * HD + d)
                      : 0u;
    }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < s.n_tiles) issue_tile<__nv_bfloat16, HD, G::ROW>(s, j, k_pages, v_pages, s_tab, page,
                                                             KV, ring);
    cp_async_commit();
  }

  const float cap_log2 = softcap * kLog2e;
  const float inv_cap = softcap != 0.f ? 1.f / softcap : 0.f;
  float m_r = -INFINITY, l_r = 0.f;  // row gq of this warp's keys
  float acc[G::NT][4];
#pragma unroll
  for (int n = 0; n < G::NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int key0 = warp * 8;

  for (int j = 0; j < s.n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    if (j + kStages - 1 < s.n_tiles)
      issue_tile<__nv_bfloat16, HD, G::ROW>(s, j + kStages - 1, k_pages, v_pages, s_tab, page,
                                            KV, ring);
    cp_async_commit();
    const int tile_live = min(kTile, s.k_end - (s.k0 + j * kTile));
    if (key0 >= tile_live) continue;  // warp-uniform: none of this warp's keys is live

    // S = q.k^T for the warp's 8 keys (ldmatrix rows = keys, 16-byte chunks of hd)
    const uint32_t kt = ring + (j % kStages) * G::STAGE;
    const uint32_t krow = kt + (key0 + (lane & 7)) * G::ROW;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks + 1 < G::KSTEPS; ks += 2) {
      uint32_t b[4];
      ldsm_x4(b, krow + (2 * ks + (lane >> 3)) * 16);
      mma_16816(c, qa[ks][0], 0u, qa[ks][1], 0u, b[0], b[1]);
      mma_16816(c, qa[ks + 1][0], 0u, qa[ks + 1][1], 0u, b[2], b[3]);
    }
    if (G::KSTEPS % 2) {
      uint32_t b[2];
      ldsm_x2(b, krow + (2 * (G::KSTEPS - 1) + ((lane >> 3) & 1)) * 16);
      mma_16816(c, qa[G::KSTEPS - 1][0], 0u, qa[G::KSTEPS - 1][1], 0u, b[0], b[1]);
    }

    // online softmax of row gq over keys key0 + 2 tq (+1); lane tq 0 of each
    // quad holds key0, which is live, so the row's max is finite
    float x0 = c[0] * q_scale, x1 = c[1] * q_scale;
    if (softcap != 0.f) {
      x0 = cap_log2 * tanhf(x0 * inv_cap);
      x1 = cap_log2 * tanhf(x1 * inv_cap);
    }
    if (key0 + 2 * tq >= tile_live) x0 = -INFINITY;
    if (key0 + 2 * tq + 1 >= tile_live) x1 = -INFINITY;
    const float m_new = fmaxf(m_r, quad_max(fmaxf(x0, x1)));
    const float corr = exp2f(m_r - m_new);
    const __nv_bfloat162 p = __floats2bfloat162_rn(exp2f(x0 - m_new), exp2f(x1 - m_new));
    const float2 pf = __bfloat1622float2(p);  // l sums the p that p.v uses
    l_r = fmaf(l_r, corr, quad_sum(pf.x + pf.y));
    m_r = m_new;
    const uint32_t pa = *reinterpret_cast<const uint32_t*>(&p);

    // acc = acc * corr + p.v (ldmatrix.trans: rows = keys, B = V by column)
    const uint32_t vrow = kt + kTile * G::ROW + (key0 + (lane & 7)) * G::ROW;
#pragma unroll
    for (int n = 0; n < G::NT; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    if (G::NT % 4 == 0) {
#pragma unroll
      for (int n = 0; n < G::NT; n += 4) {
        uint32_t b[4];
        ldsm_x4_trans(b, vrow + (n + (lane >> 3)) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_1688(acc[n + i], pa, 0u, b[i]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < G::NT; n += 2) {
        uint32_t b[2];
        ldsm_x2_trans(b, vrow + (n + ((lane >> 3) & 1)) * 16);
        mma_1688(acc[n], pa, 0u, b[0]);
        mma_1688(acc[n + 1], pa, 0u, b[1]);
      }
    }
  }

  // merge the 4 warps' softmaxes in warp order (the ring is free now)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [warp][row][hd]
  if (gq < s.ng) {
#pragma unroll
    for (int n = 0; n < G::NT; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d < HD) {
        red[(warp * kMaxGroup + gq) * HD + d] = acc[n][0];
        red[(warp * kMaxGroup + gq) * HD + d + 1] = acc[n][1];
      }
    }
    if (tq == 0) {
      s_wm[warp * kMaxGroup + gq] = m_r;
      s_wl[warp * kMaxGroup + gq] = l_r;
    }
  }
  __syncthreads();
  if (tid < s.ng) {  // the max is finite unless the row is empty (length 0)
    float mx = s_wm[tid];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_wm[w * kMaxGroup + tid]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(s_wm[w * kMaxGroup + tid] - m_use);
      s_wf[w * kMaxGroup + tid] = f;
      lsum = fmaf(s_wl[w * kMaxGroup + tid], f, lsum);
    }
    s_m[tid] = mx;
    s_l[tid] = lsum;
  }
  __syncthreads();
  store_split<__nv_bfloat16, HD>(
      s,
      [=](int g, int d) {
        float o = 0.f;
        for (int w = 0; w < kWarps; ++w)
          o = fmaf(red[(w * kMaxGroup + g) * HD + d], s_wf[w * kMaxGroup + g], o);
        return o;
      },
      s_m, s_l, out, part_ml, part_acc);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, one key per lane in the score pass.

template <int HD>
struct SimtGeo {
  static constexpr int EPC = 4;                          // floats per 16-byte chunk
  static_assert(HD % EPC == 0, "a row must be whole 16-byte chunks (cp.async)");
  static constexpr int CH = HD / EPC;                    // chunks per K/V row
  static constexpr int ROW = odd_row(CH) * 16;
  static constexpr int STAGE = 2 * kTile * ROW;          // K tile, then V tile
  static constexpr int RING = kStages * STAGE;
  static constexpr int CQ = (CH + kWarps - 1) / kWarps;  // chunks per warp, score pass
  static constexpr int KG = kThreads / CH;               // key groups, p.v pass
  static_assert(KG >= 1, "hd too wide for the p.v mapping");
  static constexpr int RED = KG * kMaxGroup * HD * 4;    // key groups' sums (reuses the ring)
  static constexpr int BUF = RING > RED ? RING : RED;
  static constexpr int FLOATS = kMaxGroup * HD           // q
                                + kWarps * kMaxGroup * kTile  // partial scores
                                + kTile * kMaxGroup      // p
                                + 3 * kMaxGroup;         // corr, m, l
  static constexpr int SMEM = BUF + 4 * FLOATS + 4 * kMaxSplitPages;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_simt_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                                  const float* __restrict__ v_pages,
                                  const int* __restrict__ page_table,
                                  const int* __restrict__ lengths, float* __restrict__ out,
                                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                                  int H, int KV, int page, int max_pages, int split_pages,
                                  int n_splits, float softcap, float q_scale) {
  using G = SimtGeo<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem + G::BUF);
  float* s_part = s_q + kMaxGroup * HD;
  float* s_p = s_part + kWarps * kMaxGroup * kTile;
  float* s_corr = s_p + kTile * kMaxGroup;
  float* s_m = s_corr + kMaxGroup;
  float* s_l = s_m + kMaxGroup;
  int* s_tab = reinterpret_cast<int*>(s_l + kMaxGroup);

  const Split s = split_of(lengths, H, KV, page, max_pages, split_pages, n_splits);
  if (s.split >= s.n_live) return;  // past the row's end: the combine reads no partial
  const int ng = s.ng;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);

  load_table(s, page_table, s_tab, page, max_pages, split_pages);
  for (int i = tid; i < kMaxGroup * HD; i += kThreads)  // the group's q, scaled
    s_q[i] = i / HD < ng ? q[s.head0 * HD + i] * q_scale : 0.f;
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < s.n_tiles) issue_tile<float, HD, G::ROW>(s, j, k_pages, v_pages, s_tab, page, KV, ring);
    cp_async_commit();
  }

  const float cap_log2 = softcap * kLog2e;
  const float inv_cap = softcap != 0.f ? 1.f / softcap : 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // q heads warp and warp + kWarps
  float l_run[2] = {0.f, 0.f};
  const int kg = tid / G::CH;               // p.v pass: key group and chunk
  const int pc = tid - kg * G::CH;
  const bool pv_on = kg < G::KG;
  float acc[kMaxGroup][G::EPC];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int e = 0; e < G::EPC; ++e) acc[g][e] = 0.f;

  for (int j = 0; j < s.n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1's stage
    if (j + kStages - 1 < s.n_tiles)
      issue_tile<float, HD, G::ROW>(s, j + kStages - 1, k_pages, v_pages, s_tab, page, KV, ring);
    cp_async_commit();
    const unsigned char* kt = smem + (j % kStages) * G::STAGE;
    const unsigned char* vt = kt + kTile * G::ROW;
    const int tile_live = min(kTile, s.k_end - (s.k0 + j * kTile));

    // 1. partial scores over this warp's chunks of hd, key = lane
    {
      float sc[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) sc[g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < G::CQ; ++cc) {
        const int ch = warp * G::CQ + cc;
        if (ch < G::CH) {
          const float4 kf = *reinterpret_cast<const float4*>(kt + lane * G::ROW + ch * 16);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < ng) {
              const float4 qv = *reinterpret_cast<const float4*>(s_q + g * HD + ch * 4);
              sc[g] = fmaf(qv.x, kf.x, sc[g]);
              sc[g] = fmaf(qv.y, kf.y, sc[g]);
              sc[g] = fmaf(qv.z, kf.z, sc[g]);
              sc[g] = fmaf(qv.w, kf.w, sc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < ng) s_part[(warp * kMaxGroup + g) * kTile + lane] = sc[g];
    }
    __syncthreads();

    // 2. the tile's softmax: warp w for q heads w and w + kWarps, key = lane
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + r * kWarps;
      if (g < ng) {
        float x = s_part[g * kTile + lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) x += s_part[(w * kMaxGroup + g) * kTile + lane];
        if (softcap != 0.f) x = cap_log2 * tanhf(x * inv_cap);
        if (lane >= tile_live) x = -INFINITY;
        const float m_new = fmaxf(m_run[r], warp_max(x));  // finite: lane 0 is live
        const float corr = exp2f(m_run[r] - m_new);
        const float p = exp2f(x - m_new);
        l_run[r] = fmaf(l_run[r], corr, warp_sum(p));
        m_run[r] = m_new;
        s_p[lane * kMaxGroup + g] = p;
        if (lane == 0) s_corr[g] = corr;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + p.v over this thread's keys of the tile, chunk pc
    if (pv_on) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < ng) {
          const float cr = s_corr[g];
#pragma unroll
          for (int e = 0; e < G::EPC; ++e) acc[g][e] *= cr;
        }
      }
      for (int key = kg; key < tile_live; key += G::KG) {
        const float4 vf = *reinterpret_cast<const float4*>(vt + key * G::ROW + pc * 16);
        const float4 pa = *reinterpret_cast<const float4*>(s_p + key * kMaxGroup);
        const float4 pb = *reinterpret_cast<const float4*>(s_p + key * kMaxGroup + 4);
        const float pp[kMaxGroup] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < ng) {
            acc[g][0] = fmaf(pp[g], vf.x, acc[g][0]);
            acc[g][1] = fmaf(pp[g], vf.y, acc[g][1]);
            acc[g][2] = fmaf(pp[g], vf.z, acc[g][2]);
            acc[g][3] = fmaf(pp[g], vf.w, acc[g][3]);
          }
        }
      }
    }
  }

  // sum the key groups (the ring is free once every copy has landed)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [key group][q head][hd]
  if (pv_on) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < ng) {
#pragma unroll
        for (int e = 0; e < G::EPC; ++e) red[(kg * kMaxGroup + g) * HD + pc * G::EPC + e] = acc[g][e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = warp + r * kWarps;
    if (g < ng && lane == 0) {
      s_m[g] = m_run[r];
      s_l[g] = l_run[r];
    }
  }
  __syncthreads();
  store_split<float, HD>(
      s,
      [=](int g, int d) {
        float o = 0.f;
        for (int w = 0; w < G::KG; ++w) o += red[(w * kMaxGroup + g) * HD + d];
        return o;
      },
      s_m, s_l, out, part_ml, part_acc);
}

// ---------------------------------------------------------------------------
// Merges the partials of one (row, q head) in split order; a row that one
// split holds whole was written by the split kernel.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
paged_attention_combine_kernel(const int* __restrict__ lengths, const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc, T* __restrict__ out, int H,
                               int page, int max_pages, int split_pages, int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(max(lengths[b], 0), max_pages * page);
  const int n_live = max(1, ceil_div(len, split_pages * page));
  if (n_live == 1) return;
  const int64_t base = (int64_t)b * n_splits * H + h;  // split s at base + s * H
  float mx = -INFINITY;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, part_ml[2 * (base + (int64_t)s * H)]);
  for (int d = threadIdx.x; d < HD; d += kCombineThreads) {
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const int64_t i = base + (int64_t)s * H;
      const float c = exp2f(part_ml[2 * i] - mx);
      lsum = fmaf(part_ml[2 * i + 1], c, lsum);
      o = fmaf(part_acc[i * HD + d], c, o);
    }
    out[((int64_t)b * H + h) * HD + d] = from_f32<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
using SplitKernel = void (*)(const T*, const T*, const T*, const int*, const int*, T*, float*,
                             float*, int, int, int, int, int, int, float, float);

template <typename T, int HD>
int launch(SplitKernel<T> split_kernel, int smem, const void* q, const void* k, const void* v,
           const int* table, const int* lengths, void* out, float* part_ml, float* part_acc,
           int B, int H, int KV, int page, int max_pages, int split_pages, int n_splits,
           float softcap, float q_scale, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in: once per
  // instantiation and device, not on every launch of a decode step
  static std::atomic<uint64_t> configured{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(configured.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(n_splits, KV * ceil_div(H / KV, kMaxGroup), B);
  split_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
      lengths, static_cast<T*>(out), part_ml, part_acc, H, KV, page, max_pages, split_pages,
      n_splits, softcap, q_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  paged_attention_combine_kernel<T, HD><<<dim3(H, B), kCombineThreads, 0, stream>>>(
      lengths, part_ml, part_acc, static_cast<T*>(out), H, page, max_pages, split_pages,
      n_splits);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v, const int* table,
              const int* lengths, void* out, float* ml, float* acc, int B, int H, int KV,
              int page, int max_pages, int sp, int ns, float softcap, float q_scale,
              cudaStream_t s) {
  if (dtype == 0)
    return launch<float, HD>(paged_attention_split_simt_kernel<HD>, SimtGeo<HD>::SMEM, q, k, v,
                             table, lengths, out, ml, acc, B, H, KV, page, max_pages, sp, ns,
                             softcap, q_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, HD>(paged_attention_split_mma_kernel<HD>, MmaGeo<HD>::SMEM, q,
                                     k, v, table, lengths, out, ml, acc, B, H, KV, page,
                                     max_pages, sp, ns, softcap, q_scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. The table is cut into n_splits splits of
// split_pages pages (the last may be shorter); with n_splits > 1, part_ml
// (B, n_splits, H, 2) and part_acc (B, n_splits, H, hd) are f32 scratch
// (part_acc 4-byte aligned at least).
// q_scale is hd**-0.5, times log2(e) without a softcap. Returns a cudaError_t
// (0 on success); the caller has checked types, devices and contiguity.
int repro_paged_attention(int dtype, const void* q, const void* k_pages, const void* v_pages,
                          const int* page_table, const int* lengths, void* out, void* part_ml,
                          void* part_acc, int B, int H, int KV, int hd, int page,
                          int max_pages, int split_pages, int n_splits, float softcap,
                          float q_scale, void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page <= 0 || B > 65535 || split_pages < 1 ||
      split_pages > kMaxSplitPages || n_splits < 1 ||
      (int64_t)split_pages * n_splits < max_pages ||
      (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  switch (hd) {
    case 16: return launch_hd<16>(dtype, q, k_pages, v_pages, page_table, lengths, out, ml, acc, B, H, KV, page, max_pages, split_pages, n_splits, softcap, q_scale, s);
    case 32: return launch_hd<32>(dtype, q, k_pages, v_pages, page_table, lengths, out, ml, acc, B, H, KV, page, max_pages, split_pages, n_splits, softcap, q_scale, s);
    case 64: return launch_hd<64>(dtype, q, k_pages, v_pages, page_table, lengths, out, ml, acc, B, H, KV, page, max_pages, split_pages, n_splits, softcap, q_scale, s);
    case 120: return launch_hd<120>(dtype, q, k_pages, v_pages, page_table, lengths, out, ml, acc, B, H, KV, page, max_pages, split_pages, n_splits, softcap, q_scale, s);
    case 128: return launch_hd<128>(dtype, q, k_pages, v_pages, page_table, lengths, out, ml, acc, B, H, KV, page, max_pages, split_pages, n_splits, softcap, q_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
