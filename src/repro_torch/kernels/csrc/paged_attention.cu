// Paged decode attention for Hopper (sm_90a), written by hand.
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
// What bounds it: decode attention does ~2 flops per byte of K/V, far below
// the ~295 flop/byte ridge of an H100, so the only cost that matters is the
// K/V bytes read. The kernel therefore reads each valid key exactly once and
// never touches keys at or past lengths[b] (nor the table entries of pages
// past the end), and keeps the whole GQA group of q heads of one KV head in
// the same block, so a K/V row fetched once serves every head of the group.
//
// Design (a correct, simple first version; wgmma, TMA and split-K are later
// work):
//   * one block per (row b, KV head, chunk of <= kMaxGroup q heads);
//   * kWarps warps split the keys round-robin; a lane holds hd/32 contiguous
//     elements of q, K, V and of its accumulator, the q.k dot is a warp
//     shuffle reduction;
//   * each warp keeps its own online softmax (m, l, acc) in f32, and the
//     warps merge through shared memory at the end;
//   * a row with lengths[b] == 0 writes 0, as the Pallas kernel does
//     (acc / max(l, 1e-30) with acc == l == 0).
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxGroup = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N elements of T moved as one aligned access (N * sizeof(T) <= 16 bytes).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Elements per access: as many as fit 16 bytes, at most N.
template <typename T, int N>
__host__ __device__ constexpr int chunk_of() {
  return (16 / (int)sizeof(T)) < N ? (16 / (int)sizeof(T)) : N;
}

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int C = chunk_of<T, N>();
#pragma unroll
  for (int c = 0; c < N; c += C) {
    const Pack<T, C> pk = *reinterpret_cast<const Pack<T, C>*>(p + c);
#pragma unroll
    for (int e = 0; e < C; ++e) out[c + e] = to_f32(pk.v[e]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ out, int H, int KV,
                       int page, int max_pages, float softcap, float sm_scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // elements per lane
  __shared__ float sm_m[kWarps][kMaxGroup];
  __shared__ float sm_l[kWarps][kMaxGroup];
  __shared__ float sm_acc[kWarps][kMaxGroup][HD];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = H / KV;
  const int g0 = blockIdx.z * kMaxGroup;
  const int ng = min(kMaxGroup, group - g0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * EPL;
  const bool lane_on = d0 < HD;  // false only for lanes past hd when hd < 32
  const int len = lengths[b];
  const int64_t head0 = (int64_t)b * H + (int64_t)kvh * group + g0;

  float qr[kMaxGroup][EPL];
  float acc[kMaxGroup][EPL];
  float m[kMaxGroup], l[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = 0.f;
      acc[g][e] = 0.f;
    }
    if (g < ng && lane_on) {
      load_f32<T, EPL>(q + (head0 + g) * HD + d0, qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= sm_scale;
    }
  }

  const int64_t row_stride = (int64_t)KV * HD;  // between tokens of a page
  const int64_t page_stride = (int64_t)page * row_stride;
  const int* table = page_table + (int64_t)b * max_pages;
  for (int t = warp; t < len; t += kWarps) {
    const int pi = t / page;
    const int64_t pid = table[pi];
    const int64_t off = pid * page_stride + (int64_t)(t - pi * page) * row_stride +
                        (int64_t)kvh * HD + d0;
    float kr[EPL], vr[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) kr[e] = vr[e] = 0.f;
    if (lane_on) {
      load_f32<T, EPL>(k_pages + off, kr);
      load_f32<T, EPL>(v_pages + off, vr);
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < ng) {  // warp-uniform
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s = fmaf(qr[g][e], kr[e], s);
        s = warp_sum(s);
        if (softcap != 0.f) s = softcap * tanhf(s / softcap);
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(acc[g][e], corr, p * vr[e]);
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < ng) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += blockDim.x) {
    const int g = i / HD;
    const int d = i - g * HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum = fmaf(sm_l[w][g], c, lsum);
      o = fmaf(sm_acc[w][g][d], c, o);
    }
    out[(head0 + g) * HD + d] = from_f32<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* table, const int* lengths,
           void* out, int B, int H, int KV, int page, int max_pages, float softcap,
           float sm_scale, cudaStream_t stream) {
  const int group = H / KV;
  const dim3 grid(B, KV, (group + kMaxGroup - 1) / kMaxGroup);
  paged_attention_kernel<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), table,
      lengths, static_cast<T*>(out), H, KV, page, max_pages, softcap, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* table,
                const int* lengths, void* out, int B, int H, int KV, int page, int max_pages,
                float softcap, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, table, lengths, out, B, H, KV, page, max_pages, softcap, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, table, lengths, out, B, H, KV, page, max_pages, softcap, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, table, lengths, out, B, H, KV, page, max_pages, softcap, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, table, lengths, out, B, H, KV, page, max_pages, softcap, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller has checked shapes, types, devices and contiguity.
int repro_paged_attention(int dtype, const void* q, const void* k_pages, const void* v_pages,
                          const int* page_table, const int* lengths, void* out, int B, int H,
                          int KV, int hd, int page, int max_pages, float softcap,
                          float sm_scale, void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || page <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k_pages, v_pages, page_table, lengths, out, B, H, KV, page,
                              max_pages, softcap, sm_scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, page_table, lengths, out, B, H,
                                      KV, page, max_pages, softcap, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
