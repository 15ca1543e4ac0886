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
// Semantics, as _flash_kernel: s = (q * hd**-0.5) . k in f32; softcap
// (cap * tanh(s / cap)) before the mask; key kpos is valid for query qpos =
// row + q_offset iff kpos < Skv, kpos <= qpos (causal) and kpos > qpos -
// window (window > 0); masked scores are -1e30 and their p is set to 0 (so
// a tile with no valid key adds nothing even while m is still -1e30); out =
// acc / max(l, 1e-30), so a row with no valid key is 0.
//
// What bounds it on this card: prefill at S 4096, hd 128 does ~2 * S * hd
// flops per key row read, far above the ~295 flop/byte ridge, so the bound
// is arithmetic: the tensor cores' 989 TFLOP/s in bf16. This first version
// does its products with plain f32 FMAs on the CUDA cores (67 TFLOP/s at
// most), which is also what fp32 parity (2e-5) needs: no TF32, no tensor
// cores. wgmma, TMA and a producer warp are later work.
//
// Design (a correct, simple first version):
//   * one block of 256 threads per (tile of kBQ = 64 query rows, q head,
//     batch row); the heaviest causal tiles are launched first;
//   * the block walks its key tiles (kBKV = 64) itself, from the first tile
//     the window can reach to the last one causality allows: tiles that the
//     masks cover entirely are never read (the Pallas kernel computes them);
//   * q (pre-scaled, transposed), K (transposed) and V are staged in shared
//     memory as f32, so bf16 is converted once per element;
//   * thread (ty, tx) of a 16 x 16 grid owns score rows ty*4..+3 and columns
//     tx*4..+3, and output rows ty*4..+3, columns tx*DPT..+DPT-1; the 16
//     threads of one row group are half a warp, so row max and row sum are
//     4 shuffles; the online softmax (m, l, acc) stays in registers;
//   * keys at or past Skv are never read: their shared rows are 0 and masked.
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, int B, int Sq,
                int Skv, int H, int KV, int causal, int window, float softcap, int q_offset,
                float sm_scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, sm_scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, sm_scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, sm_scale, s);
    case 120: return launch<T, 120>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, sm_scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller has checked shapes, types, devices and contiguity.
int repro_flash_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                          int B, int Sq, int Skv, int H, int KV, int hd, int causal, int window,
                          float softcap, int q_offset, float sm_scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv < 0 || q_offset < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, Sq, Skv, H, KV, causal, window, softcap,
                              q_offset, sm_scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Skv, H, KV, causal, window,
                                      softcap, q_offset, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
