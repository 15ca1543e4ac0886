// GClock flush scores (paper section 3.3.1) for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flush_score.py
// (flush_scores, body _flush_score_kernel): for every page set of a
// set-associative cache, rank the slots by distance score and turn the rank
// into the flush score the dirty-page flusher orders its writes by.
//
//   hits   (ns, ss) int32   GClock hit counts
//   clock  (ns,)    int32   hand position of each set
//   valid  (ns, ss) bool    slot holds a page
//   out    (ns, ss) int32   ss - 1 - rank of (d, slot), -1 for an empty slot
//
// with d = hits * ss + (slot - clock) mod ss in int32 arithmetic that wraps
// (the mod non-negative, as Python's and jnp.mod), INT32_MAX for an empty
// slot, and rank = the number of slots of the set before this one in
// (d, slot) order, d compared as signed int32.
//
// What bounds it on this card: 9 bytes read and written per slot and 4 per
// set (14.7 MB at 131,072 sets x 12, 4.4 us at 3.35 TB/s), so the bytes,
// provided the instructions issued per set stay under them. A thread per
// slot (the slot design below) issues a runtime division and two runtime
// remainders per slot and ranks the whole set again in every slot.
//
// Two designs behind one entry point:
//
//   set   (1 <= ss <= 16) one thread per set, ss a template constant, so
//         the set's d values and scores live in registers, the clock is
//         read once per set, the mod by the constant ss is a multiply-high
//         and a fix-up (exact under the int32 wrap), and each unordered
//         pair of slots is compared once (66 compares at ss 12). When the
//         tensors are 16-byte aligned, each thread loads its set's row
//         straight into registers in 16-, 8- or 4-byte accesses as the
//         row's alignment allows; blocks of 128 threads, one wave of them
//         at 131,072 sets, keep enough loads in flight to stream the
//         bytes. Otherwise (a view such as hits[1:]) a block stages its
//         128 sets through shared memory with coalesced 4- and 1-byte
//         accesses. A persistent grid of 2 blocks per SM that brought
//         tiles of 128 sets into shared memory by bulk copy (cp.async.bulk
//         into a 3-stage mbarrier ring) measured slower than the direct
//         loads at 131,072 and 1,048,576 sets of 12 (PERF.md).
//   slot  (17 <= ss <= 256) one thread per (set, slot), a block of whole
//         sets; each thread writes its d to shared memory and counts the
//         slots of its set before it.
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds. It reads nothing from
// the device and allocates nothing, so a call can be captured in a graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 0x7fffffff;

// ---------------------------------------------------------------------------
// set: one thread per set
// ---------------------------------------------------------------------------

constexpr int kMaxSetSize = 16;   // set sizes 1..16 take the set design
constexpr int kSetThreads = 128;

// N consecutive 32-bit words at p, an address aligned to gcd(4 N, 16), in
// the widest accesses that allows.
template <int N>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[q];
      w[2 * q] = v.x, w[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) w[q] = reinterpret_cast<const uint32_t*>(p)[q];
  }
}

template <int N>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<uint4*>(p)[q] = make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2],
                                                  w[4 * q + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q)
      reinterpret_cast<uint2*>(p)[q] = make_uint2(w[2 * q], w[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) reinterpret_cast<uint32_t*>(p)[q] = w[q];
  }
}

// Bit k set when slot k of the row of SS valid bytes at p (aligned as the
// row of a 16-byte aligned tensor) is valid.
template <int SS>
__device__ __forceinline__ uint32_t load_valid(const uint8_t* p) {
  uint32_t bits = 0;
  if constexpr (SS % 4 == 0) {
    uint32_t w[SS / 4];
    load_words<SS / 4>(p, w);
#pragma unroll
    for (int k = 0; k < SS; ++k) bits |= (uint32_t)((w[k / 4] >> (8 * (k % 4)) & 0xff) != 0) << k;
  } else {
#pragma unroll
    for (int k = 0; k < SS; ++k) bits |= (uint32_t)(p[k] != 0) << k;
  }
  return bits;
}

// The scores of one set, in registers.
template <int SS>
__device__ __forceinline__ void score_set(const uint32_t (&hits)[SS], uint32_t valid, int clock,
                                          uint32_t (&out)[SS]) {
  int d[SS], score[SS];
#pragma unroll
  for (int k = 0; k < SS; ++k) {
    const int diff = (int)((uint32_t)k - (uint32_t)clock);     // wraps, as int32 in JAX
    int dist = diff % SS;                                      // by a constant: no division
    dist += dist < 0 ? SS : 0;                                 // non-negative, as jnp.mod
    d[k] = (valid >> k) & 1 ? (int)(hits[k] * (uint32_t)SS + (uint32_t)dist) : kBig;
    score[k] = k;
  }
  // Slot i comes before slot j > i exactly when d_i <= d_j, so ss - 1 - rank_k
  // = k + #{j > k : d_k <= d_j} - #{i < k : d_i <= d_k}: one compare per pair.
#pragma unroll
  for (int i = 0; i < SS; ++i) {
#pragma unroll
    for (int j = i + 1; j < SS; ++j) {
      const int before = d[i] <= d[j];
      score[i] += before;
      score[j] -= before;
    }
  }
#pragma unroll
  for (int k = 0; k < SS; ++k) out[k] = (valid >> k) & 1 ? (uint32_t)score[k] : ~0u;
}

// ALIGNED (hits, valid and out 16-byte aligned): each thread loads its
// set's row straight into registers and stores its scores from them.
// Otherwise the block stages its sets' rows through shared memory with
// coalesced word and byte accesses, which at ss 8 and 16 the threads then
// read with 2- and 4-way bank conflicts.
template <int SS, bool ALIGNED>
__global__ void __launch_bounds__(kSetThreads)
flush_set_kernel(const int* __restrict__ hits, const int* __restrict__ clock,
                 const uint8_t* __restrict__ valid, int* __restrict__ out, int ns) {
  const int tid = threadIdx.x;
  const int64_t set0 = (int64_t)blockIdx.x * kSetThreads;
  const int64_t set = set0 + tid;
  uint32_t h[SS], scores[SS];
  if constexpr (ALIGNED) {
    if (set >= ns) return;
    load_words<SS>(hits + set * SS, h);
    score_set<SS>(h, load_valid<SS>(valid + set * SS), clock[set], scores);
    store_words<SS>(out + set * SS, scores);
  } else {
    __shared__ __align__(16) uint32_t sw[kSetThreads * SS];    // hits, then scores
    __shared__ __align__(16) uint8_t sv[kSetThreads * SS];
    const int n = ns - set0 < kSetThreads ? (int)(ns - set0) : kSetThreads;
    for (int k = tid; k < n * SS; k += kSetThreads) {
      sw[k] = (uint32_t)hits[set0 * SS + k];
      sv[k] = valid[set0 * SS + k];
    }
    __syncthreads();
    if (tid < n) {
      load_words<SS>(sw + tid * SS, h);
      score_set<SS>(h, load_valid<SS>(sv + tid * SS), clock[set], scores);
      store_words<SS>(sw + tid * SS, scores);
    }
    __syncthreads();
    for (int k = tid; k < n * SS; k += kSetThreads) out[set0 * SS + k] = (int)sw[k];
  }
}

template <int SS>
int launch_set(const int* hits, const int* clock, const uint8_t* valid, int* out, int ns,
               cudaStream_t stream) {
  const int blocks = (int)(((int64_t)ns + kSetThreads - 1) / kSetThreads);
  if (((uintptr_t)hits | (uintptr_t)valid | (uintptr_t)out) % 16 == 0)
    flush_set_kernel<SS, true><<<blocks, kSetThreads, 0, stream>>>(hits, clock, valid, out, ns);
  else
    flush_set_kernel<SS, false><<<blocks, kSetThreads, 0, stream>>>(hits, clock, valid, out, ns);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// slot: one thread per (set, slot), for set sizes above kMaxSetSize
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
flush_slot_kernel(const int* __restrict__ hits, const int* __restrict__ clock,
                  const uint8_t* __restrict__ valid, int* __restrict__ out, int ns, int ss,
                  int sets_per_block) {
  __shared__ int sd[kMaxThreads];
  const int local = threadIdx.x;
  const int set_local = local / ss;
  const int slot = local - set_local * ss;
  const int64_t set = (int64_t)blockIdx.x * sets_per_block + set_local;
  const bool on = set < ns;
  const int64_t i = set * ss + slot;

  bool is_valid = false;
  int d = kBig;
  if (on) {
    is_valid = valid[i] != 0;
    // int32 arithmetic that wraps, as the TPU kernel's
    const int diff = (int)((uint32_t)slot - (uint32_t)clock[set]);
    const int dist = (diff % ss + ss) % ss;
    const int score = (int)((uint32_t)hits[i] * (uint32_t)ss + (uint32_t)dist);
    d = is_valid ? score : kBig;
  }
  sd[local] = d;
  __syncthreads();
  if (!on) return;

  const int* row = sd + set_local * ss;
  int rank = 0;
  for (int j = 0; j < ss; ++j) {
    const int dj = row[j];
    rank += (dj < d) | ((dj == d) & (j < slot));
  }
  out[i] = is_valid ? ss - 1 - rank : -1;
}

int launch_slot(const int* hits, const int* clock, const uint8_t* valid, int* out, int ns, int ss,
                cudaStream_t stream) {
  const int sets_per_block = kMaxThreads / ss;
  const int blocks = (int)(((int64_t)ns + sets_per_block - 1) / sets_per_block);
  flush_slot_kernel<<<blocks, sets_per_block * ss, 0, stream>>>(hits, clock, valid, out, ns, ss,
                                                                 sets_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Which design the entry point launches for this set size: 1 set, 0 slot.
int repro_flush_scores_design(int ss) { return ss >= 1 && ss <= kMaxSetSize ? 1 : 0; }

// Returns a cudaError_t (0 on success); the caller has checked shapes,
// types, devices and contiguity. 1 <= ss <= 256; any alignment.
int repro_flush_scores(const int* hits, const int* clock, const uint8_t* valid, int* out,
                       int ns, int ss, void* stream) {
  if (ns == 0) return 0;
  if (ss <= 0 || ss > kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ss) {
#define REPRO_SET_CASE(N) \
  case N:                 \
    return launch_set<N>(hits, clock, valid, out, ns, s);
    REPRO_SET_CASE(1) REPRO_SET_CASE(2) REPRO_SET_CASE(3) REPRO_SET_CASE(4)
    REPRO_SET_CASE(5) REPRO_SET_CASE(6) REPRO_SET_CASE(7) REPRO_SET_CASE(8)
    REPRO_SET_CASE(9) REPRO_SET_CASE(10) REPRO_SET_CASE(11) REPRO_SET_CASE(12)
    REPRO_SET_CASE(13) REPRO_SET_CASE(14) REPRO_SET_CASE(15) REPRO_SET_CASE(16)
#undef REPRO_SET_CASE
    default:
      return launch_slot(hits, clock, valid, out, ns, ss, s);
  }
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
