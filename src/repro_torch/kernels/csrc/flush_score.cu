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
// with d = hits * ss + (pos - clock) mod ss (the mod non-negative, as
// Python's and jnp.mod), INT32_MAX for an empty slot, and rank = the number
// of slots of the set before this one in (d, slot) order.
//
// What bounds it on this card: a few integer compares per slot pair, on
// 9 bytes read and written per slot: the bytes. At 131,072 sets x 12 (a
// serving pool at 10^5+ sets) that is ~14 MB, ~4 us at 3.35 TB/s.
//
// Design: one thread per (set, slot), a block holds whole sets (256 / ss of
// them), so no set straddles two blocks and nothing is padded: the Pallas
// kernel pads ss to 8 lanes, a TPU artefact. Each thread computes its d into
// shared memory; after one barrier it counts the slots of its set that come
// before it. Reads and writes are consecutive across threads.
//
// The host entry point has a plain C interface (loaded with ctypes), so the
// file needs no PyTorch headers and builds in seconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBig = 0x7fffffff;

__global__ void __launch_bounds__(kMaxThreads)
flush_score_kernel(const int* __restrict__ hits, const int* __restrict__ clock,
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

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); the caller has checked shapes,
// types, devices and contiguity. 1 <= ss <= 256.
int repro_flush_scores(const int* hits, const int* clock, const uint8_t* valid, int* out,
                       int ns, int ss, void* stream) {
  if (ns == 0) return 0;
  if (ss <= 0 || ss > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int sets_per_block = kMaxThreads / ss;
  const int blocks = (int)(((int64_t)ns + sets_per_block - 1) / sets_per_block);
  flush_score_kernel<<<blocks, sets_per_block * ss, 0, static_cast<cudaStream_t>(stream)>>>(
      hits, clock, valid, out, ns, ss, sets_per_block);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
