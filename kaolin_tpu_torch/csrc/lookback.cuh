// Single-pass prefix sums across thread blocks by decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), shared by csrc/grid_sample.cu (the texel tiles' list
// offsets) and csrc/spc_traverse.cu (each level's output offsets).
//
// Each tile of work has one 64-bit status word, zeroed before the launch:
// bits 62-63 hold a flag (0: nothing yet, 1: the tile's own aggregate,
// 2: its inclusive prefix), bits 0-61 an additive payload. Tiles are
// taken in ticket order (an atomic counter, not blockIdx), so a tile only
// waits for tiles that running blocks already hold. A payload may pack
// two counts, as long as neither field overflows into the next.

#pragma once

#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned long long FLAG_AGGREGATE = 1ull << 62;
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;
constexpr unsigned long long PAYLOAD = FLAG_AGGREGATE - 1;

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* s) {
  return *(const volatile unsigned long long*)s;
}

__device__ __forceinline__ void publish(unsigned long long* s,
                                        unsigned long long v) {
  *(volatile unsigned long long*)s = v;
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum. s_warp holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();   // s_warp may still be read from a previous call
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[nwarps - 1];
  return (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
}

// The next tile of the launch, for every thread of the block. slot is a
// shared int; the caller syncs the block before slot is written again.
__device__ __forceinline__ int take_ticket(int* ticket, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(ticket, 1);
  __syncthreads();
  return *slot;
}

// Called by one whole warp for tile `tile` with the tile's aggregate
// payload: publishes it, sums the predecessors' payloads back to the
// nearest inclusive prefix, 32 tiles at a time, publishes the tile's
// inclusive prefix and returns the exclusive one in every lane.
__device__ __forceinline__ unsigned long long exclusive_prefix(
    unsigned long long* status, int tile, unsigned long long aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) publish(status, FLAG_PREFIX | aggregate);
    return 0;
  }
  if (lane == 0) publish(status + tile, FLAG_AGGREGATE | aggregate);
  unsigned long long excl = 0;
  for (int base = tile - 1;; base -= 32) {
    const int t = base - lane;
    unsigned long long s;
    do {
      // before tile 0: an inclusive prefix of 0
      s = t >= 0 ? peek(status + t) : FLAG_PREFIX;
    } while (__any_sync(0xffffffffu, (s >> 62) == 0));
    const unsigned prefix = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    // the lanes up to the nearest prefix (or all 32) contribute
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & PAYLOAD) : 0;
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (prefix) break;
  }
  if (lane == 0) publish(status + tile, FLAG_PREFIX | (excl + aggregate));
  return excl;
}

// The inclusive prefix of `tile` once it is published (spins until then).
__device__ __forceinline__ unsigned long long wait_prefix(
    const unsigned long long* status, int tile) {
  unsigned long long s;
  do {
    s = peek(status + tile);
  } while ((s >> 62) != 2);
  return s & PAYLOAD;
}

}  // namespace lookback
