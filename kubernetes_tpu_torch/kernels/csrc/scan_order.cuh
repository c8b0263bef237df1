// Truncated (parity) mode's scan order on the card: the rotated position of
// a node row and a block-wide rank selection over a bitmap of positions,
// shared by truncate.cu and select_host.cu's pos mode.
//
// order_pos gives every node row a distinct place in [0, nvalid)
// (cache.py order_pos, the zone-interleaved node list), so the rotated
// positions (order_pos - start) mod nvalid of the node rows are a
// permutation of [0, nvalid).  "The k-th smallest position of a row set"
// is then "the k-th set bit of the set's bitmap over positions": one bit a
// node, 1 KB at 8192 nodes, kept in shared memory.  The JAX pass sorts the
// positions instead (engine/pass_.py:510-532, :154-159).
#pragma once

#include "common.cuh"

// A row's scan position off the node rows (cache.py NO_POS).
constexpr int kNoPos = 1 << 30;

// Floor modulo of int32, as jnp's `%` computes it; C's `%` truncates
// toward zero and goes negative with a negative dividend.
__device__ __forceinline__ int floormod_i32(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// numFeasibleNodesToFind (schedule_one.go:676-702, pass_.py:423-431):
// ``pct`` when non-zero, else the adaptive 50 - nodes/125 percent floored
// at 5; at least 100 nodes; every node below 100.  int32 products, as JAX.
__device__ __forceinline__ int num_to_find(int nvalid, int pct) {
  const int percentage = pct ? pct : max(50 - nvalid / 125, 5);
  const int num = max(nvalid * percentage / 100, 100);
  return nvalid < 100 ? nvalid : num;
}

// Block-wide: the positions of the set bits of ranks r0 and r1 (0-based,
// in increasing position order) of a bitmap of ``words`` 32-bit words,
// into out[0] and out[1] (-1 where fewer bits are set); returns the number
// of set bits.  Every thread of the block calls it; blockDim.x is a
// multiple of 32, at most 1024.  ``scratch`` holds 33 ints and ``out`` 2,
// both in shared memory.  Each thread counts a contiguous run of words;
// an exclusive scan of those counts (warp shuffles, then the warp totals)
// tells the one thread whose run holds a rank, which walks its words and
// the bits of the word that holds it.
__device__ int bitmap_select2(const unsigned int* bits, int words, int r0, int r1, int* scratch,
                              int* out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (words + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, words);
  const int hi = min(lo + per, words);
  int cnt = 0;
  for (int w = lo; w < hi; ++w) cnt += __popc(bits[w]);
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) scratch[warp] = incl;
  if (tid == 0) {
    out[0] = -1;
    out[1] = -1;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int t = scratch[w];
      scratch[w] = run;
      run += t;
    }
    scratch[32] = run;
  }
  __syncthreads();
  const int excl = scratch[warp] + incl - cnt;
  const int ranks[2] = {r0, r1};
  for (int k = 0; k < 2; ++k) {
    const int r = ranks[k];
    if (r < excl || r >= excl + cnt) continue;
    int before = excl;
    for (int w = lo; w < hi; ++w) {
      unsigned int v = bits[w];
      const int c = __popc(v);
      if (r < before + c) {
        for (int i = before; i < r; ++i) v &= v - 1u;  // drop the lower set bits
        out[k] = w * 32 + __ffs(v) - 1;
        break;
      }
      before += c;
    }
  }
  const int total = scratch[32];
  __syncthreads();
  return total;
}
