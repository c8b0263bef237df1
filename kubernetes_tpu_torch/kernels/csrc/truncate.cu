// truncate_feasible: truncated (parity) mode's search cut for one pod.
//
// Replaces kubernetes_tpu/engine/pass_.py:408-432 (_num_to_find), :510-532
// (the rotated positions, the sort-based cutoff and processedNodes) and
// :564-569 (the start carried from step to step): the reference's
// findNodesThatPassFilters stops at numFeasibleNodesToFind feasible nodes,
// scanning the zone-interleaved node list (node_tree.go:119) from where the
// last cycle stopped (schedule_one.go:628, :519).
//
// One block of 1024 threads (truncated mode runs chunk 1, so one pod a
// step).  Pass 1 counts the node rows.  Pass 2 writes each row's rotated
// position pos = (order_pos - start) mod nvalid (floor modulo; kNoPos off
// the node rows) and sets the pod's feasible positions in a bitmap in
// shared memory.  Positions are distinct (scan_order.cuh), so the
// limit-th smallest feasible position, the cutoff, is the set bit of rank
// limit-1, and processedNodes, the position of the (limit+1)-th feasible
// node whose check trips the cancel, is the bit of rank limit
// (bitmap_select2); with no more than limit feasible rows processed is
// nvalid and nothing is cut.  Pass 3 clears feasible past the cutoff.
// Last, after a block barrier, thread 0 writes processed (0 for a padding
// lane) and, for a real pod, advances the start by processed modulo
// nvalid.  The start lives in an int64 slot on the card and is computed in
// uint32, as the JAX pass carries it; every value stays below nvalid.  The
// host reads it never: it adds the batch's processed counts itself.
//
// Preconditions (what the pass gives it): feasible only on node rows, and
// order_pos a permutation of [0, nvalid) over the node rows.
//
// Bound: bytes.  It reads feasible, valid and order_pos and writes feasible
// and pos: about 11 bytes a row, 0.00003 ms at N = 8192 over 3.35 TB/s, so
// the launch itself is the cost.
#include <stdint.h>

#include "scan_order.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void truncate_kernel(unsigned char* __restrict__ feasible,
                                const unsigned char* __restrict__ valid,
                                const int* __restrict__ order_pos,
                                long long* __restrict__ start,
                                const unsigned char* __restrict__ pod_valid,
                                int N, int pct, int* __restrict__ pos_out,
                                int* __restrict__ processed_out) {
  extern __shared__ unsigned int bits[];
  __shared__ int scratch[33];
  __shared__ int sel[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int words = (N + 31) >> 5;
  const unsigned int s0 = (unsigned int)start[0];

  // Pass 1: the node rows; zero the bitmap meanwhile.
  int lv = 0;
  for (int n = tid; n < N; n += kThreads) lv += valid[n] != 0;
  for (int w = tid; w < words; w += kThreads) bits[w] = 0u;
  for (int off = 16; off > 0; off >>= 1) lv += __shfl_down_sync(0xffffffffu, lv, off);
  if (lane == 0) scratch[tid >> 5] = lv;
  __syncthreads();
  int nvalid = 0;
  for (int w = 0; w < kThreads / 32; ++w) nvalid += scratch[w];
  const int nv = max(nvalid, 1);
  const int limit = num_to_find(nvalid, pct);
  const int st = (int)s0;
  __syncthreads();

  // Pass 2: rotated positions; the feasible ones into the bitmap.
  for (int n = tid; n < N; n += kThreads) {
    int p = kNoPos;
    if (valid[n]) {
      p = floormod_i32(order_pos[n] - st, nv);
      if (feasible[n]) atomicOr(bits + (p >> 5), 1u << (p & 31));
    }
    pos_out[n] = p;
  }
  __syncthreads();

  const int total = bitmap_select2(bits, words, limit - 1, limit, scratch, sel);
  const bool over = total > limit;
  const int cutoff = sel[0];
  const int processed = over ? sel[1] : nvalid;

  // Pass 3: the cut (each thread rereads the positions it wrote).
  if (over) {
    for (int n = tid; n < N; n += kThreads) {
      if (feasible[n] && pos_out[n] > cutoff) feasible[n] = 0;
    }
  }
  if (tid == 0) {
    const bool real = pod_valid[0] != 0;
    processed_out[0] = real ? processed : 0;
    if (real) start[0] = (long long)((s0 + (unsigned int)processed) % (unsigned int)nv);
  }
}

}  // namespace

extern "C" int truncate_feasible_launch(void* feasible, const void* valid,
                                        const void* order_pos, void* start,
                                        const void* pod_valid, int N, int pct,
                                        void* pos, void* processed,
                                        void* stream) {
  const int smem = ((N + 31) >> 5) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        truncate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  truncate_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(feasible),
      static_cast<const unsigned char*>(valid),
      static_cast<const int*>(order_pos), static_cast<long long*>(start),
      static_cast<const unsigned char*>(pod_valid), N, pct,
      static_cast<int*>(pos), static_cast<int*>(processed));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(truncate)
