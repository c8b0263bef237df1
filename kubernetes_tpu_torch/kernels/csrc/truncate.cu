// truncate_feasible: truncated (parity) mode's search cut for one pod.
//
// Replaces kubernetes_tpu/engine/pass_.py:408-432 (_num_to_find), :510-532
// (the rotated positions, the sort-based cutoff and processedNodes) and
// :564-569 (the start carried from step to step): the reference's
// findNodesThatPassFilters stops at numFeasibleNodesToFind feasible nodes,
// scanning the zone-interleaved node list (node_tree.go:119) from where the
// last cycle stopped (schedule_one.go:628, :519).
//
// One block (truncated mode runs chunk 1, so one pod a step).  The node
// count and numFeasibleNodesToFind are constants of a pass: the host hands
// them to every launch (kernels.scan_counts), so nothing counts the node
// rows here.  Thread t owns R consecutive rows (kernels.trunc_shape: R of
// 4-32, at most 1024 threads) and loads them in one round: valid and
// feasible as bytes and order_pos as int4 vectors.  It keeps each row's
// rotated position pos = (order_pos - start) mod nvalid (floor modulo;
// kNoPos off the node rows) and its feasible bit in registers through the
// cut, so the cut reads nothing back from memory.  Positions are distinct
// (scan_order.cuh), so the limit-th smallest feasible position, the
// cutoff, is the set bit of rank limit-1 of a bitmap over positions, and
// processedNodes, the position of the (limit+1)-th feasible node whose
// check trips the cancel, is the next set bit; with no more than limit
// feasible rows processed is nvalid and nothing is cut.  Each row's
// feasible flag goes to its position in shared memory (a permutation: no
// zeroing, no atomics); each warp then ballots its slice of the flags into
// the bitmap's words and publishes its count; after that barrier every
// warp finds the cutoff by itself (a scan of the warp counts, then of the
// owning warp's words, then the bit) and the next set bit, so no result
// is broadcast through a further barrier.  Two barriers in all.
// Thread 0 writes processed (0 for a padding lane) and, for a real pod,
// advances the start by processed modulo nvalid.  The start lives in an
// int64 slot on the card and is computed in uint32, as the JAX pass
// carries it; every value stays below nvalid.  The host reads it never:
// it adds the batch's processed counts itself.
//
// Preconditions (what the pass gives it): feasible only on node rows,
// order_pos a permutation of [0, nvalid) over the node rows, nvalid the
// number of node rows, 0 <= start < max(nvalid, 1).
//
// Bound: bytes.  It reads feasible, valid and order_pos and writes feasible
// and pos: about 11 bytes a row, 0.00003 ms at N = 8192 over 3.35 TB/s, so
// the launch itself is the cost.
#include <stdint.h>

#include "scan_order.cuh"

namespace {

constexpr unsigned int kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

// R bytes from p (16-byte aligned when kVec) into R / 4 words.
template <int R, bool kVec>
__device__ __forceinline__ void load_bytes(const unsigned char* p, unsigned int (&w)[R / 4]) {
  if constexpr (kVec && R == 4) {
    w[0] = *reinterpret_cast<const unsigned int*>(p);
  } else if constexpr (kVec && R == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < R / 16; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      w[k] = p[4 * k] | (p[4 * k + 1] << 8) | (p[4 * k + 2] << 16) | ((unsigned int)p[4 * k + 3] << 24);
    }
  }
}

// The position of the set bit of rank k (0-based) in v, which has more
// than k set bits: halves chosen by their popcounts, five steps.
__device__ __forceinline__ int nth_set(unsigned int v, int k) {
  int at = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(v & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      v >>= w;
      at += w;
    }
  }
  return at;
}

// The position of the set bit of rank r (0-based) in the bitmap, found by
// every warp on its own: ``totals`` holds each warp's count of set bits
// over its ``per`` words.  -1 where fewer bits are set.
__device__ __forceinline__ int select_rank(const unsigned int* bits, const int* totals, int nwarps, int per,
                                           int words, int r) {
  const int lane = threadIdx.x & 31;
  int cnt = lane < nwarps ? totals[lane] : 0;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  const unsigned int own = __ballot_sync(kFull, r >= incl - cnt && r < incl);
  if (r < 0 || own == 0) return -1;
  const int w = __ffs(own) - 1;
  const int before = __shfl_sync(kFull, incl - cnt, w);
  const int word = w * per + lane;
  const unsigned int v0 = lane < per && word < words ? bits[word] : 0u;
  cnt = __popc(v0);
  incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  const int k = r - before;
  const unsigned int hit = __ballot_sync(kFull, k >= incl - cnt && k < incl);
  int at = -1;
  if (k >= incl - cnt && k < incl) at = word * 32 + nth_set(v0, k - (incl - cnt));
  return __shfl_sync(kFull, at, __ffs(hit) - 1);
}

// The position of the first set bit after position c (which the caller
// knows exists), found by every warp on its own: the rest of c's word,
// then 32 words at a time by a ballot.
__device__ __forceinline__ int next_set(const unsigned int* bits, int words, int c) {
  const int w = c >> 5;
  const int b = c & 31;
  const unsigned int rest = b == 31 ? 0u : bits[w] & (~0u << (b + 1));
  if (rest != 0) return w * 32 + __ffs(rest) - 1;
  const int lane = threadIdx.x & 31;
  for (int base = w + 1; base < words; base += 32) {
    const unsigned int v = base + lane < words ? bits[base + lane] : 0u;
    const unsigned int nz = __ballot_sync(kFull, v != 0);
    if (nz != 0) {
      const int l = __ffs(nz) - 1;
      return (base + l) * 32 + __ffs(__shfl_sync(kFull, v, l)) - 1;
    }
  }
  return -1;
}

template <int R, bool kVec>
__global__ void __launch_bounds__(1024) truncate_kernel(
    unsigned char* __restrict__ feasible, const unsigned char* __restrict__ valid,
    const int* __restrict__ order_pos, long long* __restrict__ start,
    const unsigned char* __restrict__ pod_valid, int N, int nvalid, int limit,
    int* __restrict__ pos_out, int* __restrict__ processed_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* flags = smem;                                          // (N,) by position
  unsigned int* bits = reinterpret_cast<unsigned int*>(smem + ((N + 15) & ~15));  // (words,)
  __shared__ int totals[kMaxWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int words = (N + 31) >> 5;
  const int r0 = t * R;
  const bool whole = kVec && r0 + R <= N;

  // One round of loads: the start, this thread's rows.
  const unsigned int s0 = (unsigned int)start[0];
  const bool real = pod_valid[0] != 0;
  int p[R];
  unsigned int vw[R / 4], fw[R / 4];
  if (whole) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const int4 v = reinterpret_cast<const int4*>(order_pos + r0)[k];
      p[4 * k] = v.x;
      p[4 * k + 1] = v.y;
      p[4 * k + 2] = v.z;
      p[4 * k + 3] = v.w;
    }
    load_bytes<R, true>(valid + r0, vw);
    load_bytes<R, true>(feasible + r0, fw);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool in = r0 + i < N;
      p[i] = in ? order_pos[r0 + i] : 0;
      if (i % 4 == 0) vw[i / 4] = fw[i / 4] = 0u;
      vw[i / 4] |= (in && valid[r0 + i] ? 1u : 0u) << (8 * (i % 4));
      fw[i / 4] |= (in && feasible[r0 + i] ? 1u : 0u) << (8 * (i % 4));
    }
  }
  // Rotated positions; each node row's feasible flag at its position
  // (positions are a permutation of [0, nvalid): every flag below nvalid
  // is written once, so nothing is zeroed first).
  const int nv = max(nvalid, 1);
  const int st = (int)s0;
  unsigned int feas = 0;  // bit i: row r0 + i feasible
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool v = ((vw[i / 4] >> (8 * (i % 4))) & 0xffu) != 0;
    const bool f = ((fw[i / 4] >> (8 * (i % 4))) & 0xffu) != 0;
    p[i] = v ? floormod_i32(p[i] - st, nv) : kNoPos;
    if (v) flags[p[i]] = f;
    feas |= (v && f ? 1u : 0u) << i;
  }
  // pos does not wait for the cut: its stores go out now.
  if (whole) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      reinterpret_cast<int4*>(pos_out + r0)[k] = make_int4(p[4 * k], p[4 * k + 1], p[4 * k + 2], p[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (r0 + i < N) pos_out[r0 + i] = p[i];
    }
  }
  __syncthreads();

  // Each warp's slice of the bitmap over positions, a word a ballot of 32
  // flags, and its count.
  const int per = (words + nwarps - 1) / nwarps;  // at most R
  {
    bool f[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {  // every flag load in flight, then the ballots
      const int at = (warp * per + j) * 32 + lane;
      f[j] = j < per && at < nvalid && flags[at] != 0;
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int word = warp * per + j;
      const unsigned int b = __ballot_sync(kFull, f[j]);
      if (lane == 0 && j < per && word < words) bits[word] = b;
      cnt += __popc(b);
    }
    if (lane == 0) totals[warp] = cnt;
  }
  __syncthreads();

  const int total = (int)__reduce_add_sync(kFull, lane < nwarps ? totals[lane] : 0);
  const bool over = total > limit;
  int processed = nvalid;
  if (over) {  // processedNodes: the feasible position after the cutoff
    const int cutoff = select_rank(bits, totals, nwarps, per, words, limit - 1);
    processed = next_set(bits, words, cutoff);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (p[i] > cutoff) feas &= ~(1u << i);
    }
  }

  // The cut from registers: feasible, only where it changed.
  if (whole) {
    if (over) {
#pragma unroll
      for (int k = 0; k < R / 4; ++k) {
        fw[k] = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) fw[k] |= ((feas >> (4 * k + j)) & 1u) << (8 * j);
      }
      if constexpr (R == 4) {
        *reinterpret_cast<unsigned int*>(feasible + r0) = fw[0];
      } else if constexpr (R == 8) {
        *reinterpret_cast<uint2*>(feasible + r0) = make_uint2(fw[0], fw[1]);
      } else {
#pragma unroll
        for (int k = 0; k < R / 16; ++k) {
          reinterpret_cast<uint4*>(feasible + r0)[k] =
              make_uint4(fw[4 * k], fw[4 * k + 1], fw[4 * k + 2], fw[4 * k + 3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (over && r0 + i < N) feasible[r0 + i] = (feas >> i) & 1u;
    }
  }
  if (t == 0) {
    processed_out[0] = real ? processed : 0;
    if (real) start[0] = (long long)((s0 + (unsigned int)processed) % (unsigned int)nv);
  }
}

template <int R>
int launch_rows(bool vec, int threads, unsigned char* feasible, const unsigned char* valid, const int* order_pos,
                long long* start, const unsigned char* pod_valid, int N, int nvalid, int limit, int* pos,
                int* processed, cudaStream_t s) {
  const int smem = ((N + 15) & ~15) + ((N + 31) >> 5) * 4;  // the flags, the bitmap
  auto kernel = vec ? truncate_kernel<R, true> : truncate_kernel<R, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, threads, smem, s>>>(feasible, valid, order_pos, start, pod_valid, N, nvalid, limit, pos, processed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int truncate_feasible_launch(void* feasible, const void* valid,
                                        const void* order_pos, void* start,
                                        const void* pod_valid, int N, int nvalid, int limit,
                                        int threads, int rows, void* pos, void* processed,
                                        void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || (long long)threads * rows < N ||
      nvalid < 0 || nvalid > N) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = ((uintptr_t)feasible | (uintptr_t)valid | (uintptr_t)order_pos | (uintptr_t)pos) % 16 == 0;
  auto* f = static_cast<unsigned char*>(feasible);
  auto* v = static_cast<const unsigned char*>(valid);
  auto* o = static_cast<const int*>(order_pos);
  auto* st = static_cast<long long*>(start);
  auto* pv = static_cast<const unsigned char*>(pod_valid);
  auto* po = static_cast<int*>(pos);
  auto* pr = static_cast<int*>(processed);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 4: return launch_rows<4>(vec, threads, f, v, o, st, pv, N, nvalid, limit, po, pr, s);
    case 8: return launch_rows<8>(vec, threads, f, v, o, st, pv, N, nvalid, limit, po, pr, s);
    case 16: return launch_rows<16>(vec, threads, f, v, o, st, pv, N, nvalid, limit, po, pr, s);
    case 32: return launch_rows<32>(vec, threads, f, v, o, st, pv, N, nvalid, limit, po, pr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

KERNEL_ERROR_STRING(truncate)
