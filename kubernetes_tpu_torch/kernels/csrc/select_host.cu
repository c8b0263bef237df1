// select_host: pick one node per pod from its feasible mask and total score.
//
// Replaces kubernetes_tpu/engine/pass_.py:122-163 (_hash_u32 + select_host,
// the selectHost of schedule_one.go:873) and the nominated-node fast path
// of eval_pod (:548-553).  Per pod: the masked int64 maximum over N, the
// tie count m, kth = hash(seed_mul + step) % max(m, 1) in uint32, and the
// (kth+1)-th tie in row order; -1 when no node is feasible.  A pod whose
// nominated row is feasible takes it, with that row's total as its score.
//
// One block per pod.  Pass 1 is a strided, coalesced walk that reduces
// (max, tie count, feasible count) per thread, then per warp with shuffles
// and across warps in shared memory.  Pass 2 walks the row tiles in order:
// each tile's ties are ranked with a warp ballot plus an exclusive scan of
// the warp counts, so the (kth+1)-th tie is found without sorting; the
// walk stops at the tile that holds it.
//
// Pos mode (truncated mode, pass_.py:154-159): with ``pos``, each row's
// place in the rotated scan order (truncate.cu), the (kth+1)-th tie is
// counted in that order instead, as the reference's feasible list is
// built in scan order.  JAX sorts the ties' positions; here pass 2 sets
// the ties' positions in a bitmap in dynamic shared memory (one bit a
// position, distinct over the node rows: scan_order.cuh), takes the set
// bit of rank kth (bitmap_select2) and a last walk finds the row holding
// that position.
//
// Bound: bytes.  It reads the chunk's feasible mask and totals once
// (C*N*9 bytes, ~4.7 MB at C=64, N=8192) and writes 16 bytes per pod.
#include <stdint.h>

#include "scan_order.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr long long kNeg = -(1LL << 62);

__device__ __forceinline__ unsigned int hash_u32(unsigned int x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x;
}

__global__ void select_host_kernel(const unsigned char* __restrict__ feasible,
                                   const long long* __restrict__ total,
                                   const long long* __restrict__ steps,
                                   unsigned int seed_mul,
                                   const int* __restrict__ nominated_row, int N,
                                   const int* __restrict__ pos,
                                   int* pick_out, long long* best_out,
                                   int* feas_out) {
  extern __shared__ unsigned int bits[];  // pos mode: the ties' positions
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned char* fe = feasible + (size_t)c * N;
  const long long* to = total + (size_t)c * N;

  __shared__ long long s_max[kWarps];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_feas[kWarps];
  __shared__ long long s_best;
  __shared__ int s_m;
  __shared__ int s_kth;
  __shared__ int s_pick;

  // Pass 1: masked max, ties at the max, feasible count.
  long long lmax = kNeg;
  int lcnt = 0;
  int lfeas = 0;
  for (int n = tid; n < N; n += kThreads) {
    if (fe[n]) {
      const long long v = to[n];
      ++lfeas;
      if (v > lmax) {
        lmax = v;
        lcnt = 1;
      } else if (v == lmax) {
        ++lcnt;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const long long om = __shfl_down_sync(0xffffffffu, lmax, off);
    const int oc = __shfl_down_sync(0xffffffffu, lcnt, off);
    const int of = __shfl_down_sync(0xffffffffu, lfeas, off);
    if (om > lmax) {
      lmax = om;
      lcnt = oc;
    } else if (om == lmax) {
      lcnt += oc;
    }
    lfeas += of;
  }
  if (lane == 0) {
    s_max[warp] = lmax;
    s_cnt[warp] = lcnt;
    s_feas[warp] = lfeas;
  }
  __syncthreads();
  if (tid == 0) {
    long long best = kNeg;
    int m = 0, feas = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (s_max[w] > best) {
        best = s_max[w];
        m = s_cnt[w];
      } else if (s_max[w] == best) {
        m += s_cnt[w];
      }
      feas += s_feas[w];
    }
    const unsigned int tie_rand = hash_u32(seed_mul + (unsigned int)steps[c]);
    s_best = best;
    s_m = m;
    s_kth = (int)(tie_rand % (unsigned int)(m > 0 ? m : 1));
    s_pick = -1;
    feas_out[c] = feas;
  }
  __syncthreads();
  const long long best = s_best;
  const int kth = s_kth;

  // Pass 2 in pos mode: the (kth+1)-th tie in rotated scan order.
  if (s_m > 0 && pos != nullptr) {
    __shared__ int scratch[33];
    __shared__ int sel[2];
    const int words = (N + 31) >> 5;
    for (int w = tid; w < words; w += kThreads) bits[w] = 0u;
    __syncthreads();
    for (int n = tid; n < N; n += kThreads) {
      if (fe[n] && to[n] == best) {
        const int p = pos[n];
        atomicOr(bits + (p >> 5), 1u << (p & 31));
      }
    }
    __syncthreads();
    bitmap_select2(bits, words, kth, -1, scratch, sel);
    const int thr = sel[0];
    for (int n = tid; n < N; n += kThreads) {
      if (fe[n] && to[n] == best && pos[n] == thr) s_pick = n;
    }
    __syncthreads();
  }
  // Pass 2: the (kth+1)-th tie in row order.
  if (s_m > 0 && pos == nullptr) {
    int running = 0;  // ties in the tiles before this one (block-uniform)
    for (int base = 0; base < N; base += kThreads) {
      const int n = base + tid;
      const bool tie = n < N && fe[n] && to[n] == best;
      const unsigned int ballot = __ballot_sync(0xffffffffu, tie);
      if (lane == 0) s_cnt[warp] = __popc(ballot);
      __syncthreads();
      int before = running;
      int tile = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += s_cnt[w];
        tile += s_cnt[w];
      }
      before += __popc(ballot & ((1u << lane) - 1u));
      if (tie && before == kth) s_pick = n;
      __syncthreads();
      if (s_pick >= 0) break;
      running += tile;
    }
  }
  if (tid == 0) {
    int pick = s_m > 0 ? s_pick : -1;
    long long b = best;
    if (nominated_row != nullptr) {
      const int nom = nominated_row[c];
      if (nom >= 0 && fe[nom]) {
        pick = nom;
        b = to[nom];
      }
    }
    pick_out[c] = pick;
    best_out[c] = b;
  }
}

}  // namespace

extern "C" int select_host_launch(const void* feasible, const void* total,
                                  const void* steps, unsigned int seed_mul,
                                  const void* nominated_row, int C, int N,
                                  const void* pos, void* pick, void* best,
                                  void* feas, void* stream) {
  const int smem = pos != nullptr ? ((N + 31) >> 5) * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_host_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  select_host_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(feasible),
      static_cast<const long long*>(total),
      static_cast<const long long*>(steps), seed_mul,
      static_cast<const int*>(nominated_row), N, static_cast<const int*>(pos),
      static_cast<int*>(pick),
      static_cast<long long*>(best), static_cast<int*>(feas));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(select_host)
