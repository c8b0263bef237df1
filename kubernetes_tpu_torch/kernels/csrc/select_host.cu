// select_host: pick one node per pod from its feasible mask and total score.
//
// Replaces kubernetes_tpu/engine/pass_.py:122-163 (_hash_u32 + select_host,
// the selectHost of schedule_one.go:873) and the nominated-node fast path
// of eval_pod (:548-553).  Per pod: the masked int64 maximum over N, the
// tie count m, kth = hash(seed_mul + step) % max(m, 1) in uint32, and the
// (kth+1)-th tie in row order; -1 when no node is feasible.  A pod whose
// nominated row is feasible takes it, with that row's total as its score.
//
// One pod over a thread block cluster of K CTAs (K from the host's
// cluster_split: more CTAs a pod where the chunk is small, so a chunk-1
// step runs on 16 SMs instead of one).  CTA r of a pod owns the contiguous
// row slice [r*S, (r+1)*S), S = ceil(N/K) rounded up to 32.
//   The step and the nominated row are read first, so their loads overlap
//   the slice's.  Pass 1 reads the slice once; each thread keeps its first
//   kRows rows' (feasible, total) in registers (rows beyond are read again
//   where needed) and reduces (max, ties at the max, feasible count) with
//   warp shuffles; every warp then folds the warps' triples itself.  Each
//   CTA publishes its triple in shared memory; after cluster.sync one warp
//   reads the K triples over distributed shared memory (one remote load a
//   CTA: their volume, not their latency, is what costs) and gives the
//   CTA the pod's best, m, the feasible count and its tie offset (the ties
//   at best in the ranks below it), hence kth.
//   Row mode: ties count in row order, and slices are in row order, so
//   only the CTA whose tie range holds kth searches, in its own slice,
//   from registers.  A slice of one row tile (at most 512 rows, one a
//   thread) ranks by the warps' pass-1 counts, with no barrier; a longer
//   one takes a warp ballot per tile, one warp's scan of the (tile, warp)
//   counts, then the warp that holds the rank.  (Contiguous rows a thread,
//   ranked by one scan of the threads' tie counts, measured faster at two
//   rows a thread and slower at sixteen, where the loads stop coalescing.)
//   Pos mode (truncated mode, pass_.py:154-159): with ``pos``, each row's
//   place in the rotated scan order (truncate.cu), ties count in that
//   order; it runs one CTA a pod (K = 1: at N=8192 and 16384 every split
//   measured slower, the cluster barriers costing more than the rows they
//   spread).  The CTA sets its ties' positions in an N-bit bitmap in
//   shared memory (positions are distinct over the node rows:
//   scan_order.cuh), takes the set bit of rank kth (bitmap_select2) and the
//   thread holding the tie at that position writes the pick.
//   K = 1 is a plain launch: no cluster barrier, no distributed shared
//   memory.
// No global atomics, no second launch.  A CTA does not exit while a peer
// may still read its shared memory: it arrives at a cluster barrier after
// its last remote read and waits on it before it exits.
//
// Bound: bytes.  It reads the chunk's feasible mask and totals once
// (C*N*9 bytes, ~4.7 MB at C=64, N=8192) and writes 16 bytes per pod; at
// small C the launch and the cluster barriers are most of its time.
#include <stdint.h>

#include <cooperative_groups.h>

#include "scan_order.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows a thread keeps in registers
constexpr int kPerLane = kRows * kWarps / 32;  // (tile, warp) counts a lane of warp 0 scans
static_assert(kRows * kWarps % 32 == 0, "the (tile, warp) counts split evenly over a warp");
constexpr long long kNeg = -(1LL << 62);

__device__ __forceinline__ unsigned int hash_u32(unsigned int x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x;
}

// (max, count at the max): fold in another pair.
__device__ __forceinline__ void merge_max(long long& mx, int& cnt, long long omx, int ocnt) {
  if (omx > mx) {
    mx = omx;
    cnt = ocnt;
  } else if (omx == mx) {
    cnt += ocnt;
  }
}

// (max, ties, feasible) over the warp, every lane gets the result.
__device__ __forceinline__ void warp_triple(long long& mx, int& cnt, int& feas) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long om = __shfl_xor_sync(0xffffffffu, mx, off);
    const int oc = __shfl_xor_sync(0xffffffffu, cnt, off);
    feas += __shfl_xor_sync(0xffffffffu, feas, off);
    merge_max(mx, cnt, om, oc);
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Arrive without ordering earlier memory operations: only to say that this
// CTA's reads of its peers' shared memory, whose values it has already used,
// are done.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Triple {
  long long best;
  int cnt;
  int feas;
};

__global__ void __launch_bounds__(kThreads)
select_host_kernel(const unsigned char* __restrict__ feasible, const long long* __restrict__ total,
                   const long long* __restrict__ steps, unsigned int seed_mul,
                   const int* __restrict__ nominated_row, int N, const int* __restrict__ pos,
                   int* pick_out, long long* best_out, int* feas_out) {
  // Pos mode: the bitmap of the pod's ties' positions.
  extern __shared__ unsigned int bits[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned char* fe = feasible + (size_t)c * N;
  const long long* to = total + (size_t)c * N;
  const int size = (((N + K - 1) / K + 31) / 32) * 32;
  const int lo = min(N, rank * size);
  const int hi = min(N, lo + size);
  const int words = (N + 31) >> 5;

  __shared__ long long s_wmax[kWarps];
  __shared__ int s_wcnt[kWarps];
  __shared__ int s_wfeas[kWarps];
  __shared__ Triple s_mine;  // this CTA's triple, read by the cluster
  __shared__ Triple s_pod;   // the pod's (best, ties, feasible count)
  __shared__ int s_off;      // ties at the pod's best in the CTAs below this one
  __shared__ int s_cnt[kRows * kWarps];
  __shared__ int s_sel[3];
  __shared__ int scratch[33];
  __shared__ int sel2[2];

  const unsigned int step = (unsigned int)steps[c];
  const int nom_row = nominated_row != nullptr ? nominated_row[c] : -1;
  if (pos != nullptr) {
    for (int w = tid; w < words; w += kThreads) bits[w] = 0u;
  }

  // Pass 1: masked max, ties at the max, feasible count over the slice.
  long long v[kRows];
  unsigned int fbits = 0;
  long long lmax = kNeg;
  int lcnt = 0;
  int lfeas = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int n = lo + tid + j * kThreads;
    const bool in = n < hi;
    const bool f = in && fe[n] != 0;
    v[j] = in ? to[n] : kNeg;
    if (f) {
      fbits |= 1u << j;
      ++lfeas;
      merge_max(lmax, lcnt, v[j], 1);
    }
  }
  for (int n = lo + tid + kRows * kThreads; n < hi; n += kThreads) {
    if (fe[n]) {
      ++lfeas;
      merge_max(lmax, lcnt, to[n], 1);
    }
  }
  // The nominated-node fast path's row (schedule_one.go:491-502).
  const int nom = nom_row >= 0 && fe[nom_row] ? nom_row : -1;
  warp_triple(lmax, lcnt, lfeas);
  if (lane == 0) {
    s_wmax[warp] = lmax;
    s_wcnt[warp] = lcnt;
    s_wfeas[warp] = lfeas;
  }
  __syncthreads();
  long long best = lane < kWarps ? s_wmax[lane] : kNeg;
  int m = lane < kWarps ? s_wcnt[lane] : 0;
  int feas = lane < kWarps ? s_wfeas[lane] : 0;
  warp_triple(best, m, feas);  // this CTA's triple, in every warp
  const Triple mine{best, m, feas};
  int off = 0;
  if (K > 1) {
    if (tid == 0) s_mine = mine;
    cluster.sync();
    if (warp == 0) {
      Triple t{kNeg, 0, 0};
      if (lane < K) t = *cluster.map_shared_rank(&s_mine, lane);
      long long b = t.best;
      int dummy = 0, f = t.feas;
      warp_triple(b, dummy, f);
      const bool at = lane < K && t.best == b;
      const int mm = warp_sum(at ? t.cnt : 0);
      const int o = warp_sum(at && lane < rank ? t.cnt : 0);
      if (lane == 0) {
        s_pod = Triple{b, mm, f};
        s_off = o;
      }
    }
    __syncthreads();
    best = s_pod.best;
    m = s_pod.cnt;
    feas = s_pod.feas;
    off = s_off;
    // The peers may leave once every CTA has read the triples.
    cluster_arrive();
  }
  const int kth = (int)(hash_u32(seed_mul + step) % (unsigned int)(m > 0 ? m : 1));
  if (rank == 0 && tid == 0) {
    feas_out[c] = feas;
    best_out[c] = nom >= 0 ? to[nom] : best;
    if (nom >= 0) {
      pick_out[c] = nom;
    } else if (m == 0) {
      pick_out[c] = -1;
    }
  }

  if (m > 0 && nom < 0 && pos == nullptr && mine.best == best && kth >= off && kth < off + mine.cnt) {
    // Row mode: the (kth - off)-th tie of this slice, in row order.
    int q = kth - off;
    if (hi - lo <= kThreads) {
      // One tile: warp w's ties are its pass-1 count at the best.
      const int wc = lane < kWarps && s_wmax[lane] == best ? s_wcnt[lane] : 0;
      int incl = wc;
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      const int mine_incl = __shfl_sync(0xffffffffu, incl, warp);
      const int mine_cnt = __shfl_sync(0xffffffffu, wc, warp);
      const int excl = mine_incl - mine_cnt;
      if (q >= excl && q < mine_incl) {
        const bool tie = (fbits & 1u) && v[0] == best;
        const unsigned int bal = __ballot_sync(0xffffffffu, tie);
        if (tie && __popc(bal & ((1u << lane) - 1u)) == q - excl) pick_out[c] = lo + tid;
      }
    } else {
      for (int g = 0;; ++g) {
        unsigned int tb = 0;  // tie bits of this thread's rows in tiles g*kRows + j
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int n = lo + tid + (g * kRows + j) * kThreads;
          bool tie;
          if (g == 0) {
            tie = ((fbits >> j) & 1u) && v[j] == best;
          } else {
            tie = n < hi && fe[n] && to[n] == best;
          }
          tb |= (unsigned int)tie << j;
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const unsigned int bal = __ballot_sync(0xffffffffu, (tb >> j) & 1u);
          if (lane == 0) s_cnt[j * kWarps + warp] = __popc(bal);
        }
        __syncthreads();
        if (warp == 0) {
          // Lane l scans entries kPerLane*l.. of the (tile, warp) counts, in row order.
          int e4[kPerLane], sum = 0;
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            e4[i] = s_cnt[lane * kPerLane + i];
            sum += e4[i];
          }
          int incl = sum;
          for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += x;
          }
          const int excl = incl - sum;
          const bool here = q >= excl && q < incl;
          int entry = -1, within = 0;
          if (here) {
            int before = excl;
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              if (entry < 0 && q < before + e4[i]) {
                entry = lane * kPerLane + i;
                within = q - before;
              }
              before += e4[i];
            }
          }
          const unsigned int hit = __ballot_sync(0xffffffffu, here);
          const int src = hit ? __ffs(hit) - 1 : 0;
          entry = __shfl_sync(0xffffffffu, entry, src);
          within = __shfl_sync(0xffffffffu, within, src);
          const int tot = __shfl_sync(0xffffffffu, incl, 31);
          if (lane == 0) {
            s_sel[0] = hit ? entry : -1;
            s_sel[1] = within;
            s_sel[2] = tot;
          }
        }
        __syncthreads();
        const int e = s_sel[0];
        if (e >= 0) {
          const int j = e / kWarps;
          if (warp == e % kWarps) {
            const bool tie = (tb >> j) & 1u;
            const unsigned int bal = __ballot_sync(0xffffffffu, tie);
            if (tie && __popc(bal & ((1u << lane) - 1u)) == s_sel[1]) {
              pick_out[c] = lo + tid + (g * kRows + j) * kThreads;
            }
          }
          break;
        }
        q -= s_sel[2];
        __syncthreads();  // s_cnt and s_sel are rewritten
      }
    }
  } else if (m > 0 && nom < 0 && pos != nullptr) {
    // Pos mode (one CTA a pod): this pod's ties' positions.
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int n = lo + tid + j * kThreads;
      if (((fbits >> j) & 1u) && v[j] == best) {
        const int p = pos[n];
        if (p >= 0 && p < N) atomicOr(bits + (p >> 5), 1u << (p & 31));
      }
    }
    for (int n = lo + tid + kRows * kThreads; n < hi; n += kThreads) {
      if (fe[n] && to[n] == best) {
        const int p = pos[n];
        if (p >= 0 && p < N) atomicOr(bits + (p >> 5), 1u << (p & 31));
      }
    }
    __syncthreads();
    bitmap_select2(bits, words, kth, -1, scratch, sel2);
    const int thr = sel2[0];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int n = lo + tid + j * kThreads;
      if (((fbits >> j) & 1u) && v[j] == best && pos[n] == thr) pick_out[c] = n;
    }
    for (int n = lo + tid + kRows * kThreads; n < hi; n += kThreads) {
      if (fe[n] && to[n] == best && pos[n] == thr) pick_out[c] = n;
    }
  }
  if (K > 1) cluster_wait();
}

int g_smem_set = 48 * 1024;  // dynamic shared memory the kernel may use (set once above 48 KB)
bool g_nonportable = false;

}  // namespace

extern "C" int select_host_launch(const void* feasible, const void* total,
                                  const void* steps, unsigned int seed_mul,
                                  const void* nominated_row, int C, int N,
                                  const void* pos, void* pick, void* best,
                                  void* feas, int K, void* stream) {
  if (K < 1 || K > 16 || (K & (K - 1)) != 0 || (pos != nullptr && K > 1)) return (int)cudaErrorInvalidValue;
  const int smem = pos != nullptr ? ((N + 31) >> 5) * 4 : 0;
  if (smem > g_smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_host_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_set = smem;
  }
  if (K > 8 && !g_nonportable) {
    const cudaError_t err =
        cudaFuncSetAttribute(select_host_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    g_nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, select_host_kernel, static_cast<const unsigned char*>(feasible),
      static_cast<const long long*>(total), static_cast<const long long*>(steps), seed_mul,
      static_cast<const int*>(nominated_row), N, static_cast<const int*>(pos),
      static_cast<int*>(pick), static_cast<long long*>(best), static_cast<int*>(feas));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(select_host)
