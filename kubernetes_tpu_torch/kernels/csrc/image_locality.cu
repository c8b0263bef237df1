// image_locality: ImageLocality's score plane of a whole batch.
//
// Replaces kubernetes_tpu/ops/imagelocality.py:53 score_fn (with the
// featurized ids of :38), which the JAX pass evaluates per pod inside every
// chunk step.  Images and node validity do not change within a pass, so the
// score of a pod on a node depends on no commit: two entry points per batch
// serve every chunk, the fused strict tail and the pinned pass.
//
//   image_counts  for each image id v < V, the number of valid nodes whose
//                 slots hold v (once per node: a slot counts only if no
//                 earlier slot of its row holds the same id), and in
//                 counts[V] the number of valid nodes.  One thread per
//                 (node, slot), atomics into the zeroed (V + 1,) counts.
//   image_scores  the raw score of every pod of the batch on every node,
//                 (K, N) uint8 in [0, 100]:
//                   sum over the pod's image ids q of
//                     int64(f64(size_q(n)) * (f64(counts[q]) / f64(max(total, 1))))
//                 where size_q(n) is the summed size of node n's slots that
//                 hold q (0 where none does), each product truncated before
//                 the sum; then clamped into [23 MiB, 1000 MiB x
//                 ncontainers] and mapped to 100 * (x - 23 MiB) // (max -
//                 23 MiB) (image_locality.go:84 calculatePriority); a
//                 padding lane (valid false) scores 0.  Two kernels:
//                   image_merge  one warp a node row: the row's (id, size)
//                                slots sorted by id in registers (a bitonic
//                                network over the warp, P = 32 E slots, E a
//                                lane), runs of one id summed (a segmented
//                                scan), and the distinct ids >= 0 written in
//                                order with their summed sizes and the
//                                list's length; entries past the length hold
//                                the sentinel 0xFFFFFFFF.  int64 sums are
//                                exact in any order.
//                   image_tile   one block a tile of 32 nodes (a warp's lanes)
//                                and a slice of the pods: the tile's lists
//                                staged in shared memory element-major (entry
//                                j of lane t at j * 32 + t, so a warp's 32
//                                lookups at any depths fall in 32 banks),
//                                then the pods in groups of 32, each pod's
//                                known ids and spreads computed once by eight
//                                threads into shared memory; a warp takes one
//                                pod and its 32 nodes, a wanted id a
//                                branchless binary search of log2(Pt) + 1
//                                shared reads (Pt the tile's longest list
//                                rounded up to a power of two).  A sum at or
//                                below 23 MiB maps to the pod's low score,
//                                computed once per pod.  The warp's 32 bytes
//                                of a plane row go out as one sector.
//                 Pinned mode (pin non-null; the pinned-batch pass): (K, 1),
//                 pod k on row pin[k] alone, with the spread taken over that
//                 one row as the JAX pass's one-row state slice takes it: 1
//                 where the row is valid and holds the image, else 0; one
//                 thread per pod (image_pinned).
//
// Bound: bytes.  image_counts reads the (N, IM) id table and writes V + 1
// counts.  image_scores must read the id table, the sizes only where an id
// matches, the pod ids and counts, and write K*N bytes.  The parent's one
// thread a pair rescanned its node's IM slots for every pod (K*N*IM cached
// loads, 26 ms at K=4096, N=8192, IM=128 on the H100); here a pair costs
// CI*(log2(Pt) + 1) shared-memory reads and the id table is read twice per
// tile (the merge, then the staging of each pod slice).
//
// Arithmetic follows the JAX package: f64 division and product, int64
// truncation per image, int64 clamp and floor division; the build passes
// -fmad=false.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr long long kMB = 1024LL * 1024LL;
constexpr long long kMinThreshold = 23 * kMB;
constexpr long long kMaxContainerThreshold = 1000 * kMB;
constexpr long long kMaxNodeScore = 100;
constexpr int kMaxImages = 16;    // image ids a pod (CI)
constexpr int kTile = 32;         // nodes a block: one a lane
constexpr int kTileThreads = 256; // eight warps, each its own pod of a group
constexpr int kPodGroup = 32;     // pods staged at once, eight threads each
constexpr int kMaxSlots = 512;    // P: a merged row's entries at most
constexpr unsigned kSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void image_counts_kernel(const int* __restrict__ image_ids,      // (N, IM)
                                    const unsigned char* __restrict__ valid,  // (N,)
                                    int N, int IM, int V, int* __restrict__ counts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * IM) return;
  const int n = (int)(idx / IM);
  const int s = (int)(idx % IM);
  if (!valid[n]) return;
  if (s == 0) atomicAdd(counts + V, 1);
  const int* row = image_ids + (size_t)n * IM;
  const int v = row[s];
  if (v < 0 || v >= V) return;
  for (int t = 0; t < s; ++t) {
    if (row[t] == v) return;  // counted at its first slot
  }
  atomicAdd(counts + v, 1);
}

__device__ unsigned char finish(long long sum, long long ncontainers) {
  const long long max_threshold = kMaxContainerThreshold * ncontainers;
  long long clamped = sum < kMinThreshold ? kMinThreshold : sum;
  if (clamped > max_threshold) clamped = max_threshold;
  long long denom = max_threshold - kMinThreshold;
  if (denom < 1) denom = 1;
  return (unsigned char)floordiv_f64(kMaxNodeScore * (clamped - kMinThreshold), denom);
}

// One warp a node row: its IM slots as P = 32 E (key, size) pairs, lane l
// holding slots l E .. l E + E - 1 (past IM: the sentinel).  A slot's key
// is its id as unsigned, so negative ids (-1 padding among them) sort after
// every id >= 0 and are dropped.  Every array is indexed by unrolled
// constants, so it stays in registers.
template <int E>
__global__ void __launch_bounds__(256) image_merge_kernel(const int* __restrict__ image_ids,        // (N, IM)
                                                          const long long* __restrict__ image_sizes,  // (N, IM)
                                                          int N, int IM,
                                                          unsigned* __restrict__ m_ids,       // (N, P)
                                                          long long* __restrict__ m_sizes,    // (N, P)
                                                          int* __restrict__ m_len) {          // (N,)
  constexpr int P = 32 * E;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;  // a whole warp
  unsigned key[E];
  long long val[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    key[e] = kSentinel;
    val[e] = 0;
    if (i < IM) {
      key[e] = (unsigned)image_ids[(size_t)row * IM + i];
      val[e] = image_sizes[(size_t)row * IM + i];
    }
  }
  // Bitonic sort, ascending: at stage (k, j) slot i meets slot i ^ j; the
  // lower of the two keeps the smaller key where (i & k) == 0, the larger
  // elsewhere.  j >= E: the partner is the same e of lane l ^ (j / E).
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = lane * E + e;
          const unsigned ok = __shfl_xor_sync(kFull, key[e], j / E);
          const long long ov = __shfl_xor_sync(kFull, val[e], j / E);
          const bool up = (i & k) == 0;
          const bool lower = (i & j) == 0;
          if (lower == up ? ok < key[e] : ok > key[e]) {
            key[e] = ok;
            val[e] = ov;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int f = e ^ j;
          if (f > e) {
            const bool up = ((lane * E + e) & k) == 0;
            if (up ? key[e] > key[f] : key[e] < key[f]) {
              const unsigned tk = key[e];
              key[e] = key[f];
              key[f] = tk;
              const long long tv = val[e];
              val[e] = val[f];
              val[f] = tv;
            }
          }
        }
      }
    }
  }
  // Runs of one key: a slot heads a run where its key differs from the
  // slot before; run[e] sums the run's sizes up to slot e, first inside the
  // lane, then with the open run carried in from the lanes before.
  const unsigned prev_last = __shfl_up_sync(kFull, key[E - 1], 1);
  const unsigned next_first = __shfl_down_sync(kFull, key[0], 1);
  bool head[E];
  long long run[E];
  int heads = 0, valid_heads = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e == 0) {
      head[e] = lane == 0 || key[0] != prev_last;
      run[e] = val[e];
    } else {
      head[e] = key[e] != key[e - 1];
      run[e] = head[e] ? val[e] : run[e - 1] + val[e];
    }
    heads += head[e] ? 1 : 0;
    valid_heads += (head[e] && key[e] < 0x80000000u) ? 1 : 0;
  }
  // Segmented inclusive scan over the lanes of (the lane holds a head, the
  // sum of its open run): the carry into lane l is lane l - 1's result.
  long long s = run[E - 1];
  bool f = heads > 0;
  int hs = heads;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long s_up = __shfl_up_sync(kFull, s, d);
    const int f_up = __shfl_up_sync(kFull, f ? 1 : 0, d);
    const int h_up = __shfl_up_sync(kFull, hs, d);
    if (lane >= d) {
      if (!f) s += s_up;
      f = f || f_up != 0;
      hs += h_up;
    }
  }
  long long carry = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) carry = 0;
  const int len = __reduce_add_sync(kFull, valid_heads);
  int seen = hs - heads;  // heads in the lanes before
  bool open = true;
  unsigned* out_ids = m_ids + (size_t)row * P;
  long long* out_sizes = m_sizes + (size_t)row * P;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (head[e]) open = false;
    if (open) run[e] += carry;
    seen += head[e] ? 1 : 0;
    const bool tail = e < E - 1 ? key[e + 1] != key[e] : (lane == 31 || next_first != key[e]);
    if (tail && key[e] < 0x80000000u) {
      out_ids[seen - 1] = key[e];
      out_sizes[seen - 1] = run[e];
    }
    if (lane * E + e >= len) out_ids[lane * E + e] = kSentinel;
  }
  if (lane == 0) m_len[row] = len;
}

// One block: the node tile blockIdx.x (32 nodes, one a lane) and the pods
// [blockIdx.y * ppb, + ppb).  Shared memory: the tile's merged ids and
// sizes element-major (P x 32 each), then a pod group's staged ids and
// spreads.
__global__ void __launch_bounds__(kTileThreads) image_tile_kernel(
    const unsigned* __restrict__ m_ids, const long long* __restrict__ m_sizes,
    const int* __restrict__ m_len, int P,
    const int* __restrict__ counts, int V,                 // (V + 1,)
    const int* __restrict__ pod_ids,                       // (K, CI)
    const long long* __restrict__ ncontainers,             // (K,)
    const unsigned char* __restrict__ pod_valid,           // (K,)
    int N, int K, int CI, int ppb,
    unsigned char* __restrict__ out) {                     // (K, N)
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_size = reinterpret_cast<long long*>(smem);              // P * kTile
  double* s_spread = reinterpret_cast<double*>(s_size + P * kTile);     // kPodGroup * kMaxImages
  long long* s_ncont = reinterpret_cast<long long*>(s_spread + kPodGroup * kMaxImages);  // kPodGroup
  unsigned* s_id = reinterpret_cast<unsigned*>(s_ncont + kPodGroup);   // P * kTile
  unsigned* s_want = s_id + P * kTile;                                  // kPodGroup * kMaxImages
  int* s_live = reinterpret_cast<int*>(s_want + kPodGroup * kMaxImages);  // kPodGroup: -1 padding lane
  unsigned char* s_low = reinterpret_cast<unsigned char*>(s_live + kPodGroup);  // kPodGroup
  __shared__ int s_max;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kTile;
  if (tid == 0) s_max = 0;
  __syncthreads();
  if (tid < kTile && n0 + tid < N) atomicMax(&s_max, m_len[n0 + tid]);
  __syncthreads();
  int pt = 8;  // the staged depth: the longest list, a power of two >= 8
  while (pt < s_max) pt <<= 1;
  // Staging: a thread moves 8 ids (32 bytes) or 4 sizes of one node row
  // into 8 or 4 rows of the element-major tile; a warp's lanes take 32
  // nodes, so the stores fill 32 banks.
  for (int e = tid; e < (pt >> 3) * kTile; e += kTileThreads) {
    const int t = e % kTile, jb = (e / kTile) * 8;
    uint4 a = make_uint4(kSentinel, kSentinel, kSentinel, kSentinel), b = a;
    if (n0 + t < N) {
      const uint4* src = reinterpret_cast<const uint4*>(m_ids + (size_t)(n0 + t) * P + jb);
      a = src[0];
      b = src[1];
    }
    s_id[(jb + 0) * kTile + t] = a.x;
    s_id[(jb + 1) * kTile + t] = a.y;
    s_id[(jb + 2) * kTile + t] = a.z;
    s_id[(jb + 3) * kTile + t] = a.w;
    s_id[(jb + 4) * kTile + t] = b.x;
    s_id[(jb + 5) * kTile + t] = b.y;
    s_id[(jb + 6) * kTile + t] = b.z;
    s_id[(jb + 7) * kTile + t] = b.w;
  }
  for (int e = tid; e < (pt >> 2) * kTile; e += kTileThreads) {
    const int t = e % kTile, jb = (e / kTile) * 4;
    longlong2 a = make_longlong2(0, 0), b = a;
    if (n0 + t < N) {
      const longlong2* src = reinterpret_cast<const longlong2*>(m_sizes + (size_t)(n0 + t) * P + jb);
      a = src[0];
      b = src[1];
    }
    s_size[(jb + 0) * kTile + t] = a.x;
    s_size[(jb + 1) * kTile + t] = a.y;
    s_size[(jb + 2) * kTile + t] = b.x;
    s_size[(jb + 3) * kTile + t] = b.y;
  }
  const int total = counts[V] > 1 ? counts[V] : 1;
  const int n = n0 + lane;
  const int k_begin = blockIdx.y * ppb;
  const int k_end = min(K, k_begin + ppb);
  for (int g0 = k_begin; g0 < k_end; g0 += kPodGroup) {
    __syncthreads();  // the tile is staged; the group before is done
    {
      // Eight threads a pod (p, r) stage its ids r and r + 8 that some
      // valid node holds, with their spreads, packed in id order by a
      // ballot over the pod's eight lanes; an id nobody holds (or outside
      // [0, V)) adds 0 to every sum.  s_live: -1 on a padding lane.
      const int p = tid >> 3, r = tid & 7, k = g0 + p;
      const bool pod_ok = k < k_end && pod_valid[k];
      int live = 0;
#pragma unroll
      for (int h = 0; h < kMaxImages; h += 8) {
        const int q = h + r;
        int w = -1, cnt = 0;
        if (pod_ok && q < CI) {
          w = pod_ids[(size_t)k * CI + q];
          cnt = (w >= 0 && w < V) ? counts[w] : 0;
        }
        const unsigned mine = (__ballot_sync(kFull, cnt > 0) >> (lane & ~7)) & 0xFFu;
        if (cnt > 0) {
          const int slot = p * kMaxImages + live + __popc(mine & ((1u << r) - 1));
          s_want[slot] = (unsigned)w;
          s_spread[slot] = (double)cnt / (double)total;
        }
        live += __popc(mine);
      }
      if (r == 0) {
        s_live[p] = pod_ok ? live : -1;
        if (pod_ok) {
          s_ncont[p] = ncontainers[k];
          s_low[p] = finish(0, ncontainers[k]);
        }
      }
    }
    __syncthreads();
    const int g_len = min(kPodGroup, k_end - g0);
    for (int p = warp; p < g_len; p += kTileThreads / 32) {
      const int live = s_live[p];
      unsigned char score = 0;
      if (live >= 0) {
        long long sum = 0;
        for (int m = 0; m < live; ++m) {
          const unsigned w = s_want[p * kMaxImages + m];
          int base = 0;
          for (int half = pt >> 1; half > 0; half >>= 1) {
            if (s_id[(base + half) * kTile + lane] <= w) base += half;
          }
          if (s_id[base * kTile + lane] == w) {
            sum += (long long)((double)s_size[base * kTile + lane] * s_spread[p * kMaxImages + m]);
          }
        }
        // calculatePriority clamps every sum at or below 23 MiB to 23 MiB.
        score = sum <= kMinThreshold ? s_low[p] : finish(sum, s_ncont[p]);
      }
      if (n < N) out[(size_t)(g0 + p) * N + n] = score;
    }
  }
}

// Pinned mode: one thread a pod on its pinned row (clamped into [0, N)).
__global__ void image_pinned_kernel(const int* __restrict__ image_ids,            // (N, IM)
                                    const long long* __restrict__ image_sizes,    // (N, IM)
                                    const unsigned char* __restrict__ node_valid,  // (N,)
                                    const int* __restrict__ pod_ids,              // (K, CI)
                                    const long long* __restrict__ ncontainers,    // (K,)
                                    const unsigned char* __restrict__ pod_valid,  // (K,)
                                    const int* __restrict__ pin,                  // (K,)
                                    int N, int IM, int K, int CI,
                                    unsigned char* __restrict__ out) {            // (K, 1)
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  if (!pod_valid[k]) {
    out[k] = 0;
    return;
  }
  const int n = min(max(pin[k], 0), N - 1);
  const int* row = image_ids + (size_t)n * IM;
  const long long* row_sizes = image_sizes + (size_t)n * IM;
  long long sum = 0;
  for (int q = 0; q < CI; ++q) {
    const int want = pod_ids[(size_t)k * CI + q];
    long long size = 0;
    bool present = false;
    if (want >= 0) {
      for (int s = 0; s < IM; ++s) {
        if (row[s] == want) {
          size += row_sizes[s];
          present = true;
        }
      }
    }
    const double spread = (present && node_valid[n]) ? 1.0 : 0.0;
    sum += (long long)((double)size * spread);
  }
  out[k] = finish(sum, ncontainers[k]);
}

template <int E>
void merge(const int* ids, const long long* sizes, int N, int IM, unsigned* m_ids, long long* m_sizes,
           int* m_len, cudaStream_t s) {
  image_merge_kernel<E><<<(N + 7) / 8, 256, 0, s>>>(ids, sizes, N, IM, m_ids, m_sizes, m_len);
}

size_t tile_smem(int P) {
  return (size_t)P * kTile * (8 + 4) + (size_t)kPodGroup * kMaxImages * (8 + 4) + kPodGroup * (8 + 4 + 1);
}

}  // namespace

extern "C" int image_counts_launch(const void* image_ids, const void* valid, int N, int IM, int V,
                                   void* counts, void* stream) {
  const long long total = (long long)N * IM;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  image_counts_kernel<<<(unsigned int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(image_ids), static_cast<const unsigned char*>(valid), N, IM, V,
      static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

// Unpinned: image_merge into the (N, P) scratch lists m_ids / m_sizes and
// m_len, then image_tile over (ceil(N / 32), ks) blocks of ppb pods.
// Pinned (pin non-null): image_pinned alone (counts and the scratch unused).
extern "C" int image_scores_launch(const void* image_ids, const void* image_sizes,
                                   const void* node_valid, const void* counts, const void* pod_ids,
                                   const void* ncontainers, const void* pod_valid, const void* pin,
                                   int N, int IM, int V, int K, int CI, void* m_ids, void* m_sizes,
                                   void* m_len, int P, int ks, int ppb, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CI < 1 || CI > kMaxImages || N < 1) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  if (pin != nullptr) {
    image_pinned_kernel<<<(K + 127) / 128, 128, 0, s>>>(
        static_cast<const int*>(image_ids), static_cast<const long long*>(image_sizes),
        static_cast<const unsigned char*>(node_valid), static_cast<const int*>(pod_ids),
        static_cast<const long long*>(ncontainers), static_cast<const unsigned char*>(pod_valid),
        static_cast<const int*>(pin), N, IM, K, CI, static_cast<unsigned char*>(out));
    return (int)cudaGetLastError();
  }
  if (P < 32 || P > kMaxSlots || (P & (P - 1)) != 0 || IM > P || ks < 1 || ks > 65535 || ppb < 1 ||
      (long long)ks * ppb < K) {
    return (int)cudaErrorInvalidValue;
  }
  const int* ids = static_cast<const int*>(image_ids);
  const long long* sizes = static_cast<const long long*>(image_sizes);
  unsigned* mi = static_cast<unsigned*>(m_ids);
  long long* ms = static_cast<long long*>(m_sizes);
  int* ml = static_cast<int*>(m_len);
  switch (P) {
    case 32: merge<1>(ids, sizes, N, IM, mi, ms, ml, s); break;
    case 64: merge<2>(ids, sizes, N, IM, mi, ms, ml, s); break;
    case 128: merge<4>(ids, sizes, N, IM, mi, ms, ml, s); break;
    case 256: merge<8>(ids, sizes, N, IM, mi, ms, ml, s); break;
    default: merge<16>(ids, sizes, N, IM, mi, ms, ml, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(image_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tile_smem(kMaxSlots));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((N + kTile - 1) / kTile, ks);
  image_tile_kernel<<<grid, kTileThreads, tile_smem(P), s>>>(
      mi, ms, ml, P, static_cast<const int*>(counts), V, static_cast<const int*>(pod_ids),
      static_cast<const long long*>(ncontainers), static_cast<const unsigned char*>(pod_valid), N, K, CI,
      ppb, static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(image_locality)
