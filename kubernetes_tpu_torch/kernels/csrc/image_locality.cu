// image_locality: ImageLocality's score plane of a whole batch.
//
// Replaces kubernetes_tpu/ops/imagelocality.py:53 score_fn (with the
// featurized ids of :38), which the JAX pass evaluates per pod inside every
// chunk step.  Images and node validity do not change within a pass, so the
// score of a pod on a node depends on no commit: two launches per batch
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
//                 23 MiB) (image_locality.go:84 calculatePriority).  One
//                 thread per (pod, node); a padding lane (valid false)
//                 scores 0.  Pinned mode (pin non-null; the pinned-batch
//                 pass): (K, 1), pod k on row pin[k] alone, with the spread
//                 taken over that one row as the JAX pass's one-row state
//                 slice takes it: 1 where the row is valid and holds the
//                 image, else 0; one thread per pod.
//
// Bound: bytes.  image_counts reads the (N, IM) id table and writes V + 1
// counts.  image_scores must read the id table, the sizes only where an id
// matches, the pod ids and counts, and write K*N bytes; a thread re-reads
// its node's id row from the L1/L2 caches for every pod, so the kernel is
// bounded in practice by those cached reads (K*N*IM ids), not by device
// memory.  The plane is one byte a (pod, node) pair, so eval_chunk reads
// C*N bytes of it per chunk.
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
constexpr int kMaxImages = 16;  // per pod (CI), wants held in registers

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
  return (unsigned char)floordiv_i64(kMaxNodeScore * (clamped - kMinThreshold), denom);
}

__global__ void image_scores_kernel(const int* __restrict__ image_ids,          // (N, IM)
                                    const long long* __restrict__ image_sizes,  // (N, IM)
                                    const unsigned char* __restrict__ node_valid,  // (N,)
                                    const int* __restrict__ counts,             // (V + 1,)
                                    const int* __restrict__ pod_ids,            // (K, CI)
                                    const long long* __restrict__ ncontainers,  // (K,)
                                    const unsigned char* __restrict__ pod_valid,  // (K,)
                                    const int* __restrict__ pin,                // (K,) or null
                                    int N, int IM, int V, int K, int CI,
                                    unsigned char* __restrict__ out) {  // (K, N) or (K, 1)
  const bool pinned = pin != nullptr;
  int k, n;
  size_t o;
  if (pinned) {  // one thread per pod, on its pinned row (clamped into [0, N))
    k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    n = min(max(pin[k], 0), N - 1);
    o = (size_t)k;
  } else {  // one thread per (pod, node)
    k = blockIdx.y;
    n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= N) return;
    o = (size_t)k * N + n;
  }
  if (!pod_valid[k]) {
    out[o] = 0;
    return;
  }
  int want[kMaxImages];
  double spread[kMaxImages];
  long long size[kMaxImages];
  for (int q = 0; q < CI; ++q) {
    want[q] = pod_ids[(size_t)k * CI + q];
    size[q] = 0;
    if (pinned) {
      spread[q] = 0.0;  // set below from the row itself
    } else {
      const int cnt = (want[q] >= 0 && want[q] < V) ? counts[want[q]] : 0;
      const int total = counts[V] > 1 ? counts[V] : 1;
      spread[q] = (double)cnt / (double)total;
    }
  }
  const int* row = image_ids + (size_t)n * IM;
  const long long* row_sizes = image_sizes + (size_t)n * IM;
  unsigned int present = 0;
  for (int s = 0; s < IM; ++s) {
    const int v = row[s];
    if (v < 0) continue;
    for (int q = 0; q < CI; ++q) {
      if (v == want[q]) {
        size[q] += row_sizes[s];
        present |= 1u << q;
      }
    }
  }
  long long sum = 0;
  for (int q = 0; q < CI; ++q) {
    if (pinned) spread[q] = (((present >> q) & 1) && node_valid[n]) ? 1.0 : 0.0;
    sum += (long long)((double)size[q] * spread[q]);
  }
  out[o] = finish(sum, ncontainers[k]);
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

extern "C" int image_scores_launch(const void* image_ids, const void* image_sizes,
                                   const void* node_valid, const void* counts, const void* pod_ids,
                                   const void* ncontainers, const void* pod_valid, const void* pin,
                                   int N, int IM, int V, int K, int CI, void* out, void* stream) {
  const bool pinned = pin != nullptr;
  if (CI < 1 || CI > kMaxImages || N < 1 || (!pinned && K > 65535)) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int threads = 128;
  dim3 grid(pinned ? (K + threads - 1) / threads : (N + threads - 1) / threads, pinned ? 1 : K);
  image_scores_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(image_ids), static_cast<const long long*>(image_sizes),
      static_cast<const unsigned char*>(node_valid), static_cast<const int*>(counts),
      static_cast<const int*>(pod_ids), static_cast<const long long*>(ncontainers),
      static_cast<const unsigned char*>(pod_valid), static_cast<const int*>(pin), N, IM, V, K, CI,
      static_cast<unsigned char*>(out));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(image_locality)
