// conflict_pairs: the chunk-mate conflict table of a whole batch.
//
// Replaces the inter-pod-affinity and topology-spread branches of
// kubernetes_tpu/engine/pass_.py _conflict_pairs (:266-306), evaluated per
// scan step by the JAX pass:
//   pairs[b, i, j] = reads_g[j, group[i]] or (exists a: hard_t[j, own[i, a]])
// for pods i != j of chunk b, where reads_g = ipa_ra_allmask or
// any(ipa_rs_groups) (the groups pod j's required (anti-)affinity reads)
// or any(tps_h_groups) (the groups pod j's DoNotSchedule spread
// constraints count), and hard_t = ipa_et_match and ipa_et_anti (the
// existing anti-affinity terms pod j matches).  The affinity pointers are
// null for a spread-only batch, the spread pointer for an affinity-only
// one.  The JAX pass builds these with einsums of one-hot matrices; here
// each entry is a handful of gathers.
//
// One thread per (chunk, i, j): nchunks * C * C threads, one launch per
// batch (features do not change between chunks).
//
// Bound: bytes.  It reads, per pair, one mask byte per group read (RS +
// CH + 1 of them) and two term bytes per own term of i, and writes one
// byte; the group and own-term ids are read once per pod.
#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void conflict_pairs_kernel(const int* __restrict__ group,               // (K,)
                                      const unsigned char* __restrict__ ra_allmask,  // (K, G)
                                      const unsigned char* __restrict__ rs_groups,   // (K, RS, G)
                                      const unsigned char* __restrict__ et_match,    // (K, ET)
                                      const unsigned char* __restrict__ et_anti,     // (K, ET)
                                      const int* __restrict__ own,                   // (K, A)
                                      const unsigned char* __restrict__ tps_groups,  // (K, CH, G)
                                      int nchunks, int C, int G, int RS, int ET, int A, int CH,
                                      unsigned char* __restrict__ pairs) {  // (nchunks, C, C)
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)nchunks * C * C;
  if (idx >= total) return;
  const int j = (int)(idx % C);
  const int i = (int)((idx / C) % C);
  const int b = (int)(idx / ((long long)C * C));
  bool p = false;
  if (i != j) {
    const size_t pi = (size_t)b * C + i;
    const size_t pj = (size_t)b * C + j;
    int g = group[pi];
    g = g < 0 ? 0 : (g >= G ? G - 1 : g);
    if (ra_allmask != nullptr) p = ra_allmask[pj * G + g] != 0;
    for (int t = 0; !p && t < RS; ++t) p = rs_groups[(pj * RS + t) * G + g] != 0;
    for (int t = 0; !p && t < CH; ++t) p = tps_groups[(pj * CH + t) * G + g] != 0;
    for (int q = 0; !p && q < A; ++q) {
      const int e = own[pi * A + q];
      if (e >= 0 && e < ET) p = et_match[pj * ET + e] && et_anti[pj * ET + e];
    }
  }
  pairs[idx] = p ? 1 : 0;
}

}  // namespace

extern "C" int conflict_pairs_launch(const void* group, const void* ra_allmask,
                                     const void* rs_groups, const void* et_match,
                                     const void* et_anti, const void* own,
                                     const void* tps_groups, int nchunks, int C, int G, int RS,
                                     int ET, int A, int CH, void* pairs, void* stream) {
  const long long total = (long long)nchunks * C * C;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  conflict_pairs_kernel<<<(unsigned int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(group), static_cast<const unsigned char*>(ra_allmask),
      static_cast<const unsigned char*>(rs_groups), static_cast<const unsigned char*>(et_match),
      static_cast<const unsigned char*>(et_anti), static_cast<const int*>(own),
      static_cast<const unsigned char*>(tps_groups), nchunks, C, G, RS, ET, A, CH,
      static_cast<unsigned char*>(pairs));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(conflict_pairs)
