// conflict_pairs: the chunk-mate conflict table of a whole batch.
//
// Replaces the inter-pod-affinity, topology-spread, host-port, volume and
// DRA branches of kubernetes_tpu/engine/pass_.py _conflict_pairs
// (:266-342), evaluated per scan step by the JAX pass:
//   pairs[b, i, j] = reads_g[j, group[i]] or (exists a: hard_t[j, own[i, a]])
//                    or (i and j share a device volume id, a CSI volume id,
//                    a host-port (proto, port) key or a DRA claim id) or
//                    (vol_unbound[i] and vol_unbound[j]) or (both i and j
//                    have a slot with an unallocated claim)
// for pods i != j of chunk b, where reads_g = ipa_ra_allmask or
// any(ipa_rs_groups) (the groups pod j's required (anti-)affinity reads)
// or any(tps_h_groups) (the groups pod j's DoNotSchedule spread
// constraints count), and hard_t = ipa_et_match and ipa_et_anti (the
// existing anti-affinity terms pod j matches).  A pointer is null when the
// batch carries none of its features (G is 0 when no group is read).  The
// JAX pass builds these with einsums of one-hot matrices and the volume
// part with an all-pairs id comparison; here each entry is a handful of
// gathers and an SD^2 + SC^2 + SP^2 + SK^2 id comparison.
//
// One thread per (chunk, i, j): nchunks * C * C threads, one launch per
// batch (features do not change between chunks).
//
// Bound: bytes.  It reads, per pair, one mask byte per group read (RS +
// CH + 1 of them) and two term bytes per own term of i, and writes one
// byte; the group, own-term and volume ids are read once per pod.
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
                                      const int* __restrict__ dev_ids,               // (K, SD)
                                      const int* __restrict__ csi_ids,               // (K, SC)
                                      const unsigned char* __restrict__ unbound,     // (K,)
                                      const int* __restrict__ port_keys,             // (K, SP)
                                      const int* __restrict__ dra_ids,               // (K, SK)
                                      const unsigned char* __restrict__ dra_unalloc, // (K, SK)
                                      int nchunks, int C, int G, int RS, int ET, int A, int CH,
                                      int SD, int SC, int SP, int SK,
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
    if (G > 0) {
      int g = group[pi];
      g = g < 0 ? 0 : (g >= G ? G - 1 : g);
      if (ra_allmask != nullptr) p = ra_allmask[pj * G + g] != 0;
      for (int t = 0; !p && t < RS; ++t) p = rs_groups[(pj * RS + t) * G + g] != 0;
      for (int t = 0; !p && t < CH; ++t) p = tps_groups[(pj * CH + t) * G + g] != 0;
    }
    for (int q = 0; !p && q < A; ++q) {
      const int e = own[pi * A + q];
      if (e >= 0 && e < ET) p = et_match[pj * ET + e] && et_anti[pj * ET + e];
    }
    for (int s = 0; !p && dev_ids != nullptr && s < SD; ++s) {
      const int v = dev_ids[pi * SD + s];
      for (int s2 = 0; v >= 0 && !p && s2 < SD; ++s2) p = dev_ids[pj * SD + s2] == v;
    }
    for (int s = 0; !p && csi_ids != nullptr && s < SC; ++s) {
      const int v = csi_ids[pi * SC + s];
      for (int s2 = 0; v >= 0 && !p && s2 < SC; ++s2) p = csi_ids[pj * SC + s2] == v;
    }
    for (int s = 0; !p && port_keys != nullptr && s < SP; ++s) {
      const int v = port_keys[pi * SP + s];
      for (int s2 = 0; v >= 0 && !p && s2 < SP; ++s2) p = port_keys[pj * SP + s2] == v;
    }
    if (!p && unbound != nullptr) p = unbound[pi] && unbound[pj];
    for (int s = 0; !p && dra_ids != nullptr && s < SK; ++s) {
      const int v = dra_ids[pi * SK + s];
      for (int s2 = 0; v >= 0 && !p && s2 < SK; ++s2) p = dra_ids[pj * SK + s2] == v;
    }
    if (!p && dra_unalloc != nullptr) {
      bool ui = false, uj = false;
      for (int s = 0; s < SK; ++s) {
        ui = ui || dra_unalloc[pi * SK + s];
        uj = uj || dra_unalloc[pj * SK + s];
      }
      p = ui && uj;
    }
  }
  pairs[idx] = p ? 1 : 0;
}

}  // namespace

extern "C" int conflict_pairs_launch(const void* group, const void* ra_allmask,
                                     const void* rs_groups, const void* et_match,
                                     const void* et_anti, const void* own,
                                     const void* tps_groups, const void* dev_ids,
                                     const void* csi_ids, const void* unbound,
                                     const void* port_keys, const void* dra_ids,
                                     const void* dra_unalloc, int nchunks, int C, int G, int RS,
                                     int ET, int A, int CH, int SD, int SC, int SP, int SK,
                                     void* pairs, void* stream) {
  const long long total = (long long)nchunks * C * C;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  conflict_pairs_kernel<<<(unsigned int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(group), static_cast<const unsigned char*>(ra_allmask),
      static_cast<const unsigned char*>(rs_groups), static_cast<const unsigned char*>(et_match),
      static_cast<const unsigned char*>(et_anti), static_cast<const int*>(own),
      static_cast<const unsigned char*>(tps_groups), static_cast<const int*>(dev_ids),
      static_cast<const int*>(csi_ids), static_cast<const unsigned char*>(unbound),
      static_cast<const int*>(port_keys), static_cast<const int*>(dra_ids),
      static_cast<const unsigned char*>(dra_unalloc), nchunks, C, G, RS, ET, A, CH, SD, SC, SP, SK,
      static_cast<unsigned char*>(pairs));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(conflict_pairs)
