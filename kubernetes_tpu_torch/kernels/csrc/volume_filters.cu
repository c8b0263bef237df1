// vol_filter: the VolumeRestrictions and NodeVolumeLimits filters of one
// chunk of C pods against every node.
//
// Replaces kubernetes_tpu/ops/volumes.py _vr_filter (:217) and
// _nvl_filter (:238), which the JAX pass evaluates per pod inside every
// scan step.  Both read counts the chunk commits change (dev_counts,
// dev_rw_counts, csivol_counts, csi_used), so this runs per chunk, before
// eval_chunk, which reads the result as those ops' filter planes.  The
// output is a (C, N) byte: bit 0 VolumeRestrictions (no device-volume use
// conflicts, a read-only use conflicting only with a writer, and the
// ReadWriteOncePod check), bit 1 NodeVolumeLimits (per CSI driver, the
// node's attached volumes plus the pod's volumes not yet attached there
// stay within the limit wherever the pod attaches one); a bit not asked
// for is 1.
//
// One thread per (pod, node), grid (ceil(N/128), C).  The JAX op gathers
// the (S, N) count rows of the pod's S volume ids and reduces per-driver
// one-hot products; here each thread gathers its node's count of each id
// and counts new attachments per driver by a pass over the pod's slots
// (S is a handful).  csivol_counts is (CV, N) and can be hundreds of MB:
// only the pod's rows are read, never the whole table.
//
// Bound: bytes.  Per pod it reads one row of N int32 counts per volume id
// (dev_counts for a writer, dev_rw_counts for a read-only use,
// csivol_counts for a CSI volume) and the used and limit cells of each
// driver where it attaches a new volume, and it writes C x N bytes.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

struct VolArgs {
  const int* dev_counts;       // (VD, N)
  const int* dev_rw_counts;    // (VD, N)
  const int* csivol_counts;    // (CV, N)
  const int* csi_used;         // (DR, N)
  const int* csi_limit;        // (DR, N)
  const int* dev_ids;          // (C, SD), -1 pad; null: no device volumes
  const unsigned char* dev_rw; // (C, SD)
  const unsigned char* rwop_ok;  // (C,)
  const int* csi_ids;          // (C, SC), -1 pad; null: no CSI volumes
  const int* csi_drv;          // (C, SC)
  unsigned char* out;          // (C, N)
  int C, N, SD, SC, DR;
  int do_vr, do_nvl;
};

__global__ void vol_filter_kernel(VolArgs a) {
  const int c = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  bool vr = true;
  if (a.do_vr) {
    vr = a.rwop_ok[c] != 0;
    for (int s = 0; a.dev_ids != nullptr && s < a.SD; ++s) {
      const int id = a.dev_ids[(size_t)c * a.SD + s];
      if (id < 0) continue;
      const bool writer = a.dev_rw[(size_t)c * a.SD + s] != 0;
      const size_t o = (size_t)id * a.N + n;
      // A read-only use conflicts only with a writer; a writer with any use.
      if (writer ? a.dev_counts[o] > 0 : a.dev_rw_counts[o] > 0) vr = false;
    }
  }
  bool nvl = true;
  if (a.do_nvl && a.csi_ids != nullptr) {
    const int* ids = a.csi_ids + (size_t)c * a.SC;
    const int* drv = a.csi_drv + (size_t)c * a.SC;
    for (int s = 0; nvl && s < a.SC; ++s) {
      const int d = drv[s];
      if (ids[s] < 0 || d < 0 || d >= a.DR) continue;
      if (a.csivol_counts[(size_t)ids[s] * a.N + n] > 0) continue;  // attached already
      // The first new volume of driver d checks the budget of d: the
      // count of all the pod's new volumes of d.
      bool first = true;
      long long fresh = 0;
      for (int s2 = 0; s2 < a.SC; ++s2) {
        if (ids[s2] < 0 || drv[s2] != d) continue;
        if (a.csivol_counts[(size_t)ids[s2] * a.N + n] > 0) continue;
        if (s2 < s) first = false;
        ++fresh;
      }
      const size_t o = (size_t)d * a.N + n;
      if (first && (long long)a.csi_used[o] + fresh > (long long)a.csi_limit[o]) nvl = false;
    }
  }
  a.out[(size_t)c * a.N + n] = (vr ? 1 : 0) | (nvl ? 2 : 0);
}

}  // namespace

extern "C" int vol_filter_launch(const void* dev_counts, const void* dev_rw_counts,
                                 const void* csivol_counts, const void* csi_used,
                                 const void* csi_limit, const void* dev_ids, const void* dev_rw,
                                 const void* rwop_ok, const void* csi_ids, const void* csi_drv,
                                 void* out, int C, int N, int SD, int SC, int DR, int do_vr,
                                 int do_nvl, void* stream) {
  if (C > 65535) return (int)cudaErrorInvalidValue;
  if (C == 0 || N == 0) return 0;
  VolArgs a;
  a.dev_counts = static_cast<const int*>(dev_counts);
  a.dev_rw_counts = static_cast<const int*>(dev_rw_counts);
  a.csivol_counts = static_cast<const int*>(csivol_counts);
  a.csi_used = static_cast<const int*>(csi_used);
  a.csi_limit = static_cast<const int*>(csi_limit);
  a.dev_ids = static_cast<const int*>(dev_ids);
  a.dev_rw = static_cast<const unsigned char*>(dev_rw);
  a.rwop_ok = static_cast<const unsigned char*>(rwop_ok);
  a.csi_ids = static_cast<const int*>(csi_ids);
  a.csi_drv = static_cast<const int*>(csi_drv);
  a.out = static_cast<unsigned char*>(out);
  a.C = C;
  a.N = N;
  a.SD = SD;
  a.SC = SC;
  a.DR = DR;
  a.do_vr = do_vr;
  a.do_nvl = do_nvl;
  dim3 grid((N + kThreads - 1) / kThreads, C);
  vol_filter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(volume_filters)
