// resolve_commit: chunk conflict resolution plus the commit of placed pods.
//
// Replaces kubernetes_tpu/engine/pass_.py:570-617 (the chunk step's
// interaction deferral and exact cumulative fit) and _commit_chunk
// (:166-210): req, nonzero_req, num_pods, group_counts and the carried
// group_dom table, and the pod's own (anti-)affinity terms: et_counts[e,
// row] += 1 and et_dom[e, d] += 1 where d is the node's value at term e's
// own topology slot (values outside [0, DV), such as hostname values, are
// dropped, as the JAX scatter drops them), the host-port branch
// (:195-201): port_counts at each of the pod's (proto, ip, port) triples
// and portkey_counts at its (proto, port) keys, and the device and CSI
// branches (:211-236): dev_counts and dev_rw_counts at the pod's device
// ids, and csivol_counts at its CSI volume ids with csi_used[driver] += 1
// where the volume's count before the chunk was 0, and the DRA branch
// (:237-260): dra_claim_counts[kid, row] += 1 at each claim's first slot,
// and dra_alloc[pool, row] += the slot's devices at every slot whose
// claim's count before the chunk was 0.  The port branch applies to strict
// commits too (the pinned pass's, pass_.py:1040).
//
// One block per chunk, one thread per pod (C <= 1024).  With chunk > 1:
//   (a) a valid pod behind an attempting chunk-mate that conflicts with it
//       (pairs[i, j], i < j) defers;
//   (b) the remaining attempting pods check exact cumulative fit at their
//       picked node: the chunk-prefix demand of same-node mates (i <= j)
//       against the chunk-start free capacity, per requested resource, and
//       the pod count against allowed pods; a pod that overflows defers;
//   (c) so does an attach-limited pod (vol_csi_lim) whose node an earlier
//       attempting limited mate also picked (:605-613): distinct volumes
//       still share one per-driver budget there.
// Every state read of (a)-(c) happens before the barrier that precedes the
// commit, so it sees the chunk-start state; so does each committing pod's
// read of its CSI volumes' and its claims' counts (one bit per slot), so
// two mates attaching different volumes of one driver on one node each add
// 1, and every slot of one claim sees the count before its first slot
// moved it.  Committed pods then
// scatter-add their deltas with atomics: duplicate rows accumulate, and the
// f32 group_dom adds are exact because the counts stay below 2^24.  Picks
// come out as -2 (deferred), -1 (invalid or unschedulable) or the row.
//
// Bound: operations on a handful of bytes (C*C*R int64 prefix sums plus
// C*(R+2+2+TK+2A+2SD+2SC+2SP+2SK) atomics); one block does the whole chunk,
// so its time is launch latency.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxChunk = 1024;

struct CommitArgs {
  const int* picks;            // (C,)
  const unsigned char* valid;  // (C,)
  const unsigned char* pairs;  // (C, C): pairs[i*C + j] — i's commit affects j
  int strict;                  // chunk == 1: no deferral, no cumulative fit
  const long long* pod_req;      // (C, R)
  const long long* pod_nonzero;  // (C, 2)
  const int* group;              // (C,)
  const long long* alloc;        // (N, R)
  long long* req;                // (N, R)
  long long* nonzero_req;        // (N, 2)
  int* num_pods;                 // (N,)
  const int* allowed_pods;       // (N,)
  int* group_counts;             // (G, N)
  float* group_dom;              // (G, TK, DV)
  const int* topo_vals;          // (N, TK)
  const int* own;                // (C, A) own term ids, -1 pad; null: none
  int* et_counts;                // (ET, N)
  float* et_dom;                 // (ET, DV)
  const int* et_slot;            // (ET,)
  // Volume features and state (the features null when the chunk carries none).
  const int* dev_ids;            // (C, SD), -1 pad
  const unsigned char* dev_rw;   // (C, SD)
  int* dev_counts;               // (VD, N)
  int* dev_rw_counts;            // (VD, N)
  const int* csi_ids;            // (C, SC), -1 pad
  const int* csi_drv;            // (C, SC)
  int* csivol_counts;            // (CV, N)
  int* csi_used;                 // (DR, N)
  const unsigned char* csi_lim;  // (C,)
  // Host ports (null when the chunk carries none).
  const int* port_triples;       // (C, SP), -1 pad
  const int* port_keys;          // (C, SP)
  int* port_counts;              // (P, N)
  int* portkey_counts;           // (PK, N)
  // DRA claim slots (null when the chunk carries none) and the columns.
  const int* dra_ids;            // (C, SK), -1 pad
  const int* dra_cls;            // (C, SK)
  const int* dra_cnt;            // (C, SK)
  const unsigned char* dra_first;  // (C, SK)
  int* dra_claim_counts;         // (CLM, N)
  int* dra_alloc;                // (DC, N)
  int C, N, R, TK, DV, A, SD, SC, DR, SP, SK, DC;
  int* out_picks;  // (C,)
};

__global__ void resolve_commit_kernel(CommitArgs a) {
  __shared__ int s_pick[kMaxChunk];
  __shared__ unsigned char s_att[kMaxChunk];
  const int j = threadIdx.x;
  const bool in = j < a.C;
  const bool v = in && a.valid[j] != 0;
  const int p = in ? a.picks[j] : -1;
  const bool att0 = v && p >= 0;
  if (in) {
    s_att[j] = att0;
    s_pick[j] = p;
  }
  __syncthreads();
  bool defer = false;
  if (!a.strict && in) {
    // (a) Interaction deferral behind an attempting earlier conflicting mate.
    bool d = false;
    for (int i = 0; i < j; ++i) {
      if (a.pairs[(size_t)i * a.C + j] && s_att[i]) d = true;
    }
    defer = d && v;
  }
  const bool att1 = att0 && !defer;
  __syncthreads();
  if (in) s_att[j] = att1;
  __syncthreads();
  bool overflow = false;
  if (!a.strict && att1) {
    // (b) Exact cumulative fit at the picked node, in chunk order.
    const int row = p;
    const long long* preq_j = a.pod_req + (size_t)j * a.R;
    bool ok = true;
    for (int r = 0; r < a.R; ++r) {
      long long cum = 0;
      for (int i = 0; i <= j; ++i) {
        if (s_att[i] && s_pick[i] == row) cum += a.pod_req[(size_t)i * a.R + r];
      }
      const long long free_r = a.alloc[(size_t)row * a.R + r] - a.req[(size_t)row * a.R + r];
      if (!(preq_j[r] == 0 || cum <= free_r)) ok = false;
    }
    int cnt = 0;
    for (int i = 0; i <= j; ++i) {
      if (s_att[i] && s_pick[i] == row) ++cnt;
    }
    ok = ok && (a.num_pods[row] + cnt <= a.allowed_pods[row]);
    if (a.csi_lim != nullptr && a.csi_lim[j]) {
      for (int i = 0; i < j; ++i) {
        if (s_att[i] && s_pick[i] == row && a.csi_lim[i]) ok = false;
      }
    }
    overflow = !ok;
  }
  defer = defer || overflow;
  const bool att2 = att1 && !overflow;
  // Which CSI volumes this pod newly attaches: counts before the chunk.
  unsigned long long fresh = 0;
  for (int s = 0; att2 && a.csi_ids != nullptr && s < a.SC; ++s) {
    const int id = a.csi_ids[(size_t)j * a.SC + s];
    if (id >= 0 && a.csivol_counts[(size_t)id * a.N + p] == 0) fresh |= 1ull << s;
  }
  // Which claim slots charge their pool: the claim's count before the chunk.
  unsigned long long dra_fresh = 0;
  for (int s = 0; att2 && a.dra_ids != nullptr && s < a.SK; ++s) {
    const int id = a.dra_ids[(size_t)j * a.SK + s];
    if (id >= 0 && a.dra_claim_counts[(size_t)id * a.N + p] == 0) dra_fresh |= 1ull << s;
  }
  __syncthreads();  // every read of the chunk-start state is done
  if (att2) {
    const int row = p;
    for (int r = 0; r < a.R; ++r) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.req + (size_t)row * a.R + r),
                static_cast<unsigned long long>(a.pod_req[(size_t)j * a.R + r]));
    }
    for (int r = 0; r < 2; ++r) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.nonzero_req + (size_t)row * 2 + r),
                static_cast<unsigned long long>(a.pod_nonzero[(size_t)j * 2 + r]));
    }
    atomicAdd(a.num_pods + row, 1);
    const int g = a.group[j];
    atomicAdd(a.group_counts + (size_t)g * a.N + row, 1);
    for (int k = 0; k < a.TK; ++k) {
      const int d = a.topo_vals[(size_t)row * a.TK + k];
      if (d >= 0 && d < a.DV) {
        atomicAdd(a.group_dom + ((size_t)g * a.TK + k) * a.DV + d, 1.0f);
      }
    }
    for (int q = 0; a.own != nullptr && q < a.A; ++q) {
      const int e = a.own[(size_t)j * a.A + q];
      if (e < 0) continue;
      atomicAdd(a.et_counts + (size_t)e * a.N + row, 1);
      const int d = a.topo_vals[(size_t)row * a.TK + a.et_slot[e]];
      if (d >= 0 && d < a.DV) atomicAdd(a.et_dom + (size_t)e * a.DV + d, 1.0f);
    }
    for (int s = 0; a.dev_ids != nullptr && s < a.SD; ++s) {
      const int id = a.dev_ids[(size_t)j * a.SD + s];
      if (id < 0) continue;
      atomicAdd(a.dev_counts + (size_t)id * a.N + row, 1);
      if (a.dev_rw[(size_t)j * a.SD + s]) atomicAdd(a.dev_rw_counts + (size_t)id * a.N + row, 1);
    }
    for (int s = 0; a.csi_ids != nullptr && s < a.SC; ++s) {
      const int id = a.csi_ids[(size_t)j * a.SC + s];
      if (id < 0) continue;
      atomicAdd(a.csivol_counts + (size_t)id * a.N + row, 1);
      const int d = a.csi_drv[(size_t)j * a.SC + s];
      if (((fresh >> s) & 1) && d >= 0 && d < a.DR) atomicAdd(a.csi_used + (size_t)d * a.N + row, 1);
    }
    for (int s = 0; a.port_triples != nullptr && s < a.SP; ++s) {
      const int triple = a.port_triples[(size_t)j * a.SP + s];
      if (triple < 0) continue;
      atomicAdd(a.port_counts + (size_t)triple * a.N + row, 1);
      const int key = a.port_keys[(size_t)j * a.SP + s];
      atomicAdd(a.portkey_counts + (size_t)(key < 0 ? 0 : key) * a.N + row, 1);
    }
    for (int s = 0; a.dra_ids != nullptr && s < a.SK; ++s) {
      const size_t o = (size_t)j * a.SK + s;
      const int id = a.dra_ids[o];
      if (id < 0) continue;
      if (a.dra_first[o]) atomicAdd(a.dra_claim_counts + (size_t)id * a.N + row, 1);
      const int d = a.dra_cls[o];
      if (((dra_fresh >> s) & 1) && d >= 0 && d < a.DC) atomicAdd(a.dra_alloc + (size_t)d * a.N + row, a.dra_cnt[o]);
    }
  }
  if (in) a.out_picks[j] = defer ? -2 : (v ? p : -1);
}

}  // namespace

extern "C" int resolve_commit_launch(
    const void* picks, const void* valid, const void* pairs, int strict,
    const void* pod_req, const void* pod_nonzero, const void* group,
    const void* alloc, void* req, void* nonzero_req, void* num_pods,
    const void* allowed_pods, void* group_counts, void* group_dom,
    const void* topo_vals, const void* own, void* et_counts, void* et_dom,
    const void* et_slot, const void* dev_ids, const void* dev_rw, void* dev_counts,
    void* dev_rw_counts, const void* csi_ids, const void* csi_drv, void* csivol_counts,
    void* csi_used, const void* csi_lim, const void* port_triples, const void* port_keys,
    void* port_counts, void* portkey_counts, const void* dra_ids, const void* dra_cls,
    const void* dra_cnt, const void* dra_first, void* dra_claim_counts, void* dra_alloc, int C, int N,
    int R, int TK, int DV, int A, int SD, int SC, int DR, int SP, int SK, int DC, void* out_picks,
    void* stream) {
  if (C > kMaxChunk || C < 1 || SC > 64 || SK > 64) return (int)cudaErrorInvalidValue;
  CommitArgs a;
  a.picks = static_cast<const int*>(picks);
  a.valid = static_cast<const unsigned char*>(valid);
  a.pairs = static_cast<const unsigned char*>(pairs);
  a.strict = strict;
  a.pod_req = static_cast<const long long*>(pod_req);
  a.pod_nonzero = static_cast<const long long*>(pod_nonzero);
  a.group = static_cast<const int*>(group);
  a.alloc = static_cast<const long long*>(alloc);
  a.req = static_cast<long long*>(req);
  a.nonzero_req = static_cast<long long*>(nonzero_req);
  a.num_pods = static_cast<int*>(num_pods);
  a.allowed_pods = static_cast<const int*>(allowed_pods);
  a.group_counts = static_cast<int*>(group_counts);
  a.group_dom = static_cast<float*>(group_dom);
  a.topo_vals = static_cast<const int*>(topo_vals);
  a.own = static_cast<const int*>(own);
  a.et_counts = static_cast<int*>(et_counts);
  a.et_dom = static_cast<float*>(et_dom);
  a.et_slot = static_cast<const int*>(et_slot);
  a.dev_ids = static_cast<const int*>(dev_ids);
  a.dev_rw = static_cast<const unsigned char*>(dev_rw);
  a.dev_counts = static_cast<int*>(dev_counts);
  a.dev_rw_counts = static_cast<int*>(dev_rw_counts);
  a.csi_ids = static_cast<const int*>(csi_ids);
  a.csi_drv = static_cast<const int*>(csi_drv);
  a.csivol_counts = static_cast<int*>(csivol_counts);
  a.csi_used = static_cast<int*>(csi_used);
  a.csi_lim = static_cast<const unsigned char*>(csi_lim);
  a.port_triples = static_cast<const int*>(port_triples);
  a.port_keys = static_cast<const int*>(port_keys);
  a.port_counts = static_cast<int*>(port_counts);
  a.portkey_counts = static_cast<int*>(portkey_counts);
  a.dra_ids = static_cast<const int*>(dra_ids);
  a.dra_cls = static_cast<const int*>(dra_cls);
  a.dra_cnt = static_cast<const int*>(dra_cnt);
  a.dra_first = static_cast<const unsigned char*>(dra_first);
  a.dra_claim_counts = static_cast<int*>(dra_claim_counts);
  a.dra_alloc = static_cast<int*>(dra_alloc);
  a.SK = SK;
  a.DC = DC;
  a.SP = SP;
  a.SD = SD;
  a.SC = SC;
  a.DR = DR;
  a.A = A;
  a.C = C;
  a.N = N;
  a.R = R;
  a.TK = TK;
  a.DV = DV;
  a.out_picks = static_cast<int*>(out_picks);
  const int threads = (C + 31) / 32 * 32;
  resolve_commit_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(resolve_commit)
