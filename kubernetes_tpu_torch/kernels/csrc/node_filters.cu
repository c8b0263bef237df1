// node_filters: the NodeAffinity, TaintToleration, VolumeBinding and
// VolumeZone filters for every pod of a batch against every node, once per
// batch.
//
// Replaces kubernetes_tpu/ops/nodeaffinity.py filter_fn (:285, with
// _eval_terms :162 and the profile's added affinity),
// kubernetes_tpu/ops/tainttoleration.py filter_fn (:52, with
// ops/helpers.py gather_mask :63) and kubernetes_tpu/ops/volumes.py
// _vb_filter (:146) and _vz_filter (:191) with _eval_grouped (:78), which
// the JAX pass evaluates inside every scan step.  All four read only node
// state that no commit changes (labels, names, taints), so one launch per
// batch serves all of its chunks: the result is a (K, N) byte per (pod,
// node), bit 0 the NodeAffinity filter, bit 1 TaintToleration's, bit 2
// VolumeBinding's, bit 3 VolumeZone's (1 where the batch carries no
// features of that op).  eval_chunk reads the bits as those ops' filter
// results, and spread_eval's node-inclusion policies read bits 0 and 1.
//
// The volume programs are grouped: a pod's terms belong to AND-ed
// OR-groups (one per claim or bound PV), each group needs a valid matching
// term, a group without terms fails (the term axis is padded to at least
// the group count, group ids pad with -1), and the scalar vb_/vz_feasible
// false fails every node.
//
// One thread per (pod, node), grid (ceil(N/128), K).  A pod's programs are
// read by every thread of its blocks (broadcast loads); the node's label
// and taint slots by one thread each.
//
// Bound: bytes.  It must read the nodes' label slots (N x LS x 16 bytes)
// where a pod has a selector, required terms or volume terms, their taint
// slots (N x TS x 4) where a pod has an intolerable taint, and each such
// pod's programs once, and write K x N bytes; the output dominates (33.5
// MB at K=4096, N=8192).
#include <stdint.h>

#include "common.cuh"
#include "node_program.cuh"

namespace {

constexpr int kThreads = 128;

struct NfArgs {
  // Node state.
  const int* label_key;        // (N, LS)
  const int* label_pair;       // (N, LS)
  const long long* label_int;  // (N, LS)
  const int* name_id;          // (N,)
  const int* taint_ids;        // (N, TS)
  // NodeAffinity features (null unless do_na).
  const int* sel;                      // (K, S) nodeSelector pair ids, -1 pad
  const unsigned char* has_req;        // (K,)
  const int* req_op;                   // (K, T, Q)
  const int* req_key;                  // (K, T, Q)
  const int* req_vals;                 // (K, T, Q, V)
  const long long* req_int;            // (K, T, Q)
  const unsigned char* req_valid;      // (K, T)
  const unsigned char* has_add;        // (K,)  (null unless do_add)
  const int* add_op;                   // (K, T2, Q2)
  const int* add_key;
  const int* add_vals;                 // (K, T2, Q2, V2)
  const long long* add_int;
  const unsigned char* add_valid;      // (K, T2)
  // TaintToleration features (null unless do_taint).
  const unsigned char* intol_hard;     // (K, TV)
  // VolumeBinding and VolumeZone grouped programs (null unless do_vb /
  // do_vz): op/key/int (K, T, Q), vals (K, T, Q, V), term_valid and group
  // (K, T), ngroups and feasible (K,).
  const int* vb_op;
  const int* vb_key;
  const int* vb_vals;
  const long long* vb_int;
  const unsigned char* vb_valid;
  const int* vb_group;
  const int* vb_ngroups;
  const unsigned char* vb_feasible;
  const int* vz_op;
  const int* vz_key;
  const int* vz_vals;
  const long long* vz_int;
  const unsigned char* vz_valid;
  const int* vz_group;
  const int* vz_ngroups;
  const unsigned char* vz_feasible;
  unsigned char* out;                  // (K, N)
  int N, LS, TS, K, S, T, Q, V, T2, Q2, V2, TV, Tb, Qb, Vb, Tz, Qz, Vz;
  int do_na, do_add, do_taint, do_vb, do_vz;
};

// A grouped program on one node: every group g < ngroups has a valid
// matching term (terms are visited once per group; each belongs to one).
__device__ bool grouped(const node_program::Program& p, const unsigned char* valid,
                        const int* group, int ngroups, const node_program::Node& nd) {
  for (int g = 0; g < ngroups && g < p.T; ++g) {
    bool hit = false;
    for (int t = 0; !hit && t < p.T; ++t) {
      hit = group[t] == g && valid[t] && node_program::term(p, t, nd);
    }
    if (!hit) return false;
  }
  return true;
}

__global__ void node_filters_kernel(NfArgs a) {
  const int k = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  using namespace node_program;
  const Node nd{a.label_key + (size_t)n * a.LS, a.label_pair + (size_t)n * a.LS,
                a.label_int + (size_t)n * a.LS, a.name_id[n], a.LS};
  bool na = true;
  if (a.do_na) {
    // nodeSelector: every (key, value) pair must be on the node.
    const int* sel = a.sel + (size_t)k * a.S;
    for (int s = 0; na && s < a.S; ++s) {
      const int want = sel[s];
      if (want < 0) continue;
      bool hit = false;
      for (int l = 0; l < a.LS; ++l) hit = hit || nd.pair[l] == want;
      na = hit;
    }
    if (na && a.has_req[k]) {
      const size_t tq = (size_t)k * a.T * a.Q;
      const Program p{a.req_op + tq, a.req_key + tq, a.req_vals + tq * a.V, a.req_int + tq,
                      a.T, a.Q, a.V};
      na = any_term(p, a.req_valid + (size_t)k * a.T, nd);
    }
    if (na && a.do_add && a.has_add[k]) {
      const size_t tq = (size_t)k * a.T2 * a.Q2;
      const Program p{a.add_op + tq, a.add_key + tq, a.add_vals + tq * a.V2, a.add_int + tq,
                      a.T2, a.Q2, a.V2};
      na = any_term(p, a.add_valid + (size_t)k * a.T2, nd);
    }
  }
  bool tolerated = true;
  if (a.do_taint) {
    const int* ids = a.taint_ids + (size_t)n * a.TS;
    const unsigned char* intol = a.intol_hard + (size_t)k * a.TV;
    for (int s = 0; s < a.TS; ++s) {
      const int id = ids[s];
      if (id >= 0 && id < a.TV && intol[id]) tolerated = false;
    }
  }
  bool vb = true;
  if (a.do_vb) {
    const size_t tq = (size_t)k * a.Tb * a.Qb;
    const Program p{a.vb_op + tq, a.vb_key + tq, a.vb_vals + tq * a.Vb, a.vb_int + tq,
                    a.Tb, a.Qb, a.Vb};
    vb = a.vb_feasible[k] && grouped(p, a.vb_valid + (size_t)k * a.Tb, a.vb_group + (size_t)k * a.Tb,
                                     a.vb_ngroups[k], nd);
  }
  bool vz = true;
  if (a.do_vz) {
    const size_t tq = (size_t)k * a.Tz * a.Qz;
    const Program p{a.vz_op + tq, a.vz_key + tq, a.vz_vals + tq * a.Vz, a.vz_int + tq,
                    a.Tz, a.Qz, a.Vz};
    vz = a.vz_feasible[k] && grouped(p, a.vz_valid + (size_t)k * a.Tz, a.vz_group + (size_t)k * a.Tz,
                                     a.vz_ngroups[k], nd);
  }
  a.out[(size_t)k * a.N + n] = (na ? 1 : 0) | (tolerated ? 2 : 0) | (vb ? 4 : 0) | (vz ? 8 : 0);
}

}  // namespace

extern "C" int node_filters_launch(
    const void* label_key, const void* label_pair, const void* label_int, const void* name_id,
    const void* taint_ids, const void* sel, const void* has_req, const void* req_op,
    const void* req_key, const void* req_vals, const void* req_int, const void* req_valid,
    const void* has_add, const void* add_op, const void* add_key, const void* add_vals,
    const void* add_int, const void* add_valid, const void* intol_hard, const void* vb_op,
    const void* vb_key, const void* vb_vals, const void* vb_int, const void* vb_valid,
    const void* vb_group, const void* vb_ngroups, const void* vb_feasible, const void* vz_op,
    const void* vz_key, const void* vz_vals, const void* vz_int, const void* vz_valid,
    const void* vz_group, const void* vz_ngroups, const void* vz_feasible, void* out, int N,
    int LS, int TS, int K, int S, int T, int Q, int V, int T2, int Q2, int V2, int TV, int Tb,
    int Qb, int Vb, int Tz, int Qz, int Vz, int do_na, int do_add, int do_taint, int do_vb,
    int do_vz, void* stream) {
  if (K > 65535) return (int)cudaErrorInvalidValue;
  if (K == 0 || N == 0) return 0;
  NfArgs a;
  a.label_key = static_cast<const int*>(label_key);
  a.label_pair = static_cast<const int*>(label_pair);
  a.label_int = static_cast<const long long*>(label_int);
  a.name_id = static_cast<const int*>(name_id);
  a.taint_ids = static_cast<const int*>(taint_ids);
  a.sel = static_cast<const int*>(sel);
  a.has_req = static_cast<const unsigned char*>(has_req);
  a.req_op = static_cast<const int*>(req_op);
  a.req_key = static_cast<const int*>(req_key);
  a.req_vals = static_cast<const int*>(req_vals);
  a.req_int = static_cast<const long long*>(req_int);
  a.req_valid = static_cast<const unsigned char*>(req_valid);
  a.has_add = static_cast<const unsigned char*>(has_add);
  a.add_op = static_cast<const int*>(add_op);
  a.add_key = static_cast<const int*>(add_key);
  a.add_vals = static_cast<const int*>(add_vals);
  a.add_int = static_cast<const long long*>(add_int);
  a.add_valid = static_cast<const unsigned char*>(add_valid);
  a.intol_hard = static_cast<const unsigned char*>(intol_hard);
  a.vb_op = static_cast<const int*>(vb_op);
  a.vb_key = static_cast<const int*>(vb_key);
  a.vb_vals = static_cast<const int*>(vb_vals);
  a.vb_int = static_cast<const long long*>(vb_int);
  a.vb_valid = static_cast<const unsigned char*>(vb_valid);
  a.vb_group = static_cast<const int*>(vb_group);
  a.vb_ngroups = static_cast<const int*>(vb_ngroups);
  a.vb_feasible = static_cast<const unsigned char*>(vb_feasible);
  a.vz_op = static_cast<const int*>(vz_op);
  a.vz_key = static_cast<const int*>(vz_key);
  a.vz_vals = static_cast<const int*>(vz_vals);
  a.vz_int = static_cast<const long long*>(vz_int);
  a.vz_valid = static_cast<const unsigned char*>(vz_valid);
  a.vz_group = static_cast<const int*>(vz_group);
  a.vz_ngroups = static_cast<const int*>(vz_ngroups);
  a.vz_feasible = static_cast<const unsigned char*>(vz_feasible);
  a.out = static_cast<unsigned char*>(out);
  a.N = N;
  a.LS = LS;
  a.TS = TS;
  a.K = K;
  a.S = S;
  a.T = T;
  a.Q = Q;
  a.V = V;
  a.T2 = T2;
  a.Q2 = Q2;
  a.V2 = V2;
  a.TV = TV;
  a.Tb = Tb;
  a.Qb = Qb;
  a.Vb = Vb;
  a.Tz = Tz;
  a.Qz = Qz;
  a.Vz = Vz;
  a.do_na = do_na;
  a.do_add = do_add;
  a.do_taint = do_taint;
  a.do_vb = do_vb;
  a.do_vz = do_vz;
  dim3 grid((N + kThreads - 1) / kThreads, K);
  node_filters_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(node_filters)
