// node_filters: NodeAffinity's and TaintToleration's filters for every pod
// of a batch against every node, once per batch.
//
// Replaces kubernetes_tpu/ops/nodeaffinity.py filter_fn (:285, with
// _eval_terms :162 and the profile's added affinity) and
// kubernetes_tpu/ops/tainttoleration.py filter_fn (:52, with
// ops/helpers.py gather_mask :63), which the JAX pass evaluates inside every
// scan step.  Both read only node state that no commit changes (labels,
// names, taints), so one launch per batch serves all of its chunks: the
// result is a (K, N) byte per (pod, node), bit 0 the NodeAffinity filter,
// bit 1 the TaintToleration filter (1 where the batch carries no features
// of that op).  eval_chunk reads the bits as those ops' filter results, and
// spread_eval's node-inclusion policies read them too.
//
// One thread per (pod, node), grid (ceil(N/128), K).  A pod's programs are
// read by every thread of its blocks (broadcast loads); the node's label
// and taint slots by one thread each.
//
// Bound: bytes.  It must read the nodes' label slots (N x LS x 16 bytes)
// where a pod has a selector or required terms, their taint slots (N x TS
// x 4) where a pod has an intolerable taint, and each such pod's programs
// once, and write K x N bytes; the output dominates (33.5 MB at K=4096,
// N=8192).
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
  unsigned char* out;                  // (K, N)
  int N, LS, TS, K, S, T, Q, V, T2, Q2, V2, TV;
  int do_na, do_add, do_taint;
};

__global__ void node_filters_kernel(NfArgs a) {
  const int k = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  using namespace node_program;
  bool na = true;
  if (a.do_na) {
    const Node nd{a.label_key + (size_t)n * a.LS, a.label_pair + (size_t)n * a.LS,
                  a.label_int + (size_t)n * a.LS, a.name_id[n], a.LS};
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
  a.out[(size_t)k * a.N + n] = (na ? 1 : 0) | (tolerated ? 2 : 0);
}

}  // namespace

extern "C" int node_filters_launch(
    const void* label_key, const void* label_pair, const void* label_int, const void* name_id,
    const void* taint_ids, const void* sel, const void* has_req, const void* req_op,
    const void* req_key, const void* req_vals, const void* req_int, const void* req_valid,
    const void* has_add, const void* add_op, const void* add_key, const void* add_vals,
    const void* add_int, const void* add_valid, const void* intol_hard, void* out, int N,
    int LS, int TS, int K, int S, int T, int Q, int V, int T2, int Q2, int V2, int TV,
    int do_na, int do_add, int do_taint, void* stream) {
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
  a.do_na = do_na;
  a.do_add = do_add;
  a.do_taint = do_taint;
  dim3 grid((N + kThreads - 1) / kThreads, K);
  node_filters_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(node_filters)
