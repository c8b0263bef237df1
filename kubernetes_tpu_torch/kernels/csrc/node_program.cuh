// NodeAffinity requirement programs, evaluated on one node (shared by
// node_filters.cu and spread_eval.cu).
//
// The counterpart of kubernetes_tpu/ops/nodeaffinity.py _eval_terms (:162)
// for one (pod, node): a program is (T, Q) opcodes, key ids and integer
// operands and (T, Q, V) value ids (label-pair ids for In/NotIn, node-name
// ids for the metadata.name ops, -1 pads); a term is the AND of its Q
// requirements.  The JAX op broadcasts every requirement against every
// label slot as a (T, Q, N, LS) tensor; here one thread walks the node's LS
// slots per requirement.
#pragma once

namespace node_program {

constexpr int kOpPad = -1;
constexpr int kOpIn = 0;
constexpr int kOpNotIn = 1;
constexpr int kOpExists = 2;
constexpr int kOpNotExists = 3;
constexpr int kOpGt = 4;
constexpr int kOpLt = 5;
constexpr int kOpNameIn = 6;
constexpr int kOpNameNotIn = 7;
constexpr int kOpFalse = 8;
// snapshot.INT_SENTINEL: the label value is not an integer.
constexpr long long kIntSentinel = -(1LL << 62);

// One node's label slots.
struct Node {
  const int* key;        // (LS,) label key ids, -1 pad
  const int* pair;       // (LS,) label pair ids, -1 pad
  const long long* num;  // (LS,) integer values or kIntSentinel
  int name;              // node-name id
  int LS;
};

// One pod's program: pointers at the pod's (T, Q[, V]) rows.
struct Program {
  const int* op;          // (T, Q)
  const int* key;         // (T, Q)
  const int* vals;        // (T, Q, V)
  const long long* num;   // (T, Q)
  int T, Q, V;
};

__device__ __forceinline__ bool requirement(const Program& p, int t, int q, const Node& nd) {
  const int i = t * p.Q + q;
  const int op = p.op[i];
  if (op == kOpFalse) return false;
  if (op < kOpIn || op > kOpNameNotIn) return true;  // pad
  const int key = p.key[i];
  // has_key, and the key's integer value: the masked sum over the slots
  // holding the key (one slot at most; int64 wrap-around as in the JAX sum).
  bool has_key = false;
  unsigned long long sum = 0;
  for (int l = 0; l < nd.LS; ++l) {
    if (nd.key[l] == key) {
      has_key = true;
      sum += (unsigned long long)nd.num[l];
    }
  }
  const long long label_int = (long long)sum;
  bool pair_any = false, name_any = false;
  const int* vals = p.vals + (size_t)i * p.V;
  for (int v = 0; v < p.V; ++v) {
    const int w = vals[v];
    if (w < 0) continue;
    if (nd.name == w) name_any = true;
    for (int l = 0; l < nd.LS; ++l) {
      if (nd.pair[l] == w) pair_any = true;
    }
  }
  const bool int_ok = has_key && label_int != kIntSentinel;
  switch (op) {
    case kOpIn: return pair_any;
    case kOpNotIn: return !pair_any;
    case kOpExists: return has_key;
    case kOpNotExists: return !has_key;
    case kOpGt: return int_ok && label_int > p.num[i];
    case kOpLt: return int_ok && label_int < p.num[i];
    case kOpNameIn: return name_any;
    default: return !name_any;  // kOpNameNotIn
  }
}

// Term t matches the node: the AND of its requirements.
__device__ __forceinline__ bool term(const Program& p, int t, const Node& nd) {
  for (int q = 0; q < p.Q; ++q) {
    if (!requirement(p, t, q, nd)) return false;
  }
  return true;
}

// Any valid term matches (the OR of a required node selector's terms).
__device__ __forceinline__ bool any_term(const Program& p, const unsigned char* term_valid,
                                         const Node& nd) {
  for (int t = 0; t < p.T; ++t) {
    if (term_valid[t] && term(p, t, nd)) return true;
  }
  return false;
}

}  // namespace node_program
