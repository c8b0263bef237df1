// NodeAffinity requirement programs, evaluated on one node (shared by
// node_filters.cu and spread_eval.cu).
//
// The counterpart of kubernetes_tpu/ops/nodeaffinity.py _eval_terms (:162)
// for one (pod, node): a program is (T, Q) opcodes, key ids and integer
// operands and (T, Q, V) value ids (label-pair ids for In/NotIn, node-name
// ids for the metadata.name ops, -1 pads); a term is the AND of its Q
// requirements.  The JAX op broadcasts every requirement against every
// label slot as a (T, Q, N, LS) tensor; here a requirement reads only what
// its operator needs: In/NotIn the pair slots for each value, Exists/
// DoesNotExist the key slots, Gt/Lt the key slots and the integer of the
// slot holding the key; the name operators compare the node-name id and
// touch no slot.  A node is read through a view: Node walks its slots in
// global memory, RegNode holds them in registers (below).
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

// One node's label slots in global memory, read slot by slot (the
// pinned launch, spread_eval's scores, and label slot counts node_filters'
// tiles have no instantiation for).
struct Node {
  const int* key;        // (LS,) label key ids, -1 pad
  const int* pair;       // (LS,) label pair ids, -1 pad
  const long long* num;  // (LS,) integer values or kIntSentinel
  int name;              // node-name id
  int LS;
  // Some slot holds pair id w.
  __device__ __forceinline__ bool has_pair(int w) const {
    for (int l = 0; l < LS; ++l) {
      if (pair[l] == w) return true;
    }
    return false;
  }
  // Whether a slot holds key k: 0 no, 1 yes, -1 walk to see (key_sum).
  __device__ __forceinline__ int has_key(int) const { return -1; }
  // Whether a slot holds key k, and (with ``ints``) the int64 sum of the
  // integers of the slots holding it (one slot at most; wrap-around as in
  // the JAX sum).
  __device__ __forceinline__ bool key_sum(int k, bool ints, unsigned long long& sum) const {
    bool has = false;
    sum = 0;
    for (int l = 0; l < LS; ++l) {
      if (key[l] == k) {
        has = true;
        if (ints) sum += (unsigned long long)num[l];
      }
    }
    return has;
  }
};

// A node's label keys and pairs in registers (node_filters' tiles: one
// thread a node, every pod of the tile on it): kLS slots compared without
// a branch, and the set of its key ids below 128, which answers
// Exists/DoesNotExist and rules a key out without looking at the slots.
// The integers stay in global memory (Gt/Lt read the slot holding the
// key).  The answers are Node's.
template <int kLS>
struct RegNode {
  int key_[kLS];
  int pair_[kLS];
  const long long* num_;
  int name;
  unsigned long long kb0, kb1;  // key ids 0-127 present
  bool keys_exact;              // no slot key above 127
  __device__ __forceinline__ void load(const int* keys, const int* pairs) {
#pragma unroll
    for (int j = 0; j < kLS / 4; ++j) {
      const int4 k = reinterpret_cast<const int4*>(keys)[j];
      const int4 w = reinterpret_cast<const int4*>(pairs)[j];
      key_[4 * j] = k.x;
      key_[4 * j + 1] = k.y;
      key_[4 * j + 2] = k.z;
      key_[4 * j + 3] = k.w;
      pair_[4 * j] = w.x;
      pair_[4 * j + 1] = w.y;
      pair_[4 * j + 2] = w.z;
      pair_[4 * j + 3] = w.w;
    }
    kb0 = kb1 = 0;
    keys_exact = true;
#pragma unroll
    for (int l = 0; l < kLS; ++l) {
      const int k = key_[l];
      keys_exact = keys_exact && k < 128;
      if (k >= 0) (k & 64 ? kb1 : kb0) |= 1ULL << (k & 63);
    }
  }
  __device__ __forceinline__ bool has_pair(int w) const {
    bool any = false;
#pragma unroll
    for (int l = 0; l < kLS; ++l) any |= pair_[l] == w;
    return any;
  }
  __device__ __forceinline__ int has_key(int k) const {
    if (k < 0 || k >= 128) return -1;
    if (!(((k & 64 ? kb1 : kb0) >> (k & 63)) & 1ULL)) return 0;
    return keys_exact ? 1 : -1;
  }
  __device__ __forceinline__ bool key_sum(int k, bool ints, unsigned long long& sum) const {
    bool has = false;
    sum = 0;
#pragma unroll
    for (int l = 0; l < kLS; ++l) {
      if (key_[l] == k) {
        has = true;
        if (ints) sum += (unsigned long long)num_[l];
      }
    }
    return has;
  }
};

// One pod's program: pointers at the pod's (T, Q[, V]) rows.
struct Program {
  const int* op;          // (T, Q)
  const int* key;         // (T, Q)
  const int* vals;        // (T, Q, V)
  const long long* num;   // (T, Q)
  int T, Q, V;
};

template <class Nd>
__device__ __forceinline__ bool requirement(const Program& p, int t, int q, const Nd& nd) {
  const int i = t * p.Q + q;
  const int op = p.op[i];
  if (op == kOpFalse) return false;
  if (op < kOpIn || op > kOpNameNotIn) return true;  // pad
  const int* vals = p.vals + (size_t)i * p.V;
  if (op >= kOpNameIn) {
    bool any = false;
    for (int v = 0; v < p.V; ++v) any = any || (vals[v] >= 0 && vals[v] == nd.name);
    return (op == kOpNameIn) == any;
  }
  if (op <= kOpNotIn) {  // any slot's pair among the values
    bool any = false;
    for (int v = 0; !any && v < p.V; ++v) any = vals[v] >= 0 && nd.has_pair(vals[v]);
    return (op == kOpIn) == any;
  }
  // has_key, and for Gt/Lt the key's integer value.
  const int key = p.key[i];
  const bool ints = op >= kOpGt;
  const int known = nd.has_key(key);
  if (known == 0) return op == kOpNotExists;
  if (known == 1 && !ints) return op == kOpExists;
  unsigned long long sum;
  const bool has_key = nd.key_sum(key, ints, sum);
  if (!ints) return (op == kOpExists) == has_key;
  const long long label_int = (long long)sum;
  if (!has_key || label_int == kIntSentinel) return false;
  return op == kOpGt ? label_int > p.num[i] : label_int < p.num[i];
}

// Term t matches the node: the AND of its requirements.
template <class Nd>
__device__ __forceinline__ bool term(const Program& p, int t, const Nd& nd) {
  for (int q = 0; q < p.Q; ++q) {
    if (!requirement(p, t, q, nd)) return false;
  }
  return true;
}

// Any valid term matches (the OR of a required node selector's terms).
template <class Nd>
__device__ __forceinline__ bool any_term(const Program& p, const unsigned char* term_valid, const Nd& nd) {
  for (int t = 0; t < p.T; ++t) {
    if (term_valid[t] && term(p, t, nd)) return true;
  }
  return false;
}

// Groups a grouped program's mask word holds.
constexpr int kGroupWord = 64;

// A grouped program (ops/volumes.py _eval_grouped :78): every group g <
// min(ngroups, T) has a valid matching term; terms of group -1 or of a
// group at or past that bound count for nothing.  Each valid term is
// evaluated at most once: its hit is OR-ed into a mask of kGroupWord
// groups, a window of groups at a time, and a term whose group is already
// hit is skipped.  ngroups <= 0 passes.
template <class Nd>
__device__ __forceinline__ bool grouped(const Program& p, const unsigned char* valid, const int* group,
                                        int ngroups, const Nd& nd) {
  const int G = min(ngroups, p.T);
  for (int g0 = 0; g0 < G; g0 += kGroupWord) {
    const int width = min(kGroupWord, G - g0);
    const unsigned long long need = width == kGroupWord ? ~0ULL : (1ULL << width) - 1ULL;
    unsigned long long hit = 0;
    for (int t = 0; t < p.T && hit != need; ++t) {
      const int g = group[t] - g0;
      if (g < 0 || g >= width || !valid[t]) continue;
      const unsigned long long bit = 1ULL << g;
      if ((hit & bit) == 0 && term(p, t, nd)) hit |= bit;
    }
    if (hit != need) return false;
  }
  return true;
}

}  // namespace node_program
