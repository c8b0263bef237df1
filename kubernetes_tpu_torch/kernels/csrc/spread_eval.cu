// spread_eval: PodTopologySpread's filter, and the scores that normalize
// over the final feasible set, for C pods against N nodes.  Two entry
// points, one block per pod each:
//
// spread_filter (per chunk, before eval_chunk): replaces
// kubernetes_tpu/ops/podtopologyspread.py filter_fn (:219) with
// _per_constraint (:169), _segment_tables (:198) and ops/helpers.py
// domain_tables (:40).  Spread's filter does not read the feasible set, so
// its (C, N) result enters eval_chunk as a precomputed plane at the op's
// place in the filter order.
//   - Compact lists of the groups each DoNotSchedule constraint selects
//     (global scratch), so a node's matching-pod count is a sum over the
//     list, not a G-wide loop.
//   - A walk over the nodes: counting eligibility (node valid, every
//     constraint key present, and the NodeAffinity / TaintToleration
//     filters where the constraint honours them, read from node_filters'
//     bits); eligible counts add into a (K, DV) shared-memory table per
//     domain with a presence flag; hostname constraints (one domain per
//     node, values outside DV) take a per-node minimum and count instead.
//   - Per constraint the global minimum over present domains (MaxInt32
//     with none), forced to 0 below minDomains.
//   - A walk that gathers each node's domain count from the table (the JAX
//     op's one-hot product) and checks match + self − min ≤ maxSkew in
//     int64, with a missing key failing.
//
// late_scores (per chunk, after ipa_eval): adds, weighted, NodeAffinity's
// score (nodeaffinity.py:307: summed preferred-term weights, normalized
// over the feasible set), TaintToleration's (tainttoleration.py:56: the
// count of intolerable PreferNoSchedule taints, reverse-normalized) and
// PodTopologySpread's (podtopologyspread.py:261) into `total`, on the
// nodes the whole filter chain left feasible.  Spread's score builds the
// ScheduleAnyway constraints' (K, DV) tables as above plus the presence of
// the scored nodes (feasible with every key) per domain, whose count is
// topoSize (the scored-node count for hostname); each node's term is
// cnt·log(topoSize+2) + (maxSkew−1) in f64, summed over the constraints in
// order, rounded half up (floor(x + 0.5)), then min-max normalized.  The
// log comes from a table the wrapper builds with Python's math.log, so
// the kernel, the plain version and XLA agree bit for bit.
//
// Pinned mode of late_scores (pin_row non-null; the pinned-batch pass):
// pod c is scored on node pin_row[c] alone, over (C, 1) planes, so its
// feasible set is that node or nothing.  Spread does not score there.
//
// Numerics: counts are integers (the JAX op's f32 products are exact
// below 2^24); scores are int64 with floor division; the build passes
// -fmad=false, so the f64 multiply and add round separately as in XLA.
//
// Bound: bytes.  Per chunk they must read the constraints' valid flags
// and, only for valid constraints, their group masks (G bytes each), the
// topology values of their keys, the group_counts rows of the selected
// groups and the node_filters bits of pods with an inclusion policy; for
// late_scores also the feasible set (C x N), and the nodes' label slots
// only for preferred terms of non-zero weight and their taint slots only
// for intolerable PreferNoSchedule taints; and write the filter mask
// (C x N) or read and write `total` (C x N x 8 each way).  The tables stay
// in shared memory.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "node_program.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxInt32 = 2147483647LL;
constexpr long long kBig = 1LL << 62;
constexpr int kMaxScore = 100;

// A chunk's constraint features, (C, K) each, and their (C, K, G) masks.
struct Cons {
  const unsigned char* valid;
  const int* slot;
  const int* skew;
  const int* mindom;
  const unsigned char* self;
  const unsigned char* host;
  const unsigned char* aff;
  const unsigned char* taint;
  const unsigned char* groups;
  int K;
};

struct Cluster {
  const int* topo_vals;            // (N, TK)
  const unsigned char* valid;      // (N,)
  const int* group_counts;         // (G, N)
  const unsigned char* node_bits;  // (C, N): bit 0 NodeAffinity, bit 1 TaintToleration
  int N, TK, DV, G;
};

// Shared memory, in spread_smem_bytes' layout: K + 4 int64, then the
// (K, DV) count and presence tables, three K-long int arrays and one int.
struct Smem {
  long long* ll;  // (K,) per constraint, then (4,)
  int* tbl;       // (K, DV)
  int* pres;      // (K, DV)
  int* glen;      // (K,)
  int* minh;      // (K,)
  int* domh;      // (K,)
  int* one;       // (1,)
};

__device__ Smem carve(unsigned char* raw, int K, int DV) {
  Smem s;
  s.ll = reinterpret_cast<long long*>(raw);
  s.tbl = reinterpret_cast<int*>(s.ll + K + 4);
  s.pres = s.tbl + K * DV;
  s.glen = s.pres + K * DV;
  s.minh = s.glen + K;
  s.domh = s.minh + K;
  s.one = s.domh + K;
  return s;
}

// Zeroes the tables; minh starts at MaxInt32 (the minimum over no node).
__device__ void clear(const Smem& s, int K, int DV) {
  for (int i = threadIdx.x; i < 2 * K * DV; i += blockDim.x) s.tbl[i] = 0;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    s.glen[i] = 0;
    s.minh[i] = (int)kMaxInt32;
    s.domh[i] = 0;
  }
  if (threadIdx.x == 0) s.one[0] = 0;
}

// Compact lists of the groups each valid constraint of pod c selects.
__device__ void group_lists(const Cons& k, const Cluster& cl, int c, int* glist, int* glen) {
  for (int q = 0; q < k.K; ++q) {
    if (!k.valid[(size_t)c * k.K + q]) continue;
    const unsigned char* mask = k.groups + ((size_t)c * k.K + q) * cl.G;
    int* list = glist + ((size_t)c * k.K + q) * cl.G;
    for (int g = threadIdx.x; g < cl.G; g += blockDim.x) {
      if (mask[g]) list[atomicAdd(glen + q, 1)] = g;
    }
  }
}

// Node n's pods in the groups of one constraint's list.
__device__ __forceinline__ int count(const Cluster& cl, const int* list, int len, int n) {
  int s = 0;
  for (int i = 0; i < len; ++i) s += cl.group_counts[(size_t)list[i] * cl.N + n];
  return s;
}

// Every valid constraint's topology key is on node n.
__device__ __forceinline__ bool all_keys(const Cons& k, const Cluster& cl, int c, int n) {
  for (int q = 0; q < k.K; ++q) {
    const size_t i = (size_t)c * k.K + q;
    if (k.valid[i] && cl.topo_vals[(size_t)n * cl.TK + k.slot[i]] < 0) return false;
  }
  return true;
}

// Counting eligibility of node n for constraint q (processNode).
__device__ __forceinline__ bool eligible(const Cons& k, const Cluster& cl, int c, int q, int n,
                                         bool keys) {
  const size_t i = (size_t)c * k.K + q;
  const unsigned char bits = cl.node_bits[(size_t)c * cl.N + n];
  return cl.valid[n] && keys && (!k.aff[i] || (bits & 1)) && (!k.taint[i] || (bits & 2));
}

struct SfArgs {
  Cluster cl;
  Cons h;         // DoNotSchedule constraints (tps_h_*)
  int* glist;     // (C, K, G) scratch
  unsigned char* out;  // (C, N)
  int C;
};

__global__ void spread_filter_kernel(SfArgs a) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  const Cluster& cl = a.cl;
  const Cons& h = a.h;
  const int K = h.K, DV = cl.DV, N = cl.N;
  const int c = blockIdx.x;
  const Smem s = carve(smem_raw, K, DV);
  long long* min_match = s.ll;
  clear(s, K, DV);
  __syncthreads();
  group_lists(h, cl, c, a.glist, s.glen);
  __syncthreads();
  const int* glist = a.glist + (size_t)c * K * cl.G;
  // Domain tables over the eligible nodes.
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const bool keys = all_keys(h, cl, c, n);
    for (int q = 0; q < K; ++q) {
      const size_t i = (size_t)c * K + q;
      if (!h.valid[i] || !eligible(h, cl, c, q, n, keys)) continue;
      const int cnt = count(cl, glist + (size_t)q * cl.G, s.glen[q], n);
      if (h.host[i]) {
        atomicMin(s.minh + q, cnt);
        atomicAdd(s.domh + q, 1);
      } else {
        const int v = cl.topo_vals[(size_t)n * cl.TK + h.slot[i]];
        if (v >= 0 && v < DV) {
          atomicAdd(s.tbl + q * DV + v, cnt);
          s.pres[q * DV + v] = 1;
        }
      }
    }
  }
  __syncthreads();
  // Global minimum over the existing domains (newCriticalPaths).
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    const size_t i = (size_t)c * K + q;
    long long mn, domains;
    if (h.host[i]) {
      mn = s.minh[q];
      domains = s.domh[q];
    } else {
      mn = kMaxInt32;
      domains = 0;
      for (int d = 0; d < DV; ++d) {
        if (s.pres[q * DV + d]) {
          ++domains;
          if (s.tbl[q * DV + d] < mn) mn = s.tbl[q * DV + d];
        }
      }
    }
    min_match[q] = domains < h.mindom[i] ? 0 : mn;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool ok = true;
    bool keys = true;
    bool keys_known = false;
    for (int q = 0; ok && q < K; ++q) {
      const size_t i = (size_t)c * K + q;
      if (!h.valid[i]) continue;
      const int v = cl.topo_vals[(size_t)n * cl.TK + h.slot[i]];
      if (v < 0) {
        ok = false;
        break;
      }
      long long match;
      if (h.host[i]) {
        if (!keys_known) {
          keys = all_keys(h, cl, c, n);
          keys_known = true;
        }
        match = eligible(h, cl, c, q, n, keys) ? count(cl, glist + (size_t)q * cl.G, s.glen[q], n) : 0;
      } else {
        match = v < DV ? s.tbl[q * DV + v] : 0;
      }
      ok = match + (h.self[i] ? 1 : 0) - min_match[q] <= (long long)h.skew[i];
    }
    a.out[(size_t)c * N + n] = ok ? 1 : 0;
  }
}

struct LsArgs {
  Cluster cl;
  // Node labels and taints.
  const int* label_key;        // (N, LS)
  const int* label_pair;       // (N, LS)
  const long long* label_int;  // (N, LS)
  const int* name_id;          // (N,)
  const int* taint_ids;        // (N, TS)
  int LS, TS;
  const unsigned char* feasible;  // (C, N), or (C, 1) when pinned
  long long* total;               // (C, N), or (C, 1) when pinned
  const int* pin_row;             // (C,) pinned mode (sp_w == 0), else null
  // NodeAffinity's preferred program (null unless na_w).
  const int* pref_op;             // (C, T, Q)
  const int* pref_key;
  const int* pref_vals;           // (C, T, Q, V)
  const long long* pref_int;
  const long long* pref_weight;   // (C, T)
  int T, Q, V;
  const unsigned char* intol_pref;  // (C, TV) (null unless tt_w)
  int TV;
  Cons s;                   // ScheduleAnyway constraints (tps_s_*), K = 0 unless sp_w
  const double* log_table;  // (L,) log(k + 2)
  int L;
  int* glist;               // (C, K, G) scratch
  long long* raw;           // (3, C, N) scratch (N = 1 when pinned): NodeAffinity, taint, spread raw scores
  long long na_w, tt_w, sp_w;
  int C;
};

__global__ void late_scores_kernel(LsArgs a) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  const Cluster& cl = a.cl;
  const Cons& sc = a.s;
  const int K = sc.K, DV = cl.DV, N = cl.N;
  const int c = blockIdx.x;
  const Smem s = carve(smem_raw, K, DV);
  double* w = reinterpret_cast<double*>(s.ll);  // (K,) log(topoSize + 2)
  long long* red = s.ll + K;  // max NodeAffinity, max taint, min and max spread
  int* n_scored = s.one;
  clear(s, K, DV);
  if (threadIdx.x == 0) {
    red[0] = 0;
    red[1] = 0;
    red[2] = kBig;
    red[3] = 0;
  }
  __syncthreads();
  if (a.sp_w) group_lists(sc, cl, c, a.glist, s.glen);
  __syncthreads();
  const int* glist = a.glist + (size_t)c * K * cl.G;
  // Plane width: every node, or the pod's pinned node alone.
  const int W = a.pin_row != nullptr ? 1 : N;
  const unsigned char* feasible = a.feasible + (size_t)c * W;
  long long* raw_na = a.raw + (size_t)c * W;
  long long* raw_tt = a.raw + ((size_t)a.C + c) * W;
  long long* raw_sp = a.raw + ((size_t)2 * a.C + c) * W;
  using namespace node_program;
  const size_t tq = (size_t)c * a.T * a.Q;
  const Program pref{a.pref_op + tq, a.pref_key + tq, a.pref_vals + tq * a.V, a.pref_int + tq,
                     a.T, a.Q, a.V};
  // Raw NodeAffinity and taint scores with their feasible maxima; spread's
  // domain tables over eligible nodes and presence over scored nodes.
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int n = a.pin_row != nullptr ? a.pin_row[c] : j;
    const bool feas = feasible[j] != 0;
    if (a.na_w) {
      const Node nd{a.label_key + (size_t)n * a.LS, a.label_pair + (size_t)n * a.LS,
                    a.label_int + (size_t)n * a.LS, a.name_id[n], a.LS};
      long long r = 0;
      for (int t = 0; t < a.T; ++t) {
        const long long wt = a.pref_weight[(size_t)c * a.T + t];
        if (wt != 0 && term(pref, t, nd)) r += wt;
      }
      raw_na[j] = r;
      if (feas) atomicMax(red, r);
    }
    if (a.tt_w) {
      long long r = 0;
      const unsigned char* intol = a.intol_pref + (size_t)c * a.TV;
      for (int j = 0; j < a.TS; ++j) {
        const int id = a.taint_ids[(size_t)n * a.TS + j];
        if (id >= 0 && id < a.TV && intol[id]) ++r;
      }
      raw_tt[j] = r;
      if (feas) atomicMax(red + 1, r);
    }
    if (a.sp_w) {
      const bool keys = all_keys(sc, cl, c, n);
      const bool scored = feas && keys;
      if (scored) atomicAdd(n_scored, 1);
      for (int q = 0; q < K; ++q) {
        const size_t i = (size_t)c * K + q;
        if (!sc.valid[i] || sc.host[i]) continue;
        const int v = cl.topo_vals[(size_t)n * cl.TK + sc.slot[i]];
        if (v < 0 || v >= DV) continue;
        if (eligible(sc, cl, c, q, n, keys)) {
          atomicAdd(s.tbl + q * DV + v, count(cl, glist + (size_t)q * cl.G, s.glen[q], n));
        }
        if (scored) s.pres[q * DV + v] = 1;
      }
    }
  }
  __syncthreads();
  if (a.sp_w) {
    for (int q = threadIdx.x; q < K; q += blockDim.x) {
      int size = 0;
      if (sc.host[(size_t)c * K + q]) {
        size = *n_scored;
      } else {
        for (int d = 0; d < DV; ++d) size += s.pres[q * DV + d] ? 1 : 0;
      }
      w[q] = a.log_table[size < a.L ? size : a.L - 1];
    }
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      double acc = 0.0;
      for (int q = 0; q < K; ++q) {
        const size_t i = (size_t)c * K + q;
        if (!sc.valid[i]) continue;
        const int v = cl.topo_vals[(size_t)n * cl.TK + sc.slot[i]];
        if (v < 0) continue;  // key missing: the term is 0
        double cnt;
        if (sc.host[i]) {  // the node's own pods, no eligibility mask
          cnt = (double)count(cl, glist + (size_t)q * cl.G, s.glen[q], n);
        } else {
          cnt = v < DV ? (double)s.tbl[q * DV + v] : 0.0;
        }
        const double term_q = cnt * w[q] + ((double)sc.skew[i] - 1.0);
        acc = acc + term_q;
      }
      const long long r = (long long)floor(acc + 0.5);
      raw_sp[n] = r;
      if (feasible[n] && all_keys(sc, cl, c, n)) {
        atomicMin(red + 2, r);
        atomicMax(red + 3, r);
      }
    }
  }
  __syncthreads();
  bool any_soft = false;
  for (int q = 0; q < K; ++q) any_soft = any_soft || sc.valid[(size_t)c * K + q];
  const long long max_na = red[0], max_tt = red[1];
  const long long sp_min = *n_scored > 0 ? red[2] : 0, sp_max = red[3];
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int n = a.pin_row != nullptr ? a.pin_row[c] : j;
    long long* tot = a.total + (size_t)c * W + j;
    if (!feasible[j]) {
      *tot = 0;
      continue;
    }
    long long add = 0;
    if (a.na_w) {
      const long long sc_na = max_na == 0 ? 0
          : floordiv_i64(raw_na[j] * kMaxScore, max_na > 1 ? max_na : 1);
      add += sc_na * a.na_w;
    }
    if (a.tt_w) {
      const long long sc_tt = max_tt == 0 ? kMaxScore
          : kMaxScore - floordiv_i64(raw_tt[j] * kMaxScore, max_tt > 1 ? max_tt : 1);
      add += sc_tt * a.tt_w;
    }
    if (a.sp_w && any_soft && all_keys(sc, cl, c, n)) {
      const long long sc_sp = sp_max == 0 ? kMaxScore
          : floordiv_i64(kMaxScore * (sp_max + sp_min - raw_sp[j]), sp_max > 1 ? sp_max : 1);
      add += sc_sp * a.sp_w;
    }
    *tot += add;
  }
}

Cons make_cons(const void* valid, const void* slot, const void* skew, const void* mindom,
               const void* self, const void* host, const void* aff, const void* taint,
               const void* groups, int K) {
  Cons k;
  k.valid = static_cast<const unsigned char*>(valid);
  k.slot = static_cast<const int*>(slot);
  k.skew = static_cast<const int*>(skew);
  k.mindom = static_cast<const int*>(mindom);
  k.self = static_cast<const unsigned char*>(self);
  k.host = static_cast<const unsigned char*>(host);
  k.aff = static_cast<const unsigned char*>(aff);
  k.taint = static_cast<const unsigned char*>(taint);
  k.groups = static_cast<const unsigned char*>(groups);
  k.K = K;
  return k;
}

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" int spread_filter_launch(
    const void* topo_vals, const void* valid, const void* group_counts, const void* node_bits,
    const void* h_valid, const void* h_slot, const void* h_skew, const void* h_mindom,
    const void* h_self, const void* h_host, const void* h_aff, const void* h_taint,
    const void* h_groups, void* glist, void* out, int C, int N, int TK, int DV, int G, int K,
    int smem_bytes, void* stream) {
  if (C == 0 || N == 0) return 0;
  SfArgs a;
  a.cl.topo_vals = static_cast<const int*>(topo_vals);
  a.cl.valid = static_cast<const unsigned char*>(valid);
  a.cl.group_counts = static_cast<const int*>(group_counts);
  a.cl.node_bits = static_cast<const unsigned char*>(node_bits);
  a.cl.N = N;
  a.cl.TK = TK;
  a.cl.DV = DV;
  a.cl.G = G;
  a.h = make_cons(h_valid, h_slot, h_skew, h_mindom, h_self, h_host, h_aff, h_taint, h_groups, K);
  a.glist = static_cast<int*>(glist);
  a.out = static_cast<unsigned char*>(out);
  a.C = C;
  const int rc = prepare(spread_filter_kernel, smem_bytes);
  if (rc != 0) return rc;
  spread_filter_kernel<<<C, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int late_scores_launch(
    const void* label_key, const void* label_pair, const void* label_int, const void* name_id,
    const void* taint_ids, const void* topo_vals, const void* valid, const void* group_counts,
    const void* node_bits, const void* feasible, void* total, const void* pin_row,
    const void* pref_op,
    const void* pref_key, const void* pref_vals, const void* pref_int, const void* pref_weight,
    const void* intol_pref, const void* s_valid, const void* s_slot, const void* s_skew,
    const void* s_mindom, const void* s_self, const void* s_host, const void* s_aff,
    const void* s_taint, const void* s_groups, const void* log_table, void* glist, void* raw,
    int C, int N, int LS, int TS, int TK, int DV, int G, int T, int Q, int V, int TV, int K,
    int L, long long na_w, long long tt_w, long long sp_w, int smem_bytes, void* stream) {
  if (C == 0 || N == 0) return 0;
  LsArgs a;
  a.cl.topo_vals = static_cast<const int*>(topo_vals);
  a.cl.valid = static_cast<const unsigned char*>(valid);
  a.cl.group_counts = static_cast<const int*>(group_counts);
  a.cl.node_bits = static_cast<const unsigned char*>(node_bits);
  a.cl.N = N;
  a.cl.TK = TK;
  a.cl.DV = DV;
  a.cl.G = G;
  a.label_key = static_cast<const int*>(label_key);
  a.label_pair = static_cast<const int*>(label_pair);
  a.label_int = static_cast<const long long*>(label_int);
  a.name_id = static_cast<const int*>(name_id);
  a.taint_ids = static_cast<const int*>(taint_ids);
  a.LS = LS;
  a.TS = TS;
  a.feasible = static_cast<const unsigned char*>(feasible);
  a.total = static_cast<long long*>(total);
  a.pin_row = static_cast<const int*>(pin_row);
  if (a.pin_row != nullptr && sp_w != 0) return (int)cudaErrorInvalidValue;
  a.pref_op = static_cast<const int*>(pref_op);
  a.pref_key = static_cast<const int*>(pref_key);
  a.pref_vals = static_cast<const int*>(pref_vals);
  a.pref_int = static_cast<const long long*>(pref_int);
  a.pref_weight = static_cast<const long long*>(pref_weight);
  a.T = T;
  a.Q = Q;
  a.V = V;
  a.intol_pref = static_cast<const unsigned char*>(intol_pref);
  a.TV = TV;
  a.s = make_cons(s_valid, s_slot, s_skew, s_mindom, s_self, s_host, s_aff, s_taint, s_groups, K);
  a.log_table = static_cast<const double*>(log_table);
  a.L = L;
  a.glist = static_cast<int*>(glist);
  a.raw = static_cast<long long*>(raw);
  a.na_w = na_w;
  a.tt_w = tt_w;
  a.sp_w = sp_w;
  a.C = C;
  const int rc = prepare(late_scores_kernel, smem_bytes);
  if (rc != 0) return rc;
  late_scores_kernel<<<C, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(spread_eval)
