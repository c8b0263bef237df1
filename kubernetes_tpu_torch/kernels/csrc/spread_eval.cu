// spread_eval: PodTopologySpread's filter, and the scores that normalize
// over the final feasible set, for C pods against N nodes.  Two entry
// points:
//
// spread_filter (per chunk, before eval_chunk): replaces
// kubernetes_tpu/ops/podtopologyspread.py filter_fn (:219) with
// _per_constraint (:169), _segment_tables (:198) and ops/helpers.py
// domain_tables (:40).  Spread's filter does not read the feasible set, so
// its (C, N) result enters eval_chunk as a precomputed plane at the op's
// place in the filter order.  Per pod: counting eligibility of each node
// (node valid, every constraint key present, and the NodeAffinity /
// TaintToleration filters where the constraint honours them, read from
// node_filters' bits); the eligible nodes' matching-pod counts summed per
// domain into a (Q, DV) table with a presence flag (Q constraints);
// hostname constraints (one domain per node, values outside DV) take a
// per-node minimum and count instead; per constraint the global minimum
// over present domains (MaxInt32 with none), forced to 0 below
// minDomains; then each node's domain count gathered from the table (the
// JAX op's one-hot product) and checked: match + self - min <= maxSkew in
// int64, a missing key failing.
//
// late_scores (per chunk, after ipa_eval): adds, weighted, NodeAffinity's
// score (nodeaffinity.py:307: summed preferred-term weights, normalized
// over the feasible set), TaintToleration's (tainttoleration.py:56: the
// count of intolerable PreferNoSchedule taints, reverse-normalized) and
// PodTopologySpread's (podtopologyspread.py:261) into `total`, on the
// nodes the whole filter chain left feasible.  Spread's score builds the
// ScheduleAnyway constraints' (Q, DV) tables as above plus the presence of
// the scored nodes (feasible with every key) per domain, whose count is
// topoSize (the scored-node count for hostname); each node's term is
// cnt·log(topoSize+2) + (maxSkew−1) in f64, summed over the constraints in
// order, rounded half up (floor(x + 0.5)), then min-max normalized.  The
// log comes from a table the wrapper builds with Python's math.log, so
// the kernel, the plain version and XLA agree bit for bit.
//
// One pod over a thread block cluster of K CTAs (K from the host's
// cluster_split: a chunk-1 step at N=8192 runs on 16 SMs instead of one;
// K = 1 is one CTA a pod, a plain launch).  CTA r walks the node slice
// [r*S, (r+1)*S), S = ceil(N/K) rounded up to 32:
//   - The pod's constraint flags are staged in shared memory, and each
//     valid constraint's compact list of selected groups is built from its
//     G-byte mask by a block scan (ascending, no atomics), in the CTA's
//     row of a device scratch (a warp reads one entry at a time, the same
//     in every lane: an L1 hit after the first).  A node's matching-pod
//     count is a sum over the list.
//   - The first walk over the slice builds partial (Q, DV) count and
//     presence tables in the CTA's shared memory: a warp groups its lanes
//     by domain value (__match_any_sync), sums each group's counts
//     (__reduce_add_sync) and one lane a group adds into the table, so a
//     table entry takes one shared atomic a warp and distinct value, not
//     one a node.  Hostname minima and counts, and late_scores' scored-node
//     count, are reduced per warp and kept per warp.
//   - After cluster.sync every CTA sums the K partial tables over
//     distributed shared memory (integer counts: the order of the sum does
//     not matter) and derives the per-constraint minimum and domain count
//     (spread_filter) or topoSize and its log weight (late_scores).
//   - The second walk over the slice writes the filter's verdict, or
//     late_scores' raw spread score in the constraints' order.
//   - late_scores' four reductions (max NodeAffinity, max taint, min and
//     max spread over the scored nodes) are reduced per warp by shuffles,
//     over the block, then in one exchange over the cluster; the last walk
//     over the slice normalizes.  No global atomics; a CTA does not exit
//     before its peers have read its shared memory.
//
// Pinned mode of late_scores (pin_row non-null; the pinned-batch pass):
// pod c is scored on node pin_row[c] alone, over (C, 1) planes, so its
// feasible set is that node or nothing (one CTA a pod).  Spread does not
// score there.
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

#include <cooperative_groups.h>

#include "common.cuh"
#include "node_program.cuh"

namespace cg = cooperative_groups;

namespace {

// Threads a CTA: 512 where its slice has 512 rows or more, else 256 (the
// launcher's choice; the H100's 8192-row chunk-1 slices gain from one row a
// thread, 1024-row ones lose to the larger block's barriers), 32 pinned.
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxInt32 = 2147483647;
constexpr long long kBig = 1LL << 62;
constexpr int kMaxScore = 100;
constexpr unsigned kFull = 0xffffffffu;

// A chunk's constraint features, (C, Q) each, and their (C, Q, G) masks.
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
  int Q;
};

struct Cluster {
  const int* topo_vals;            // (N, TK)
  const unsigned char* valid;      // (N,)
  const int* group_counts;         // (G, N)
  const unsigned char* node_bits;  // (C, N): bit 0 NodeAffinity, bit 1 TaintToleration
  int N, TK, DV, G;
};

// One pod's constraint flags, staged in shared memory.
struct Flags {
  int *valid, *slot, *skew, *mindom, *self, *host, *aff, *taint;
};

// Dynamic shared memory: Q int64 (the filter's minima or the score's log
// weights), the staged flags (8 x Q int32), this CTA's partial tables, with
// K > 1 the cluster's summed tables, the list lengths (Q) and the per-warp
// hostname minima and counts (2 x kMaxWarps x Q); smem_len bytes, which
// the launchers require the host's kernels.spread_smem to give.  The
// partial tables: counts (Q, DV), presence (Q, DV), hostname minima (Q)
// and counts (Q), the scored-node count (1).
struct Smem {
  long long* ll;
  Flags f;
  int* part;
  int* fin;
  int* glen;
  int* wmin;  // (warps, Q)
  int* wcnt;  // (warps, Q)
};

__host__ __device__ __forceinline__ int part_len(int Q, int DV) { return 2 * Q * DV + 2 * Q + 1; }

__host__ __device__ __forceinline__ int smem_len(int Q, int DV, int ncta) {
  return 8 * Q + 4 * (8 * Q + part_len(Q, DV) * (ncta > 1 ? 2 : 1) + Q + 2 * kMaxWarps * Q);
}

__device__ Smem carve(unsigned char* raw, int Q, int DV, int ncta) {
  Smem s;
  s.ll = reinterpret_cast<long long*>(raw);
  int* p = reinterpret_cast<int*>(s.ll + Q);
  s.f = Flags{p, p + Q, p + 2 * Q, p + 3 * Q, p + 4 * Q, p + 5 * Q, p + 6 * Q, p + 7 * Q};
  p += 8 * Q;
  const int P = part_len(Q, DV);
  s.part = p;
  p += P;
  s.fin = ncta > 1 ? p : s.part;
  if (ncta > 1) p += P;
  s.glen = p;
  p += Q;
  s.wmin = p;
  p += kMaxWarps * Q;
  s.wcnt = p;
  return s;
}

// Table sections of the partial and summed tables.
struct Tables {
  int *tbl, *pres, *minh, *domh, *nsc;
};

__device__ __forceinline__ Tables tables(int* base, int Q, int DV) {
  return Tables{base, base + Q * DV, base + 2 * Q * DV, base + 2 * Q * DV + Q, base + 2 * Q * DV + 2 * Q};
}

// Stages pod c's flags, zeroes the partial tables (hostname minima at
// MaxInt32, the minimum over no node) and the per-warp hostname values.
__device__ void stage(const Smem& s, const Cons& k, int c, int DV) {
  const int Q = k.Q;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const size_t i = (size_t)c * Q + q;
    s.f.valid[q] = k.valid[i];
    s.f.slot[q] = k.slot[i];
    s.f.skew[q] = k.skew[i];
    s.f.mindom[q] = k.mindom[i];
    s.f.self[q] = k.self[i];
    s.f.host[q] = k.host[i];
    s.f.aff[q] = k.aff[i];
    s.f.taint[q] = k.taint[i];
  }
  for (int i = threadIdx.x; i < part_len(Q, DV); i += blockDim.x) {
    s.part[i] = (i >= 2 * Q * DV && i < 2 * Q * DV + Q) ? kMaxInt32 : 0;
  }
  for (int i = threadIdx.x; i < kMaxWarps * Q; i += blockDim.x) {
    s.wmin[i] = kMaxInt32;
    s.wcnt[i] = 0;
  }
}

// The compact list of the groups each valid constraint of pod c selects,
// ascending, by a block scan of its G-byte mask: thread t counts the set
// bytes of its run [t*run, (t+1)*run), the block's exclusive scan of the
// counts gives where its groups go.  ``lists`` is (Q, G).  It reads the
// valid flags from device memory, so it needs no barrier after stage().
__device__ void group_lists(const Cons& k, int G, int c, int* lists, int* glen, int* scan) {
  const int run = (G + blockDim.x - 1) / blockDim.x;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = min(G, (int)threadIdx.x * run), g1 = min(G, g0 + run);
  for (int q = 0; q < k.Q; ++q) {
    if (!k.valid[(size_t)c * k.Q + q]) {
      if (threadIdx.x == 0) glen[q] = 0;
      continue;
    }
    const unsigned char* mask = k.groups + ((size_t)c * k.Q + q) * G;
    int cnt = 0;
    for (int g = g0; g < g1; ++g) cnt += mask[g] != 0;
    int x = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) scan[warp] = x;
    __syncthreads();
    int at = x - cnt, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int v = scan[w];
      if (w < warp) at += v;
      total += v;
    }
    int* list = lists + (size_t)q * G;
    for (int g = g0; g < g1; ++g) {
      if (mask[g]) list[at++] = g;
    }
    if (threadIdx.x == 0) glen[q] = total;
    __syncthreads();  // scan[] is the next constraint's
  }
}

// Node n's pods in the groups of one constraint's list; four loads in
// flight at a time.
__device__ __forceinline__ int count(const Cluster& cl, const int* list, int len, int n) {
  int s = 0, i = 0;
  for (; i + 4 <= len; i += 4) {
    s += cl.group_counts[(size_t)list[i] * cl.N + n] + cl.group_counts[(size_t)list[i + 1] * cl.N + n] +
         cl.group_counts[(size_t)list[i + 2] * cl.N + n] + cl.group_counts[(size_t)list[i + 3] * cl.N + n];
  }
  for (; i < len; ++i) s += cl.group_counts[(size_t)list[i] * cl.N + n];
  return s;
}

// Every valid constraint's topology key is on node n.
__device__ __forceinline__ bool all_keys(const Flags& f, int Q, const Cluster& cl, int n) {
  for (int q = 0; q < Q; ++q) {
    if (f.valid[q] && cl.topo_vals[(size_t)n * cl.TK + f.slot[q]] < 0) return false;
  }
  return true;
}

// Counting eligibility of a node for constraint q (processNode), given its
// validity, whether it has every key and its node_filters bits.
__device__ __forceinline__ bool eligible(const Flags& f, int q, bool valid, bool keys, unsigned char bits) {
  return valid && keys && (!f.aff[q] || (bits & 1)) && (!f.taint[q] || (bits & 2));
}

// Adds ``cnt`` into tbl[key] for the lanes of a warp with key >= 0: the
// lanes with one key are summed and their lowest lane adds (and sets the
// presence flag, when ``pres`` is given).  Every lane of the warp calls it.
__device__ __forceinline__ void warp_add(int* tbl, int* pres, int key, int cnt) {
  const unsigned peers = __match_any_sync(kFull, key);
  const int sum = __reduce_add_sync(peers, cnt);
  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(tbl + key, sum);
    if (pres != nullptr) pres[key] = 1;
  }
}

// Arrive without ordering earlier memory operations: only to say that this
// CTA's reads of its peers' shared memory, whose values it has already used,
// are done.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The K partial tables summed into this CTA's ``fin`` (hostname minima by
// minimum), after the cluster barrier; with K = 1 a block barrier.  A
// thread's K remote loads of an entry are independent, so they are in
// flight together.
__device__ void sum_tables(cg::cluster_group& cluster, const Smem& s, int Q, int DV, int ncta) {
  if (ncta == 1) {
    __syncthreads();
    return;
  }
  cluster.sync();
  const int P = part_len(Q, DV);
  const int m0 = 2 * Q * DV, m1 = m0 + Q;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const bool is_min = i >= m0 && i < m1;
    int acc = is_min ? kMaxInt32 : 0;
    for (int r = 0; r < ncta; ++r) {
      const int v = cluster.map_shared_rank(s.part, r)[i];
      acc = is_min ? min(acc, v) : acc + v;
    }
    s.fin[i] = acc;
  }
  __syncthreads();
}

// Rows of a CTA's slice of an N-row axis over K CTAs: ceil(N/K) rounded
// up to 32.
__host__ __device__ __forceinline__ int slice_rows(int N, int K) {
  return (((N + K - 1) / K + 31) / 32) * 32;
}

// The CTA's node slice [n0, n1).
__device__ __forceinline__ void slice(int N, int ncta, int rank, int* n0, int* n1) {
  const int size = slice_rows(N, ncta);
  *n0 = min(N, rank * size);
  *n1 = min(N, *n0 + size);
}

struct SfArgs {
  Cluster cl;
  Cons h;              // DoNotSchedule constraints (tps_h_*)
  int* glist;          // (C * K, Q, G) scratch: a CTA's group lists
  unsigned char* out;  // (C, N)
  int C;
};

__global__ void __launch_bounds__(kMaxThreads) spread_filter_kernel(SfArgs a) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  __shared__ int s_scan[kMaxWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Cluster& cl = a.cl;
  const Cons& h = a.h;
  const int Q = h.Q, DV = cl.DV, N = cl.N;
  const int c = blockIdx.x / ncta;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const Smem s = carve(smem_raw, Q, DV, ncta);
  const Flags& f = s.f;
  int* lists = a.glist + (size_t)blockIdx.x * Q * cl.G;
  long long* min_match = s.ll;
  int n0, n1;
  slice(N, ncta, rank, &n0, &n1);
  stage(s, h, c, DV);
  group_lists(h, cl.G, c, lists, s.glen, s_scan);
  __syncthreads();
  const Tables pt = tables(s.part, Q, DV);
  // Partial domain tables over the slice's eligible nodes, a warp's lanes
  // on 32 consecutive rows.
  for (int base = n0 + warp * 32; base < n1; base += nthr) {
    const int n = base + lane;
    const bool in = n < n1;
    const bool keys = in && all_keys(f, Q, cl, n);
    const bool nvalid = in && cl.valid[n] != 0;
    const unsigned char bits = in ? cl.node_bits[(size_t)c * N + n] : 0;
    for (int q = 0; q < Q; ++q) {
      if (!f.valid[q]) continue;
      const bool el = eligible(f, q, nvalid, keys, bits);
      const int cnt = el ? count(cl, lists + (size_t)q * cl.G, s.glen[q], n) : 0;
      if (f.host[q]) {
        const int m = __reduce_min_sync(kFull, el ? cnt : kMaxInt32);
        const unsigned d = __ballot_sync(kFull, el);
        if (lane == 0) {
          s.wmin[warp * Q + q] = min(s.wmin[warp * Q + q], m);
          s.wcnt[warp * Q + q] += __popc(d);
        }
      } else {
        const int v = in ? cl.topo_vals[(size_t)n * cl.TK + f.slot[q]] : -1;
        warp_add(pt.tbl + q * DV, pt.pres + q * DV, el && v >= 0 && v < DV ? v : -1, cnt);
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < Q; q += nthr) {
    int m = kMaxInt32, d = 0;
    for (int w = 0; w < nwarps; ++w) {
      m = min(m, s.wmin[w * Q + q]);
      d += s.wcnt[w * Q + q];
    }
    pt.minh[q] = m;
    pt.domh[q] = d;
  }
  sum_tables(cluster, s, Q, DV, ncta);
  if (ncta > 1) cluster_arrive();  // done reading the peers' tables
  const Tables ft = tables(s.fin, Q, DV);
  // Global minimum over the existing domains (newCriticalPaths), a warp a
  // constraint.
  for (int q = warp; q < Q; q += nwarps) {
    long long mn, domains;
    if (f.host[q]) {
      mn = ft.minh[q];
      domains = ft.domh[q];
    } else {
      int m = kMaxInt32, d = 0;
      for (int v = lane; v < DV; v += 32) {
        if (ft.pres[q * DV + v]) {
          ++d;
          m = min(m, ft.tbl[q * DV + v]);
        }
      }
      mn = __reduce_min_sync(kFull, m);
      domains = __reduce_add_sync(kFull, d);
    }
    if (lane == 0) min_match[q] = domains < f.mindom[q] ? 0 : mn;
  }
  __syncthreads();
  for (int n = n0 + tid; n < n1; n += nthr) {
    bool ok = true;
    bool keys = true;
    bool keys_known = false;
    for (int q = 0; ok && q < Q; ++q) {
      if (!f.valid[q]) continue;
      const int v = cl.topo_vals[(size_t)n * cl.TK + f.slot[q]];
      if (v < 0) {
        ok = false;
        break;
      }
      long long match;
      if (f.host[q]) {
        if (!keys_known) {
          keys = all_keys(f, Q, cl, n);
          keys_known = true;
        }
        const bool el = eligible(f, q, cl.valid[n] != 0, keys, cl.node_bits[(size_t)c * N + n]);
        match = el ? count(cl, lists + (size_t)q * cl.G, s.glen[q], n) : 0;
      } else {
        match = v < DV ? ft.tbl[q * DV + v] : 0;
      }
      ok = match + (f.self[q] ? 1 : 0) - min_match[q] <= (long long)f.skew[q];
    }
    a.out[(size_t)c * N + n] = ok ? 1 : 0;
  }
  if (ncta > 1) cluster_wait();
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
  const int* pref_op;             // (C, T, PQ)
  const int* pref_key;
  const int* pref_vals;           // (C, T, PQ, V)
  const long long* pref_int;
  const long long* pref_weight;   // (C, T)
  int T, PQ, V;
  const unsigned char* intol_pref;  // (C, TV) (null unless tt_w)
  int TV;
  Cons s;                   // ScheduleAnyway constraints (tps_s_*), Q = 0 unless sp_w
  const double* log_table;  // (L,) log(k + 2)
  int L;
  int* glist;               // (C * K, Q, G) scratch: a CTA's group lists
  long long* raw;           // (3, C, N) (N = 1 when pinned): NodeAffinity, taint, spread raw scores
  long long na_w, tt_w, sp_w;
  int C;
};

// NodeAffinity's raw score of pod c on node n: the summed weights of its
// preferred terms that match.
__device__ __forceinline__ long long na_raw(const LsArgs& a, int c, int n) {
  using namespace node_program;
  const size_t tq = (size_t)c * a.T * a.PQ;
  const Program pref{a.pref_op + tq, a.pref_key + tq, a.pref_vals + tq * a.V, a.pref_int + tq,
                     a.T, a.PQ, a.V};
  const Node nd{a.label_key + (size_t)n * a.LS, a.label_pair + (size_t)n * a.LS,
                a.label_int + (size_t)n * a.LS, a.name_id[n], a.LS};
  long long r = 0;
  for (int t = 0; t < a.T; ++t) {
    const long long wt = a.pref_weight[(size_t)c * a.T + t];
    if (wt != 0 && term(pref, t, nd)) r += wt;
  }
  return r;
}

// TaintToleration's raw score of pod c on node n: its intolerable
// PreferNoSchedule taints.
__device__ __forceinline__ long long tt_raw(const LsArgs& a, int c, int n) {
  long long r = 0;
  const unsigned char* intol = a.intol_pref + (size_t)c * a.TV;
  for (int i = 0; i < a.TS; ++i) {
    const int id = a.taint_ids[(size_t)n * a.TS + i];
    if (id >= 0 && id < a.TV && intol[id]) ++r;
  }
  return r;
}

// The two scores normalized by their maxima over the feasible set.
__device__ __forceinline__ long long na_score(long long raw, long long mx) {
  return mx == 0 ? 0 : floordiv_i64(raw * kMaxScore, mx > 1 ? mx : 1);
}

__device__ __forceinline__ long long tt_score(long long raw, long long mx) {
  return mx == 0 ? kMaxScore : kMaxScore - floordiv_i64(raw * kMaxScore, mx > 1 ? mx : 1);
}

// Pinned mode: pod c on node pin_row[c] alone, by one thread; the maxima
// over its feasible set are the node's own scores or 0.
__device__ void late_pinned(const LsArgs& a, int c) {
  long long* tot = a.total + c;
  if (!a.feasible[c]) {
    *tot = 0;
    return;
  }
  const int n = a.pin_row[c];
  long long add = 0;
  if (a.na_w) {
    const long long r = na_raw(a, c, n);
    add += na_score(r, max(r, 0LL)) * a.na_w;
  }
  if (a.tt_w) {
    const long long r = tt_raw(a, c, n);
    add += tt_score(r, max(r, 0LL)) * a.tt_w;
  }
  *tot += add;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// kCols: the columns mode of the attribution pass (late_scores_cols_launch).
template <bool kCols>
__global__ void __launch_bounds__(kMaxThreads) late_scores_kernel(LsArgs a) {
  if (!kCols && a.pin_row != nullptr) {  // one row a pod: no tables, no reductions
    if (threadIdx.x == 0) late_pinned(a, blockIdx.x);
    return;
  }
  extern __shared__ __align__(8) unsigned char smem_raw[];
  __shared__ int s_scan[kMaxWarps];
  __shared__ int s_nsc[kMaxWarps];
  __shared__ long long s_red[4][kMaxWarps];
  __shared__ long long s_xch[4];  // max NodeAffinity, max taint, min and max spread: read by the cluster
  __shared__ long long s_all[4];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Cluster& cl = a.cl;
  const Cons& sc = a.s;
  const int Q = sc.Q, DV = cl.DV, N = cl.N;
  const int c = blockIdx.x / ncta;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const Smem s = carve(smem_raw, Q, DV, ncta);
  const Flags& f = s.f;
  int* lists = a.glist + (size_t)blockIdx.x * Q * cl.G;
  double* w = reinterpret_cast<double*>(s.ll);  // (Q,) log(topoSize + 2)
  int n0, n1;
  slice(N, ncta, rank, &n0, &n1);
  stage(s, sc, c, DV);
  if (a.sp_w) group_lists(sc, cl.G, c, lists, s.glen, s_scan);
  __syncthreads();
  const unsigned char* feasible = a.feasible + (size_t)c * N;
  long long* raw_na = a.raw + (size_t)c * N;
  long long* raw_tt = a.raw + ((size_t)a.C + c) * N;
  long long* raw_sp = a.raw + ((size_t)2 * a.C + c) * N;
  const Tables pt = tables(s.part, Q, DV);
  // Raw NodeAffinity and taint scores with their feasible maxima; spread's
  // partial domain tables over eligible nodes and presence over scored
  // nodes, a warp's lanes on 32 consecutive rows.
  long long max_na = 0, max_tt = 0;
  int nsc = 0;
  for (int base = n0 + warp * 32; base < n1; base += nthr) {
    const int n = base + lane;
    const bool in = n < n1;
    const bool feas = in && feasible[n] != 0;
    if (a.na_w && in) {
      const long long r = na_raw(a, c, n);
      raw_na[n] = r;
      if (feas) max_na = max(max_na, r);
    }
    if (a.tt_w && in) {
      const long long r = tt_raw(a, c, n);
      raw_tt[n] = r;
      if (feas) max_tt = max(max_tt, r);
    }
    if (a.sp_w) {
      const bool keys = in && all_keys(f, Q, cl, n);
      const bool scored = feas && keys;
      nsc += __popc(__ballot_sync(kFull, scored));
      const bool nvalid = in && cl.valid[n] != 0;
      const unsigned char bits = in ? cl.node_bits[(size_t)c * N + n] : 0;
      for (int q = 0; q < Q; ++q) {
        if (!f.valid[q] || f.host[q]) continue;
        const int v = in ? cl.topo_vals[(size_t)n * cl.TK + f.slot[q]] : -1;
        const bool dom = v >= 0 && v < DV;
        const bool el = dom && eligible(f, q, nvalid, keys, bits);
        const int cnt = el ? count(cl, lists + (size_t)q * cl.G, s.glen[q], n) : 0;
        warp_add(pt.tbl + q * DV, nullptr, el ? v : -1, cnt);
        if (scored && dom) pt.pres[q * DV + v] = 1;
      }
    }
  }
  if (lane == 0) s_nsc[warp] = nsc;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int i = 0; i < nwarps; ++i) t += s_nsc[i];
    *pt.nsc = t;
  }
  sum_tables(cluster, s, Q, DV, ncta);
  const Tables ft = tables(s.fin, Q, DV);
  const int n_scored = *ft.nsc;
  long long sp_mn = kBig, sp_mx = 0;
  if (a.sp_w) {
    // topoSize per constraint, a warp a constraint.
    for (int q = warp; q < Q; q += nwarps) {
      int size = 0;
      if (f.host[q]) {
        size = n_scored;
      } else {
        int d = 0;
        for (int v = lane; v < DV; v += 32) d += ft.pres[q * DV + v] ? 1 : 0;
        size = __reduce_add_sync(kFull, d);
      }
      if (lane == 0) w[q] = a.log_table[size < a.L ? size : a.L - 1];
    }
    __syncthreads();
    for (int n = n0 + tid; n < n1; n += nthr) {
      double acc = 0.0;
      for (int q = 0; q < Q; ++q) {
        if (!f.valid[q]) continue;
        const int v = cl.topo_vals[(size_t)n * cl.TK + f.slot[q]];
        if (v < 0) continue;  // key missing: the term is 0
        double cnt;
        if (f.host[q]) {  // the node's own pods, no eligibility mask
          cnt = (double)count(cl, lists + (size_t)q * cl.G, s.glen[q], n);
        } else {
          cnt = v < DV ? (double)ft.tbl[q * DV + v] : 0.0;
        }
        const double term_q = cnt * w[q] + ((double)f.skew[q] - 1.0);
        acc = acc + term_q;
      }
      const long long r = (long long)floor(acc + 0.5);
      raw_sp[n] = r;
      if (feasible[n] && all_keys(f, Q, cl, n)) {
        sp_mn = min(sp_mn, r);
        sp_mx = max(sp_mx, r);
      }
    }
  }
  // The four reductions: per warp, over the block, then one exchange over
  // the cluster.
  max_na = warp_max(max_na);
  max_tt = warp_max(max_tt);
  sp_mn = warp_min(sp_mn);
  sp_mx = warp_max(sp_mx);
  if (lane == 0) {
    s_red[0][warp] = max_na;
    s_red[1][warp] = max_tt;
    s_red[2][warp] = sp_mn;
    s_red[3][warp] = sp_mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < nwarps; ++i) {
      max_na = max(max_na, s_red[0][i]);
      max_tt = max(max_tt, s_red[1][i]);
      sp_mn = min(sp_mn, s_red[2][i]);
      sp_mx = max(sp_mx, s_red[3][i]);
    }
    s_xch[0] = max_na;
    s_xch[1] = max_tt;
    s_xch[2] = sp_mn;
    s_xch[3] = sp_mx;
  }
  if (ncta > 1) {
    cluster.sync();
    if (warp == 0) {
      long long x0 = 0, x1 = 0, x2 = kBig, x3 = 0;
      if (lane < ncta) {
        const long long* x = cluster.map_shared_rank(s_xch, lane);
        x0 = x[0];
        x1 = x[1];
        x2 = x[2];
        x3 = x[3];
      }
      x0 = warp_max(x0);
      x1 = warp_max(x1);
      x2 = warp_min(x2);
      x3 = warp_max(x3);
      if (lane == 0) {
        s_all[0] = x0;
        s_all[1] = x1;
        s_all[2] = x2;
        s_all[3] = x3;
      }
    }
    __syncthreads();
    cluster_arrive();  // done reading the peers' shared memory
  } else {
    __syncthreads();
    if (tid < 4) s_all[tid] = s_xch[tid];
    __syncthreads();
  }
  bool any_soft = false;
  for (int q = 0; q < Q; ++q) any_soft = any_soft || f.valid[q];
  const long long mx_na = s_all[0], mx_tt = s_all[1];
  const long long sp_min = n_scored > 0 ? s_all[2] : 0, sp_max = s_all[3];
  if (kCols) {
    // Every node's columns before their weights, as the ops give them:
    // NodeAffinity's and TaintToleration's unmasked, spread's 0 off its
    // scored nodes; written over the raw scores, weighted into total.
    for (int n = n0 + tid; n < n1; n += nthr) {
      long long add = 0;
      if (a.na_w) {
        raw_na[n] = na_score(raw_na[n], mx_na);
        add += raw_na[n] * a.na_w;
      }
      if (a.tt_w) {
        raw_tt[n] = tt_score(raw_tt[n], mx_tt);
        add += raw_tt[n] * a.tt_w;
      }
      if (a.sp_w) {
        long long v = 0;
        if (any_soft && feasible[n] && all_keys(f, Q, cl, n)) {
          v = sp_max == 0 ? kMaxScore
              : floordiv_i64(kMaxScore * (sp_max + sp_min - raw_sp[n]), sp_max > 1 ? sp_max : 1);
        }
        raw_sp[n] = v;
        add += v * a.sp_w;
      }
      a.total[(size_t)c * N + n] += add;
    }
  } else {
    for (int n = n0 + tid; n < n1; n += nthr) {
      long long* tot = a.total + (size_t)c * N + n;
      if (!feasible[n]) {
        *tot = 0;
        continue;
      }
      long long add = 0;
      if (a.na_w) add += na_score(raw_na[n], mx_na) * a.na_w;
      if (a.tt_w) add += tt_score(raw_tt[n], mx_tt) * a.tt_w;
      if (a.sp_w && any_soft && all_keys(f, Q, cl, n)) {
        const long long sc_sp = sp_max == 0 ? kMaxScore
            : floordiv_i64(kMaxScore * (sp_max + sp_min - raw_sp[n]), sp_max > 1 ? sp_max : 1);
        add += sc_sp * a.sp_w;
      }
      *tot += add;
    }
  }
  if (ncta > 1) cluster_wait();
}

Cons make_cons(const void* valid, const void* slot, const void* skew, const void* mindom,
               const void* self, const void* host, const void* aff, const void* taint,
               const void* groups, int Q) {
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
  k.Q = Q;
  return k;
}

// Threads a CTA whose slice of an N-row axis is one of K.
int cta_threads(int N, int K) {
  return slice_rows(N, K) >= kMaxThreads ? kMaxThreads : kMaxThreads / 2;
}

// Launches C pods over clusters of K CTAs of ``threads`` (K = 1: a plain
// launch), setting the kernel's dynamic shared-memory limit and, for
// K = 16, the non-portable cluster size first (``Id``: one set of those
// settings a kernel).  Refuses a ``smem_bytes`` other than smem_len of the
// pod's Q constraints over DV domain values.
template <int Id, typename Args>
int launch(void (*kernel)(Args), const Args& a, int C, int Q, int DV, int smem_bytes, int K, void* stream,
           int threads) {
  static int smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  static bool nonportable = false;
  if (K < 1 || K > 16 || (K & (K - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (smem_bytes != smem_len(Q, DV, K)) return (int)cudaErrorInvalidValue;
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  if (K > 8 && !nonportable) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// glist: (C * K, Q, G) int32 scratch, a row of group lists a CTA.
extern "C" int spread_filter_launch(
    const void* topo_vals, const void* valid, const void* group_counts, const void* node_bits,
    const void* h_valid, const void* h_slot, const void* h_skew, const void* h_mindom,
    const void* h_self, const void* h_host, const void* h_aff, const void* h_taint,
    const void* h_groups, void* glist, void* out, int C, int N, int TK, int DV, int G, int Q,
    int smem_bytes, int K, void* stream) {
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
  a.h = make_cons(h_valid, h_slot, h_skew, h_mindom, h_self, h_host, h_aff, h_taint, h_groups, Q);
  a.glist = static_cast<int*>(glist);
  a.out = static_cast<unsigned char*>(out);
  a.C = C;
  return launch<0>(spread_filter_kernel, a, C, Q, DV, smem_bytes, K, stream, cta_threads(N, K));
}

#define LS_PARAMS \
    const void* label_key, const void* label_pair, const void* label_int, const void* name_id, \
    const void* taint_ids, const void* topo_vals, const void* valid, const void* group_counts, \
    const void* node_bits, const void* feasible, void* total, const void* pin_row, const void* pref_op, \
    const void* pref_key, const void* pref_vals, const void* pref_int, const void* pref_weight, \
    const void* intol_pref, const void* s_valid, const void* s_slot, const void* s_skew, \
    const void* s_mindom, const void* s_self, const void* s_host, const void* s_aff, \
    const void* s_taint, const void* s_groups, const void* log_table, void* glist, void* raw, int C, \
    int N, int LS, int TS, int TK, int DV, int G, int T, int PQ, int V, int TV, int Q, int L, \
    long long na_w, long long tt_w, long long sp_w, int smem_bytes, int K, void* stream
#define LS_ARGS \
    label_key, label_pair, label_int, name_id, taint_ids, topo_vals, valid, group_counts, node_bits, \
    feasible, total, pin_row, pref_op, pref_key, pref_vals, pref_int, pref_weight, intol_pref, s_valid, \
    s_slot, s_skew, s_mindom, s_self, s_host, s_aff, s_taint, s_groups, log_table, glist, raw, C, N, \
    LS, TS, TK, DV, G, T, PQ, V, TV, Q, L, na_w, tt_w, sp_w, smem_bytes, K, stream

namespace {

template <bool kCols>
int launch_late(LS_PARAMS) {
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
  if (a.pin_row != nullptr && (sp_w != 0 || K != 1)) return (int)cudaErrorInvalidValue;
  a.pref_op = static_cast<const int*>(pref_op);
  a.pref_key = static_cast<const int*>(pref_key);
  a.pref_vals = static_cast<const int*>(pref_vals);
  a.pref_int = static_cast<const long long*>(pref_int);
  a.pref_weight = static_cast<const long long*>(pref_weight);
  a.T = T;
  a.PQ = PQ;
  a.V = V;
  a.intol_pref = static_cast<const unsigned char*>(intol_pref);
  a.TV = TV;
  a.s = make_cons(s_valid, s_slot, s_skew, s_mindom, s_self, s_host, s_aff, s_taint, s_groups, Q);
  a.log_table = static_cast<const double*>(log_table);
  a.L = L;
  a.glist = static_cast<int*>(glist);
  a.raw = static_cast<long long*>(raw);
  a.na_w = na_w;
  a.tt_w = tt_w;
  a.sp_w = sp_w;
  a.C = C;
  // Pinned mode: one warp a pod, its first thread working.
  return launch<kCols ? 2 : 1>(late_scores_kernel<kCols>, a, C, Q, DV, smem_bytes, K, stream,
                               a.pin_row != nullptr ? 32 : cta_threads(N, K));
}

}  // namespace

extern "C" int late_scores_launch(LS_PARAMS) { return launch_late<false>(LS_ARGS); }

// Columns mode (the attribution pass, kubernetes_tpu/engine/pass_.py:
// 812-886): raw (3, C, N), zeroed by the caller, ends holding the three
// columns before their weights on every node; total gains their weighted
// sum on every node.  No pinned mode.
extern "C" int late_scores_cols_launch(LS_PARAMS) {
  if (pin_row != nullptr) return (int)cudaErrorInvalidValue;
  return launch_late<true>(LS_ARGS);
}

KERNEL_ERROR_STRING(spread_eval)
