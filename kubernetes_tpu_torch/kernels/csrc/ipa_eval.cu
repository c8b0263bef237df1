// ipa_eval: InterPodAffinity's filter and score for C pods against N nodes,
// applied on top of eval_chunk's (feasible, total, fail_mask).
//
// Replaces kubernetes_tpu/ops/interpodaffinity.py: _own_term_tallies
// (:193), _affinity_ok (:227), _existing_anti_fail (:253), filter_fn (:283)
// and score_fn (:304), vmapped over the chunk by the JAX pass.  The JAX op
// reads its per-domain tables back per node through one-hot matrix
// products (gathers are slow on the TPU); here each node gathers
// tbl[t, topo_vals[n, slot]] directly.
//
// One pod over a thread block cluster of K CTAs (K from the host's
// cluster_split: more CTAs a pod where the chunk is small, so a chunk-1
// step at N=8192 runs on 16 SMs instead of one; K = 1 is one block a pod,
// a plain launch).  The pod's term flags are staged in shared memory
// first, so no later loop over the terms waits on device memory.
//   Phase A builds the pod's small tables in shared memory; CTA r of the
//   cluster scans groups [r*G/K, (r+1)*G/K) of each mask and existing
//   terms [r*ET/K, (r+1)*ET/K), into partial tables in its own shared
//   memory and its own segment of each compact list; after cluster.sync
//   every CTA sums the K partial tables over distributed shared memory
//   into its own copy (integer counts: the order of the sum does not
//   matter) and reads the K segments' lengths:
//     - compact lists of the groups each own-term mask selects (the required
//       affinity's all-terms mask, each required anti-affinity term, each
//       preferred term), written to a global scratch row per pod, one
//       segment of it per CTA, every mask's loads in flight together
//       (every CTA walks the non-empty segments);
//     - the own-term domain tallies tbl[t][d] = sum over the term's groups
//       of group_dom[g, slot_t, d] (hostname terms are per node instead),
//       every term's entries in one strided walk of the block;
//     - the forbidden table (TK x DV) of existing required anti-affinity
//       terms matching the pod, and the weighted table (TK x DV) of existing
//       terms' signed weights times their domain carriers, from et_dom;
//       hostname existing terms go to compact lists instead.
//   Phase B walks the CTA's node slice [r*S, (r+1)*S), S = ceil(N/K)
//   rounded up to 32: the three filter checks on nodes eval_chunk
//   left feasible (fail bit at the op's position in the filter order), and
//   the raw score on the nodes that stay feasible.  Hostname terms sum the
//   node's group_counts (own terms) or et_counts (existing terms) over
//   their compact lists.  The lonely-pod rule needs the required-affinity
//   terms' totals over every key-bearing node first: a block reduction over
//   the slice, then a sum over the cluster, when such a term uses the
//   hostname key.
//   One exchange over the cluster then gives the min and max raw score over
//   the final feasible set (and whether any node failed the filter: the
//   first CTA sets the fail bit), and the last walk over the slice zeroes
//   `total` on infeasible nodes and adds weight x the normalised score
//   (int64 floor division) to the rest.  No global atomics; a CTA does not
//   exit before its peers have read its shared memory.
//
// Phases: ``bit`` < 0 skips the filter and ``weight`` 0 the score, so one
// launch runs either phase or both (the default, one launch a chunk).
// Truncated mode (engine/pass_.py) launches the filter alone (weight 0),
// cuts the feasible set with truncate_feasible, then launches the score
// alone (bit -1), which normalises over the truncated set as the JAX pass
// scores after its cut (pass_.py:494-540).  Phase A builds only the tables
// of the phase it runs.
//
// Numerics: the JAX op sums counts and weights in f32 at full precision.
// Every value is an integer count times a weight of at most 100, exact
// below 2^24, so this kernel's int32/int64 sums are bit-identical to it.
//
// Bound: bytes.  Per chunk it must read the group masks of the pods'
// valid terms (G bytes each), et_match (C x ET bytes) and, where a pod
// matched a term, its et_anti, et_w, et_slot and et_host entries; the
// nodes' topology values; one group_dom (or, for a hostname term,
// group_counts) row per distinct selected group and one et_dom (or
// et_counts) row per used existing term; and read and write the chunk's
// feasible and total (C x N x 9 bytes each way).  The design reads every
// mask once per pod, keeps the per-pod tables in shared memory and walks
// the node axis coalesced.  On the card it is latency-bound: the per-node
// walk of phase B (chains of dependent loads through the compact lists)
// takes most of a chunk-1 launch, which is why the node axis is split.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kBig = 1LL << 62;

struct IpaArgs {
  int C, N, TK, DV, G, ET, RA, RS, PF;
  int bit;          // fail bit of the filter, -1 when the op only scores
  long long weight; // score weight, 0 when the op does not score
  // Cluster state.
  const int* topo_vals;     // (N, TK)
  const int* group_counts;  // (G, N)
  const int* et_counts;     // (ET, N)
  // Domain tables.
  const float* group_dom;        // (G, TK, DV)
  const float* et_dom;           // (ET, DV)
  const int* et_slot;            // (ET,)
  const unsigned char* et_host;  // (ET,)
  // Pod features of the chunk.
  const unsigned char* ra_valid;  // (C, RA)
  const int* ra_slot;             // (C, RA)
  const unsigned char* ra_host;   // (C, RA)
  const unsigned char* ra_allmask;  // (C, G)
  const unsigned char* ra_self;     // (C,)
  const unsigned char* rs_valid;  // (C, RS)
  const int* rs_slot;
  const unsigned char* rs_host;
  const unsigned char* rs_groups;  // (C, RS, G)
  const unsigned char* pf_valid;   // (C, PF)
  const int* pf_slot;
  const unsigned char* pf_host;
  const unsigned char* pf_groups;  // (C, PF, G)
  const long long* pf_w;           // (C, PF)
  const unsigned char* et_match;   // (C, ET)
  const unsigned char* et_anti;    // (C, ET)
  const long long* et_w;           // (C, ET)
  // In/out: eval_chunk's result.
  unsigned char* feasible;  // (C, N)
  long long* total;         // (C, N)
  unsigned int* fail_mask;  // (C,)
  // Scratch.
  int* glist;      // (C, 1+RS+PF, G): compact group lists, a segment of ceil(G/K) a CTA
  int* elist;      // (C, 2, ET): hostname existing terms (anti, weighted), a segment of ceil(ET/K) a CTA
  long long* raw;  // (C, N)
  // Columns mode: the filter's own verdict on every node (C, N).
  unsigned char* ok_out;
};

// A compact list in K segments: segment q starts at list + q * seg and
// holds lens[q * stride] entries; the nn segments nz[0..nn) are the
// non-empty ones.
struct Segs {
  const int* list;
  const int* lens;
  const int* nz;
  int nn, seg, stride;
};

// Per-node count of the pods of a segmented group list; four loads in
// flight at a time.
__device__ __forceinline__ int list_count(const IpaArgs& a, const Segs& s, int n) {
  int sum = 0;
  for (int j = 0; j < s.nn; ++j) {
    const int q = s.nz[j];
    const int* l = s.list + q * s.seg;
    const int len = s.lens[q * s.stride];
    int i = 0;
    for (; i + 4 <= len; i += 4) {
      const int ga = l[i], gb = l[i + 1], gc = l[i + 2], gd = l[i + 3];
      sum += a.group_counts[(size_t)ga * a.N + n] + a.group_counts[(size_t)gb * a.N + n] +
             a.group_counts[(size_t)gc * a.N + n] + a.group_counts[(size_t)gd * a.N + n];
    }
    for (; i < len; ++i) sum += a.group_counts[(size_t)l[i] * a.N + n];
  }
  return sum;
}

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long s = 0;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
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

// tbl[d] += sum over the list's groups of group_dom[g, slot, d], for the
// entries i = start, start + blockDim.x, ... of its len x DV; returns the
// thread's start in the next term's entries, so the block walks the
// tallies of every term as one strided loop.
__device__ int tally(const IpaArgs& a, const int* list, int len, int slot, int* tbl, int start) {
  const int work = len * a.DV;
  int i = start;
  for (; i < work; i += blockDim.x) {
    const int g = list[i / a.DV];
    const int d = i % a.DV;
    const float v = a.group_dom[((size_t)g * a.TK + slot) * a.DV + d];
    if (v != 0.0f) atomicAdd(tbl + d, (int)v);
  }
  return i - work;
}

// kCols: the columns mode of the attribution pass (see ipa_eval_cols_launch).
template <bool kCols>
__global__ void __launch_bounds__(kThreads) ipa_eval_kernel(IpaArgs a) {
  // Dynamic shared memory: the preferred terms' weights; each own term's
  // (valid, slot, hostname) flags; this CTA's partial tables and list
  // lengths; with K > 1 the cluster's summed tables and every CTA's
  // lengths after them.
  extern __shared__ long long smem_ll[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = a.RA + a.RS + a.PF;
  const int NL = 1 + a.RS + a.PF;
  const int NLE = NL + 2;  // the group lists' lengths, then the two term lists'
  const int ntab = T * a.DV + 2 * a.TK * a.DV;
  long long* pf_w = smem_ll;        // (PF,)
  int* t_valid = (int*)(pf_w + a.PF);  // (T,): ra terms, rs terms, pf terms
  int* t_slot = t_valid + T;
  int* t_host = t_slot + T;
  int* part = t_host + T;
  int* lens = part + ntab;
  int* fin = K > 1 ? lens + NLE : part;
  int* alen = K > 1 ? fin + ntab : lens;
  int* nzn = alen + (K > 1 ? K * NLE : NLE);  // (NLE,): non-empty segments of each list
  int* nzq = nzn + NLE;                       // (NLE, K): their ranks
  int* ptbl = part;                   // (T, DV): ra terms, rs terms, pf terms
  int* pforb = ptbl + T * a.DV;       // (TK, DV)
  int* pwsum = pforb + a.TK * a.DV;   // (TK, DV)
  const int* tbl = fin;
  const int* forb = fin + T * a.DV;
  const int* wsum = forb + a.TK * a.DV;
  __shared__ long long red[kWarps];
  __shared__ long long s_mn[kWarps];
  __shared__ long long s_mx[kWarps];
  __shared__ long long s_xch[4];  // lonely-pod partial, then (min, max, any fail): read by the cluster
  __shared__ long long s_all[3];  // the cluster's (min, max, any fail)
  __shared__ long long s_lonely;
  __shared__ int s_any_fail;

  const int c = blockIdx.x / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool filt = a.bit >= 0;
  const bool score = a.weight != 0;
  for (int i = tid; i < ntab + NLE; i += blockDim.x) part[i] = 0;
  for (int t = tid; t < T; t += blockDim.x) {
    const unsigned char* valid = t < a.RA ? a.ra_valid + (size_t)c * a.RA + t
                                 : t < a.RA + a.RS ? a.rs_valid + (size_t)c * a.RS + (t - a.RA)
                                                   : a.pf_valid + (size_t)c * a.PF + (t - a.RA - a.RS);
    const int* slot = t < a.RA ? a.ra_slot + (size_t)c * a.RA + t
                      : t < a.RA + a.RS ? a.rs_slot + (size_t)c * a.RS + (t - a.RA)
                                        : a.pf_slot + (size_t)c * a.PF + (t - a.RA - a.RS);
    const unsigned char* host = t < a.RA ? a.ra_host + (size_t)c * a.RA + t
                                : t < a.RA + a.RS ? a.rs_host + (size_t)c * a.RS + (t - a.RA)
                                                  : a.pf_host + (size_t)c * a.PF + (t - a.RA - a.RS);
    t_valid[t] = *valid;
    t_slot[t] = *slot;
    t_host[t] = *host;
    if (t >= a.RA + a.RS) pf_w[t - a.RA - a.RS] = a.pf_w[(size_t)c * a.PF + (t - a.RA - a.RS)];
  }
  if (tid == 0) s_any_fail = 0;
  __syncthreads();
  const int* ra_valid = t_valid;
  const int* ra_slot = t_slot;
  const int* ra_host = t_host;
  const int* rs_valid = t_valid + a.RA;
  const int* rs_slot = t_slot + a.RA;
  const int* rs_host = t_host + a.RA;
  const int* pf_valid = t_valid + a.RA + a.RS;
  const int* pf_slot = t_slot + a.RA + a.RS;
  const int* pf_host = t_host + a.RA + a.RS;

  const int gseg = (a.G + K - 1) / K;
  const int g0 = min(a.G, rank * gseg), g1 = min(a.G, g0 + gseg);
  const int eseg = (a.ET + K - 1) / K;
  const int e0 = min(a.ET, rank * eseg), e1 = min(a.ET, e0 + eseg);
  const int size = (((a.N + K - 1) / K + 31) / 32) * 32;
  const int n0 = min(a.N, rank * size), n1 = min(a.N, n0 + size);

  int* glist = a.glist + (size_t)c * NL * a.G;
  int* elist = a.elist + (size_t)c * 2 * a.ET;

  bool any_ra = false, ra_host_any = false;
  for (int t = 0; t < a.RA; ++t) {
    if (ra_valid[t]) {
      any_ra = true;
      if (ra_host[t]) ra_host_any = true;
    }
  }
  any_ra = any_ra && filt;

  // ---- Phase A: this CTA's segments of every compact group list, the
  // masks' loads all in flight together. ----
  const int gn = g1 - g0;
  for (int idx = tid; idx < NL * gn; idx += blockDim.x) {
    const int l = idx / gn;
    const int g = g0 + (idx - l * gn);
    bool on;
    const unsigned char* mask;
    if (l == 0) {
      on = any_ra;
      mask = a.ra_allmask + (size_t)c * a.G;
    } else if (l <= a.RS) {
      on = filt && rs_valid[l - 1];
      mask = a.rs_groups + ((size_t)c * a.RS + (l - 1)) * a.G;
    } else {
      on = score && pf_valid[l - 1 - a.RS];
      mask = a.pf_groups + ((size_t)c * a.PF + (l - 1 - a.RS)) * a.G;
    }
    if (on && mask[g]) glist[(size_t)l * a.G + g0 + atomicAdd(lens + l, 1)] = g;
  }
  // Existing terms matching the pod: domain terms fold into the (TK, DV)
  // tables, hostname terms into compact list segments.
  const unsigned char* et_match = a.et_match + (size_t)c * a.ET;
  const unsigned char* et_anti = a.et_anti + (size_t)c * a.ET;
  const long long* et_w = a.et_w + (size_t)c * a.ET;
  for (int e = e0 + tid; e < e1; e += blockDim.x) {
    if (!et_match[e]) continue;
    const bool host = a.et_host[e] != 0;
    const int slot = a.et_slot[e];
    const float* dom = a.et_dom + (size_t)e * a.DV;
    if (filt && et_anti[e]) {
      if (host) {
        elist[e0 + atomicAdd(lens + NL, 1)] = e;
      } else {
        for (int d = 0; d < a.DV; ++d) {
          if (dom[d] > 0.5f) atomicAdd(pforb + slot * a.DV + d, 1);
        }
      }
    }
    const long long w = et_w[e];
    if (score && w != 0) {
      if (host) {
        elist[a.ET + e0 + atomicAdd(lens + NL + 1, 1)] = e;
      } else {
        for (int d = 0; d < a.DV; ++d) {
          if (dom[d] != 0.0f) atomicAdd(pwsum + slot * a.DV + d, (int)w * (int)dom[d]);
        }
      }
    }
  }
  __syncthreads();
  // The own-term tallies of this CTA's groups, every term's entries in one
  // strided walk of the block.
  for (int t = 0, start = tid; t < T; ++t) {
    const int l = t < a.RA ? 0 : 1 + (t - a.RA);
    const bool on = t < a.RA ? any_ra : t < a.RA + a.RS ? filt : score;
    if (on && t_valid[t] && !t_host[t]) {
      start = tally(a, glist + (size_t)l * a.G + g0, lens[l], t_slot[t], ptbl + t * a.DV, start);
    }
  }
  // The cluster's tables and every segment's length (the list segments in
  // device memory are ordered by the same barrier).
  const auto sync_all = [&]() {
    if (K > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  sync_all();
  if (K > 1) {
    for (int i = tid; i < ntab; i += blockDim.x) {
      int sum = 0;
      for (int q = 0; q < K; ++q) sum += cluster.map_shared_rank(part, q)[i];
      fin[i] = sum;
    }
    for (int i = tid; i < K * NLE; i += blockDim.x) alen[i] = cluster.map_shared_rank(lens, i / NLE)[i % NLE];
    __syncthreads();
  }
  for (int l = tid; l < NLE; l += blockDim.x) {
    int nn = 0;
    for (int q = 0; q < K; ++q) {
      if (alen[q * NLE + l] > 0) nzq[l * K + nn++] = q;
    }
    nzn[l] = nn;
  }
  __syncthreads();
  const auto segs = [&](int l) { return Segs{glist + (size_t)l * a.G, alen + l, nzq + l * K, nzn[l], gseg, NLE}; };

  // The lonely-pod rule: the required-affinity terms' matching pods over
  // every key-bearing node, summed over the valid terms.
  bool counts_empty = true;
  if (any_ra) {
    long long tot = 0;
    if (ra_host_any) {
      const Segs ra = segs(0);
      for (int n = n0 + tid; n < n1; n += blockDim.x) {
        int cnt = -1;
        for (int t = 0; t < a.RA; ++t) {
          if (ra_valid[t] && ra_host[t] && a.topo_vals[(size_t)n * a.TK + ra_slot[t]] >= 0) {
            if (cnt < 0) cnt = list_count(a, ra, n);
            tot += cnt;
          }
        }
      }
      tot = block_sum(tot, red);
      if (tid == 0) s_xch[0] = tot;
      sync_all();
      if (warp == 0) {
        long long x = lane < K ? cluster.map_shared_rank(s_xch, lane)[0] : 0;
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) s_lonely = x;
      }
      __syncthreads();
      tot = s_lonely;
    }
    for (int t = 0; t < a.RA; ++t) {
      if (ra_valid[t] && !ra_host[t]) {
        for (int d = 0; d < a.DV; ++d) tot += tbl[t * a.DV + d];
      }
    }
    counts_empty = tot == 0;
  }
  const bool lonely_ok = counts_empty && a.ra_self[c] != 0;

  // ---- Phase B: filter and raw score per node of the slice. ----
  long long mn = kBig, mx = -kBig;
  unsigned char* feas_row = a.feasible + (size_t)c * a.N;
  long long* total_row = a.total + (size_t)c * a.N;
  long long* raw_row = a.raw + (size_t)c * a.N;
  const int* ehost_anti = elist;
  const int* ehost_w = elist + a.ET;
  for (int n = n0 + tid; n < n1; n += blockDim.x) {
    const int* tv = a.topo_vals + (size_t)n * a.TK;
    bool f = feas_row[n] != 0;
    if (filt && (kCols || f)) {
      // (1) existing pods' required anti-affinity
      int hit = 0;
      for (int k = 0; k < a.TK; ++k) {
        const int v = tv[k];
        if (v >= 0 && v < a.DV) hit += forb[k * a.DV + v];
      }
      bool ok = hit == 0;
      for (int j = 0; ok && j < nzn[NL]; ++j) {
        const int q = nzq[NL * K + j];
        const int* l = ehost_anti + q * eseg;
        const int len = alen[q * NLE + NL];
        for (int i = 0; ok && i < len; ++i) {
          const int e = l[i];
          if (a.et_counts[(size_t)e * a.N + n] > 0 && tv[a.et_slot[e]] >= 0) ok = false;
        }
      }
      // (2) incoming required affinity
      if (ok && any_ra) {
        bool keys_ok = true, pods_exist = true;
        int cnt = -1;
        for (int t = 0; t < a.RA; ++t) {
          if (!ra_valid[t]) continue;
          const int v = tv[ra_slot[t]];
          int at = 0;
          if (v < 0) {
            keys_ok = false;
          } else if (ra_host[t]) {
            if (cnt < 0) cnt = list_count(a, segs(0), n);
            at = cnt;
          } else if (v < a.DV) {
            at = tbl[t * a.DV + v];
          }
          if (at <= 0) pods_exist = false;
        }
        ok = keys_ok && (pods_exist || lonely_ok);
      }
      // (3) incoming required anti-affinity
      for (int t = 0; ok && t < a.RS; ++t) {
        if (!rs_valid[t]) continue;
        const int v = tv[rs_slot[t]];
        if (v < 0) continue;
        int at = 0;
        if (rs_host[t]) {
          at = list_count(a, segs(1 + t), n);
        } else if (v < a.DV) {
          at = tbl[(a.RA + t) * a.DV + v];
        }
        if (at > 0) ok = false;
      }
      if (kCols) {
        a.ok_out[(size_t)c * a.N + n] = ok ? 1 : 0;
        f = f && ok;
      } else if (!ok) {
        f = false;
        s_any_fail = 1;
      }
      feas_row[n] = f ? 1 : 0;
    }
    if (score && f) {
      long long r = 0;
      for (int t = 0; t < a.PF; ++t) {
        if (!pf_valid[t]) continue;
        const int v = tv[pf_slot[t]];
        if (v < 0) continue;
        long long at = 0;
        if (pf_host[t]) {
          at = list_count(a, segs(1 + a.RS + t), n);
        } else if (v < a.DV) {
          at = tbl[(a.RA + a.RS + t) * a.DV + v];
        }
        r += at * pf_w[t];
      }
      for (int k = 0; k < a.TK; ++k) {
        const int v = tv[k];
        if (v >= 0 && v < a.DV) r += wsum[k * a.DV + v];
      }
      for (int j = 0; j < nzn[NL + 1]; ++j) {
        const int q = nzq[(NL + 1) * K + j];
        const int* l = ehost_w + q * eseg;
        const int len = alen[q * NLE + NL + 1];
        for (int i = 0; i < len; ++i) {
          const int e = l[i];
          if (tv[a.et_slot[e]] >= 0) r += et_w[e] * (long long)a.et_counts[(size_t)e * a.N + n];
        }
      }
      raw_row[n] = r;
      mn = r < mn ? r : mn;
      mx = r > mx ? r : mx;
    } else if (!kCols && !score && !f) {
      total_row[n] = 0;
    }
  }

  // ---- One exchange over the cluster: (min, max) over the final feasible
  // set and whether any node failed the filter. ----
  for (int off = 16; off > 0; off >>= 1) {
    const long long omn = __shfl_xor_sync(0xffffffffu, mn, off);
    const long long omx = __shfl_xor_sync(0xffffffffu, mx, off);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mn = s_mn[w] < mn ? s_mn[w] : mn;
      mx = s_mx[w] > mx ? s_mx[w] : mx;
    }
    s_xch[1] = mn;
    s_xch[2] = mx;
    s_xch[3] = s_any_fail;
  }
  sync_all();
  if (warp == 0) {
    long long xmn = kBig, xmx = -kBig, xf = 0;
    if (lane < K) {
      const long long* x = cluster.map_shared_rank(s_xch, lane);
      xmn = x[1];
      xmx = x[2];
      xf = x[3];
    }
    for (int off = 16; off > 0; off >>= 1) {
      const long long omn = __shfl_xor_sync(0xffffffffu, xmn, off);
      const long long omx = __shfl_xor_sync(0xffffffffu, xmx, off);
      xf |= __shfl_xor_sync(0xffffffffu, xf, off);
      xmn = omn < xmn ? omn : xmn;
      xmx = omx > xmx ? omx : xmx;
    }
    if (lane == 0) {
      s_all[0] = xmn;
      s_all[1] = xmx;
      s_all[2] = xf;
    }
  }
  __syncthreads();
  // The peers are done with this CTA's shared memory once all have read.
  if (K > 1) cluster_arrive();
  if (!kCols && rank == 0 && tid == 0 && s_all[2]) a.fail_mask[c] |= 1u << a.bit;
  if (score) {
    // ---- Normalisation over the final feasible set, on the slice. ----
    mn = s_all[0];
    const long long diff = s_all[1] - mn;
    for (int n = n0 + tid; n < n1; n += blockDim.x) {
      long long norm = 0;
      if (feas_row[n] && diff > 0) norm = floordiv_i64(100LL * (raw_row[n] - mn), diff);
      if (kCols) {
        // The column on every node (0 off the feasible set, as the op
        // gives it), and total unmasked.
        raw_row[n] = norm;
        total_row[n] += a.weight * norm;
      } else if (feas_row[n]) {
        total_row[n] += a.weight * norm;
      } else {
        total_row[n] = 0;
      }
    }
  }
  if (K > 1) cluster_wait();
}

}  // namespace

#define IPA_PARAMS \
    int C, int N, int TK, int DV, int G, int ET, int RA, int RS, int PF, int bit, long long weight, \
    const void* topo_vals, const void* group_counts, const void* et_counts, const void* group_dom, \
    const void* et_dom, const void* et_slot, const void* et_host, const void* ra_valid, \
    const void* ra_slot, const void* ra_host, const void* ra_allmask, const void* ra_self, \
    const void* rs_valid, const void* rs_slot, const void* rs_host, const void* rs_groups, \
    const void* pf_valid, const void* pf_slot, const void* pf_host, const void* pf_groups, \
    const void* pf_w, const void* et_match, const void* et_anti, const void* et_w, void* feasible, \
    void* total, void* fail_mask, void* glist, void* elist, void* raw
#define IPA_ARGS \
    C, N, TK, DV, G, ET, RA, RS, PF, bit, weight, topo_vals, group_counts, et_counts, group_dom, \
    et_dom, et_slot, et_host, ra_valid, ra_slot, ra_host, ra_allmask, ra_self, rs_valid, rs_slot, \
    rs_host, rs_groups, pf_valid, pf_slot, pf_host, pf_groups, pf_w, et_match, et_anti, et_w, \
    feasible, total, fail_mask, glist, elist, raw

namespace {

IpaArgs make_args(IPA_PARAMS) {
  IpaArgs a;
  a.C = C;
  a.N = N;
  a.TK = TK;
  a.DV = DV;
  a.G = G;
  a.ET = ET;
  a.RA = RA;
  a.RS = RS;
  a.PF = PF;
  a.bit = bit;
  a.weight = weight;
  a.topo_vals = static_cast<const int*>(topo_vals);
  a.group_counts = static_cast<const int*>(group_counts);
  a.et_counts = static_cast<const int*>(et_counts);
  a.group_dom = static_cast<const float*>(group_dom);
  a.et_dom = static_cast<const float*>(et_dom);
  a.et_slot = static_cast<const int*>(et_slot);
  a.et_host = static_cast<const unsigned char*>(et_host);
  a.ra_valid = static_cast<const unsigned char*>(ra_valid);
  a.ra_slot = static_cast<const int*>(ra_slot);
  a.ra_host = static_cast<const unsigned char*>(ra_host);
  a.ra_allmask = static_cast<const unsigned char*>(ra_allmask);
  a.ra_self = static_cast<const unsigned char*>(ra_self);
  a.rs_valid = static_cast<const unsigned char*>(rs_valid);
  a.rs_slot = static_cast<const int*>(rs_slot);
  a.rs_host = static_cast<const unsigned char*>(rs_host);
  a.rs_groups = static_cast<const unsigned char*>(rs_groups);
  a.pf_valid = static_cast<const unsigned char*>(pf_valid);
  a.pf_slot = static_cast<const int*>(pf_slot);
  a.pf_host = static_cast<const unsigned char*>(pf_host);
  a.pf_groups = static_cast<const unsigned char*>(pf_groups);
  a.pf_w = static_cast<const long long*>(pf_w);
  a.et_match = static_cast<const unsigned char*>(et_match);
  a.et_anti = static_cast<const unsigned char*>(et_anti);
  a.et_w = static_cast<const long long*>(et_w);
  a.feasible = static_cast<unsigned char*>(feasible);
  a.total = static_cast<long long*>(total);
  a.fail_mask = static_cast<unsigned int*>(fail_mask);
  a.glist = static_cast<int*>(glist);
  a.elist = static_cast<int*>(elist);
  a.raw = static_cast<long long*>(raw);
  a.ok_out = nullptr;
  return a;
}

template <bool kCols>
int launch(const IpaArgs& a, int smem_bytes, int K, void* stream) {
  static int smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  static bool nonportable = false;
  if (K < 1 || K > 16 || (K & (K - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ipa_eval_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  if (K > 8 && !nonportable) {
    const cudaError_t err =
        cudaFuncSetAttribute(ipa_eval_kernel<kCols>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C * K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ipa_eval_kernel<kCols>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ipa_eval_launch(IPA_PARAMS, int smem_bytes, int K, void* stream) {
  return launch<false>(make_args(IPA_ARGS), smem_bytes, K, stream);
}

// Columns mode (the attribution pass, kubernetes_tpu/engine/pass_.py:
// 812-886), one phase a launch.  The filter phase (bit >= 0, weight 0)
// writes InterPodAffinity's own verdict on every node into ok_out and ANDs
// it into feasible, with no fail bit; the score phase (bit -1) normalizes
// over the given feasible set, writes the column into raw on every node (0
// off the set, as the op gives it) and adds weight x column into total on
// every node.
extern "C" int ipa_eval_cols_launch(IPA_PARAMS, void* ok_out, int smem_bytes, int K, void* stream) {
  IpaArgs a = make_args(IPA_ARGS);
  if ((bit >= 0) == (weight != 0) || (bit >= 0 && ok_out == nullptr)) return (int)cudaErrorInvalidValue;
  a.ok_out = static_cast<unsigned char*>(ok_out);
  return launch<true>(a, smem_bytes, K, stream);
}

KERNEL_ERROR_STRING(ipa_eval)
