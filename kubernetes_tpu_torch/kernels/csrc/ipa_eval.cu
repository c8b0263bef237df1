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
// One block per pod.
//   Phase A builds the pod's small tables in shared memory:
//     - compact lists of the groups each own-term mask selects (the required
//       affinity's all-terms mask, each required anti-affinity term, each
//       preferred term), written to a global scratch row per pod;
//     - the own-term domain tallies tbl[t][d] = sum over the term's groups
//       of group_dom[g, slot_t, d] (hostname terms are per node instead);
//     - the forbidden table (TK x DV) of existing required anti-affinity
//       terms matching the pod, and the weighted table (TK x DV) of existing
//       terms' signed weights times their domain carriers, from et_dom;
//       hostname existing terms go to compact lists instead.
//   Phase B walks the nodes: the three filter checks on nodes eval_chunk
//   left feasible (fail bit at the op's position in the filter order), and
//   the raw score on the nodes that stay feasible.  Hostname terms sum the
//   node's group_counts (own terms) or et_counts (existing terms) over
//   their compact lists.  The lonely-pod rule needs the required-affinity
//   terms' totals over every key-bearing node first: a block reduction over
//   the nodes when such a term uses the hostname key.
//   A block reduction then finds the min and max raw score over the final
//   feasible set, and the last walk zeroes `total` on infeasible nodes and
//   adds weight x the normalised score (int64 floor division) to the rest.
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
// the node axis coalesced.
#include <stdint.h>

#include "common.cuh"

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
  int* glist;      // (C, 1+RS+PF, G): compact group lists
  int* elist;      // (C, 2, ET): hostname existing terms (anti, weighted)
  long long* raw;  // (C, N)
  // Columns mode: the filter's own verdict on every node (C, N).
  unsigned char* ok_out;
};

// Per-node count of the pods of a compact group list.
__device__ __forceinline__ int list_count(const IpaArgs& a, const int* list, int len, int n) {
  int s = 0;
  for (int i = 0; i < len; ++i) s += a.group_counts[(size_t)list[i] * a.N + n];
  return s;
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

__device__ __forceinline__ long long block_min(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long s = red[0];
  for (int w = 1; w < kWarps; ++w) s = red[w] < s ? red[w] : s;
  return s;
}

__device__ __forceinline__ long long block_max(long long v, long long* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long s = red[0];
  for (int w = 1; w < kWarps; ++w) s = red[w] > s ? red[w] : s;
  return s;
}

// Appends the groups of a G-long mask to a compact list.
__device__ void compact(const unsigned char* mask, int G, int* list, int* len) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (mask[g]) list[atomicAdd(len, 1)] = g;
  }
}

// tbl[d] += sum over the list's groups of group_dom[g, slot, d].
__device__ void tally(const IpaArgs& a, const int* list, int len, int slot, int* tbl) {
  for (int i = threadIdx.x; i < len * a.DV; i += blockDim.x) {
    const int g = list[i / a.DV];
    const int d = i % a.DV;
    const float v = a.group_dom[((size_t)g * a.TK + slot) * a.DV + d];
    if (v != 0.0f) atomicAdd(tbl + d, (int)v);
  }
}

// kCols: the columns mode of the attribution pass (see ipa_eval_cols_launch).
template <bool kCols>
__global__ void ipa_eval_kernel(IpaArgs a) {
  extern __shared__ int smem[];
  const int T = a.RA + a.RS + a.PF;
  const int NL = 1 + a.RS + a.PF;
  int* tbl = smem;                    // (T, DV): ra terms, rs terms, pf terms
  int* forb = tbl + T * a.DV;         // (TK, DV)
  int* wsum = forb + a.TK * a.DV;     // (TK, DV)
  int* glen = wsum + a.TK * a.DV;     // (NL,)
  int* elen = glen + NL;              // (2,)
  __shared__ long long red[kWarps];
  __shared__ int s_any_fail;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const bool filt = a.bit >= 0;
  const bool score = a.weight != 0;
  const int ntab = T * a.DV + 2 * a.TK * a.DV + NL + 2;
  for (int i = tid; i < ntab; i += blockDim.x) smem[i] = 0;
  if (tid == 0) s_any_fail = 0;
  __syncthreads();

  int* glist = a.glist + (size_t)c * NL * a.G;
  int* elist = a.elist + (size_t)c * 2 * a.ET;
  const unsigned char* ra_valid = a.ra_valid + (size_t)c * a.RA;
  const int* ra_slot = a.ra_slot + (size_t)c * a.RA;
  const unsigned char* ra_host = a.ra_host + (size_t)c * a.RA;
  const unsigned char* rs_valid = a.rs_valid + (size_t)c * a.RS;
  const int* rs_slot = a.rs_slot + (size_t)c * a.RS;
  const unsigned char* rs_host = a.rs_host + (size_t)c * a.RS;
  const unsigned char* pf_valid = a.pf_valid + (size_t)c * a.PF;
  const int* pf_slot = a.pf_slot + (size_t)c * a.PF;
  const unsigned char* pf_host = a.pf_host + (size_t)c * a.PF;
  const long long* pf_w = a.pf_w + (size_t)c * a.PF;

  bool any_ra = false, ra_host_any = false;
  for (int t = 0; t < a.RA; ++t) {
    if (ra_valid[t]) {
      any_ra = true;
      if (ra_host[t]) ra_host_any = true;
    }
  }
  any_ra = any_ra && filt;

  // ---- Phase A: compact group lists, then the own-term tallies. ----
  if (any_ra) compact(a.ra_allmask + (size_t)c * a.G, a.G, glist, glen);
  for (int t = 0; t < a.RS; ++t) {
    if (filt && rs_valid[t]) {
      compact(a.rs_groups + ((size_t)c * a.RS + t) * a.G, a.G, glist + (size_t)(1 + t) * a.G, glen + 1 + t);
    }
  }
  for (int t = 0; t < a.PF; ++t) {
    if (score && pf_valid[t]) {
      compact(a.pf_groups + ((size_t)c * a.PF + t) * a.G, a.G,
              glist + (size_t)(1 + a.RS + t) * a.G, glen + 1 + a.RS + t);
    }
  }
  // Existing terms matching the pod: domain terms fold into the (TK, DV)
  // tables, hostname terms into compact lists.
  const unsigned char* et_match = a.et_match + (size_t)c * a.ET;
  const unsigned char* et_anti = a.et_anti + (size_t)c * a.ET;
  const long long* et_w = a.et_w + (size_t)c * a.ET;
  for (int e = tid; e < a.ET; e += blockDim.x) {
    if (!et_match[e]) continue;
    const bool host = a.et_host[e] != 0;
    const int slot = a.et_slot[e];
    const float* dom = a.et_dom + (size_t)e * a.DV;
    if (filt && et_anti[e]) {
      if (host) {
        elist[atomicAdd(elen, 1)] = e;
      } else {
        for (int d = 0; d < a.DV; ++d) {
          if (dom[d] > 0.5f) atomicAdd(forb + slot * a.DV + d, 1);
        }
      }
    }
    const long long w = et_w[e];
    if (score && w != 0) {
      if (host) {
        elist[a.ET + atomicAdd(elen + 1, 1)] = e;
      } else {
        for (int d = 0; d < a.DV; ++d) {
          if (dom[d] != 0.0f) atomicAdd(wsum + slot * a.DV + d, (int)w * (int)dom[d]);
        }
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < a.RA; ++t) {
    if (any_ra && ra_valid[t] && !ra_host[t]) tally(a, glist, glen[0], ra_slot[t], tbl + t * a.DV);
  }
  for (int t = 0; t < a.RS; ++t) {
    if (filt && rs_valid[t] && !rs_host[t]) {
      tally(a, glist + (size_t)(1 + t) * a.G, glen[1 + t], rs_slot[t], tbl + (a.RA + t) * a.DV);
    }
  }
  for (int t = 0; t < a.PF; ++t) {
    if (score && pf_valid[t] && !pf_host[t]) {
      tally(a, glist + (size_t)(1 + a.RS + t) * a.G, glen[1 + a.RS + t], pf_slot[t],
            tbl + (a.RA + a.RS + t) * a.DV);
    }
  }
  __syncthreads();

  // The lonely-pod rule: the required-affinity terms' matching pods over
  // every key-bearing node, summed over the valid terms.
  bool counts_empty = true;
  if (any_ra) {
    long long tot = 0;
    if (ra_host_any) {
      for (int n = tid; n < a.N; n += blockDim.x) {
        int cnt = -1;
        for (int t = 0; t < a.RA; ++t) {
          if (ra_valid[t] && ra_host[t] && a.topo_vals[(size_t)n * a.TK + ra_slot[t]] >= 0) {
            if (cnt < 0) cnt = list_count(a, glist, glen[0], n);
            tot += cnt;
          }
        }
      }
      tot = block_sum(tot, red);
    }
    for (int t = 0; t < a.RA; ++t) {
      if (ra_valid[t] && !ra_host[t]) {
        for (int d = 0; d < a.DV; ++d) tot += tbl[t * a.DV + d];
      }
    }
    counts_empty = tot == 0;
  }
  const bool lonely_ok = counts_empty && a.ra_self[c] != 0;

  // ---- Phase B: filter and raw score per node. ----
  long long mn = kBig, mx = -kBig;
  unsigned char* feas_row = a.feasible + (size_t)c * a.N;
  long long* total_row = a.total + (size_t)c * a.N;
  long long* raw_row = a.raw + (size_t)c * a.N;
  const int* ehost_anti = elist;
  const int* ehost_w = elist + a.ET;
  for (int n = tid; n < a.N; n += blockDim.x) {
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
      for (int i = 0; ok && i < elen[0]; ++i) {
        const int e = ehost_anti[i];
        if (a.et_counts[(size_t)e * a.N + n] > 0 && tv[a.et_slot[e]] >= 0) ok = false;
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
            if (cnt < 0) cnt = list_count(a, glist, glen[0], n);
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
          at = list_count(a, glist + (size_t)(1 + t) * a.G, glen[1 + t], n);
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
          at = list_count(a, glist + (size_t)(1 + a.RS + t) * a.G, glen[1 + a.RS + t], n);
        } else if (v < a.DV) {
          at = tbl[(a.RA + a.RS + t) * a.DV + v];
        }
        r += at * pf_w[t];
      }
      for (int k = 0; k < a.TK; ++k) {
        const int v = tv[k];
        if (v >= 0 && v < a.DV) r += wsum[k * a.DV + v];
      }
      for (int i = 0; i < elen[1]; ++i) {
        const int e = ehost_w[i];
        if (tv[a.et_slot[e]] >= 0) r += et_w[e] * (long long)a.et_counts[(size_t)e * a.N + n];
      }
      raw_row[n] = r;
      mn = r < mn ? r : mn;
      mx = r > mx ? r : mx;
    } else if (!kCols && !score && !f) {
      total_row[n] = 0;
    }
  }
  __syncthreads();
  if (!kCols && tid == 0 && s_any_fail) a.fail_mask[c] |= 1u << a.bit;
  if (!score) return;

  // ---- Normalisation over the final feasible set. ----
  mn = block_min(mn, red);
  mx = block_max(mx, red);
  const long long diff = mx - mn;
  for (int n = tid; n < a.N; n += blockDim.x) {
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
int launch(const IpaArgs& a, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ipa_eval_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  ipa_eval_kernel<kCols><<<a.C, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ipa_eval_launch(IPA_PARAMS, int smem_bytes, void* stream) {
  return launch<false>(make_args(IPA_ARGS), smem_bytes, stream);
}

// Columns mode (the attribution pass, kubernetes_tpu/engine/pass_.py:
// 812-886), one phase a launch.  The filter phase (bit >= 0, weight 0)
// writes InterPodAffinity's own verdict on every node into ok_out and ANDs
// it into feasible, with no fail bit; the score phase (bit -1) normalizes
// over the given feasible set, writes the column into raw on every node (0
// off the set, as the op gives it) and adds weight x column into total on
// every node.
extern "C" int ipa_eval_cols_launch(IPA_PARAMS, void* ok_out, int smem_bytes, void* stream) {
  IpaArgs a = make_args(IPA_ARGS);
  if ((bit >= 0) == (weight != 0) || (bit >= 0 && ok_out == nullptr)) return (int)cudaErrorInvalidValue;
  a.ok_out = static_cast<unsigned char*>(ok_out);
  return launch<true>(a, smem_bytes, stream);
}

KERNEL_ERROR_STRING(ipa_eval)
