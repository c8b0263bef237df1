// preempt_search: the what-if search of a dry-run whose active filters read
// the domain tables (InterPodAffinity, PodTopologySpread).
//
// Replaces kubernetes_tpu/preemption.py:274-297 (released: the group and
// own-term counts less each node's masked victims), :391-431 (ok_search:
// build_dom of the released state, engine/pass_.py:96-119, then the search
// filters on it) and :421-455 (phase 1 and reprieve_step), and the two hard
// filters of the search (ops/interpodaffinity.py:300 ~_affinity_ok,
// ops/podtopologyspread.py:338 missing topology keys).  A dry-run is a host
// loop between preempt_eval's PROLOGUE and TAIL (preempt.cu): search_step
// on the live state (the hard filters), then per step — phase 1, then each
// occupied slot s in reverse — dom_release and search_step.
//
//   dom_release  the domain tables of the state the step evaluates: the
//                live group_dom/et_dom copied, then one thread per (node,
//                slot) takes each masked victim's group off group_dom at
//                its node's domain of every topology key, and each of its
//                own terms off et_dom at its node's domain of the term's
//                key.  At step s >= 0 slot s is restored on EVERY node
//                before the tables are built, as the reference builds
//                tentative = mask & ~(slot == s) for all nodes at once
//                (:441; upstream releases per candidate node).  f32 atomics
//                of -1 on integer-valued cells below 2^24 are exact in any
//                order, so the tables equal build_dom of the released
//                counts bit for bit.
//   search_step  one block over every node (the search filters reduce over
//                the node axis): it builds the representative's own-term
//                tallies of the released tables, the forbidden table of the
//                existing anti-affinity terms matching it, and the spread
//                constraints' count and presence tables over the released
//                per-node counts (a node's count less its masked victims of
//                the selected groups), then walks the nodes: the closed-form
//                fit, InterPodAffinity's filter (existing anti-affinity,
//                required affinity with the lonely-pod rule, required
//                anti-affinity), PodTopologySpread's filter and the
//                node-local ops (preempt_search.cuh).  HARD_STEP clears
//                F_HARD where the live state fails the hard filters; PHASE1
//                sets F_FEAS (and F_REPRIEVE unless ReadWriteOncePod-
//                blocked); a slot step s lets a node that may reprieve and
//                still fits take slot s back, updating the carry.
//
// Numerics: every count and table cell is an integer; the JAX filters sum
// them in f32 at full precision, exact below 2^24, so these int sums are
// bit-identical.
//
// Bound: dom_release writes both tables and reads the masked victims' group
// and term slots (bytes).  search_step reads each node's state row, its
// masked victims' slots and the selected groups' counts once per walk, two
// walks (bytes); one block leaves the other SMs idle — a grid-wide
// reduction is later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "preempt_search.cuh"

namespace {

using namespace search;

constexpr int kThreads = 256;
constexpr int kBlock = 1024;

__global__ void dom_release_kernel(float* __restrict__ group_dom, float* __restrict__ et_dom,
                                   const int* __restrict__ topo_vals, const int* __restrict__ et_slot,
                                   const int* __restrict__ group, const int* __restrict__ terms,
                                   const long long* __restrict__ carry_mask, int TK, int DV, int N,
                                   int V, int TS, int s) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)N * V) return;
  const int n = (int)(e / V), v = (int)(e % V);
  unsigned long long mask = (unsigned long long)carry_mask[n];
  if (s >= 0) mask &= ~(1ULL << s);
  if (!((mask >> v) & 1ULL)) return;
  const int* tv = topo_vals + (long long)n * TK;
  if (group != nullptr) {
    const int g = group[e];
    if (g >= 0) {
      for (int k = 0; k < TK; ++k) {
        const int d = tv[k];
        if (d >= 0 && d < DV) atomicAdd(group_dom + ((long long)g * TK + k) * DV + d, -1.0f);
      }
    }
  }
  if (terms != nullptr) {
    for (int a = 0; a < TS; ++a) {
      const int t = terms[e * TS + a];
      if (t < 0) continue;
      const int k = et_slot[t];
      if (k < 0 || k >= TK) continue;
      const int d = tv[k];
      if (d >= 0 && d < DV) atomicAdd(et_dom + (long long)t * DV + d, -1.0f);
    }
  }
}

// The step's mask of node n: the carry's, slot s restored at a slot step,
// nothing released at HARD_STEP.
__device__ __forceinline__ unsigned long long tentative(const Args& a, int n, int s) {
  if (s == kHardStep) return 0;
  const unsigned long long m = (unsigned long long)at<long long>(a, P_CARRY_MASK)[n];
  return s >= 0 ? m & ~(1ULL << s) : m;
}

// Released count at node n of the groups on ``list`` (whose G-wide mask is
// ``member``): their live counts less the masked victims of those groups.
__device__ __forceinline__ int released_groups(const Args& a, const int* list, int len,
                                               const unsigned char* member, int n,
                                               unsigned long long mask) {
  const int N = a.d[D_N], V = a.d[D_V];
  const int* gc = at<int>(a, P_GROUP_COUNTS);
  int c = 0;
  for (int i = 0; i < len; ++i) c += gc[(long long)list[i] * N + n];
  const int* vg = at<int>(a, P_VF_GROUP);
  if (vg != nullptr) {
    for (int v = 0; v < V; ++v) {
      if (!((mask >> v) & 1ULL)) continue;
      const int g = vg[(long long)n * V + v];
      if (g >= 0 && member[g]) --c;
    }
  }
  return c;
}

// Released count at node n of existing term t.
__device__ __forceinline__ int released_term(const Args& a, int t, int n, unsigned long long mask) {
  const int N = a.d[D_N], V = a.d[D_V], TS = a.d[D_TS];
  int c = at<int>(a, P_ET_COUNTS)[(long long)t * N + n];
  const int* vt = at<int>(a, P_VF_TERMS);
  if (vt != nullptr) {
    for (int v = 0; v < V; ++v) {
      if (!((mask >> v) & 1ULL)) continue;
      for (int b = 0; b < TS; ++b) {
        if (vt[((long long)n * V + v) * TS + b] == t) --c;
      }
    }
  }
  return c;
}

struct Shared {
  int i0;
  int lens[1 + 2 * kMaxSlots];  // list 0: the required affinity's groups; 1..RS; then K
  int elen;                     // hostname existing anti-affinity terms matching the pod
  int any_ra, ra_self, counts_empty;
  unsigned long long ra_total[kMaxSlots];  // hostname required terms: matching pods on key nodes
  int min_h[kMaxSlots], dom_h[kMaxSlots];  // hostname spread: min count, eligible nodes
  long long min_match[kMaxSlots];
};

__global__ void __launch_bounds__(kBlock) search_step_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int N = a.d[D_N], V = a.d[D_V], R = a.d[D_R], TK = a.d[D_TK], DV = a.d[D_DV];
  const int G = a.d[D_G], ET = a.d[D_ET], RA = a.d[D_RA], RS = a.d[D_RS], K = a.d[D_K];
  const int s = a.d[D_STEP];
  const bool ipa = has_flag(a, S_IPA), pts = has_flag(a, S_PTS);
  int* tbl_ra = smem;               // (RA, DV)
  int* tbl_rs = tbl_ra + RA * DV;   // (RS, DV)
  int* forb = tbl_rs + RS * DV;     // (TK, DV)
  int* pts_tbl = forb + TK * DV;    // (K, DV)
  int* pts_pres = pts_tbl + K * DV; // (K, DV)
  const int ncells = DV * (RA + RS + TK + 2 * K);
  for (int i = tid; i < ncells; i += blockDim.x) smem[i] = 0;
  if (tid == 0) {
    sh.i0 = representative(a);
    for (int i = 0; i < 1 + 2 * kMaxSlots; ++i) sh.lens[i] = 0;
    sh.elen = 0;
    for (int i = 0; i < kMaxSlots; ++i) {
      sh.ra_total[i] = 0;
      sh.min_h[i] = kI32Max;
      sh.dom_h[i] = 0;
    }
  }
  __syncthreads();
  const int i0 = sh.i0;
  const int* topo = at<int>(a, P_TOPO);
  int* glist = at<int>(a, P_GLIST);
  int* elist = at<int>(a, P_ELIST);
  const unsigned char *ra_valid = nullptr, *ra_host = nullptr, *ra_mask = nullptr, *rs_valid = nullptr,
                      *rs_host = nullptr, *rs_groups = nullptr, *et_host = nullptr;
  const int *ra_slot = nullptr, *rs_slot = nullptr, *et_slot = nullptr;
  const float *gd = nullptr, *ed = nullptr;
  if (ipa) {
    ra_valid = at<unsigned char>(a, P_RA_VALID) + (long long)i0 * RA;
    ra_slot = at<int>(a, P_RA_SLOT) + (long long)i0 * RA;
    ra_host = at<unsigned char>(a, P_RA_HOST) + (long long)i0 * RA;
    ra_mask = at<unsigned char>(a, P_RA_ALLMASK) + (long long)i0 * G;
    rs_valid = at<unsigned char>(a, P_RS_VALID) + (long long)i0 * RS;
    rs_slot = at<int>(a, P_RS_SLOT) + (long long)i0 * RS;
    rs_host = at<unsigned char>(a, P_RS_HOST) + (long long)i0 * RS;
    rs_groups = at<unsigned char>(a, P_RS_GROUPS) + (long long)i0 * RS * G;
    gd = at<float>(a, P_GROUP_DOM);
    ed = at<float>(a, P_ET_DOM);
    et_slot = at<int>(a, P_ET_SLOT);
    et_host = at<unsigned char>(a, P_ET_HOST);
  }
  const unsigned char *h_valid = nullptr, *h_self = nullptr, *h_host = nullptr, *h_aff = nullptr,
                      *h_taint = nullptr, *h_groups = nullptr, *node_bits = nullptr;
  const int *h_slot = nullptr, *h_skew = nullptr, *h_mindom = nullptr;
  if (pts) {
    h_valid = at<unsigned char>(a, P_H_VALID) + (long long)i0 * K;
    h_slot = at<int>(a, P_H_SLOT) + (long long)i0 * K;
    h_skew = at<int>(a, P_H_SKEW) + (long long)i0 * K;
    h_mindom = at<int>(a, P_H_MINDOM) + (long long)i0 * K;
    h_self = at<unsigned char>(a, P_H_SELF) + (long long)i0 * K;
    h_host = at<unsigned char>(a, P_H_HOSTNAME) + (long long)i0 * K;
    h_aff = at<unsigned char>(a, P_H_AFF) + (long long)i0 * K;
    h_taint = at<unsigned char>(a, P_H_TAINT) + (long long)i0 * K;
    h_groups = at<unsigned char>(a, P_H_GROUPS) + (long long)i0 * K * G;
    node_bits = at<unsigned char>(a, P_NODE_BITS) + (long long)i0 * N;
  }

  // ---- The representative's compact group lists and terms. ----
  if (tid == 0 && ipa) {
    int any = 0;
    for (int t = 0; t < RA; ++t) any |= ra_valid[t];
    sh.any_ra = any;
    sh.ra_self = at<unsigned char>(a, P_RA_SELF)[i0];
  }
  __syncthreads();
  if (ipa) {
    for (int g = tid; g < G; g += blockDim.x) {
      if (sh.any_ra && ra_mask[g]) glist[atomicAdd(&sh.lens[0], 1)] = g;
      for (int t = 0; t < RS; ++t) {
        if (rs_valid[t] && rs_groups[(long long)t * G + g]) glist[(long long)(1 + t) * G + atomicAdd(&sh.lens[1 + t], 1)] = g;
      }
    }
    const unsigned char* match = at<unsigned char>(a, P_ET_MATCH) + (long long)i0 * ET;
    const unsigned char* anti = at<unsigned char>(a, P_ET_ANTI) + (long long)i0 * ET;
    for (int e = tid; e < ET; e += blockDim.x) {
      if (!(match[e] && anti[e])) continue;
      if (et_host[e]) {
        elist[atomicAdd(&sh.elen, 1)] = e;
      } else {
        const int k = et_slot[e];
        if (k >= 0 && k < TK) {
          for (int d = 0; d < DV; ++d) {
            if (ed[(long long)e * DV + d] > 0.5f) forb[k * DV + d] = 1;
          }
        }
      }
    }
  }
  if (pts) {
    for (int g = tid; g < G; g += blockDim.x) {
      for (int k = 0; k < K; ++k) {
        if (h_valid[k] && h_groups[(long long)k * G + g])
          glist[(long long)(1 + RS + k) * G + atomicAdd(&sh.lens[1 + RS + k], 1)] = g;
      }
    }
  }
  __syncthreads();
  // Own-term tallies of the (released) domain tables: tbl[t][d] = sum over
  // the term's groups of group_dom[g, slot_t, d] (hostname terms count per
  // node instead).
  if (ipa) {
    for (int i = tid; i < (RA + RS) * DV; i += blockDim.x) {
      const int t = i / DV, d = i % DV;
      const bool is_ra = t < RA;
      const int tt = is_ra ? t : t - RA;
      if (!(is_ra ? ra_valid[tt] : rs_valid[tt])) continue;
      const int slot = is_ra ? ra_slot[tt] : rs_slot[tt];
      if (slot < 0 || slot >= TK) continue;
      const int* list = glist + (is_ra ? 0 : (long long)(1 + tt) * G);
      const int len = sh.lens[is_ra ? 0 : 1 + tt];
      int sum = 0;
      for (int j = 0; j < len; ++j) sum += (int)gd[((long long)list[j] * TK + slot) * DV + d];
      (is_ra ? tbl_ra : tbl_rs)[tt * DV + d] = sum;
    }
  }
  __syncthreads();

  // ---- Walk 1: the node-axis reductions on the step's released state. ----
  const bool need_totals = ipa && sh.any_ra && sh.ra_self;
  for (int n = tid; n < N; n += blockDim.x) {
    const unsigned long long mask = tentative(a, n, s);
    if (need_totals) {
      int cnt = -1;
      for (int t = 0; t < RA; ++t) {
        if (!ra_valid[t] || !ra_host[t] || topo[(long long)n * TK + ra_slot[t]] < 0) continue;
        if (cnt < 0) cnt = released_groups(a, glist, sh.lens[0], ra_mask, n, mask);
        if (cnt > 0) atomicAdd(&sh.ra_total[t], (unsigned long long)cnt);
      }
    }
    if (pts && s != kHardStep) {
      bool all_keys = true;
      for (int k = 0; k < K; ++k) {
        if (h_valid[k] && topo[(long long)n * TK + h_slot[k]] < 0) all_keys = false;
      }
      const bool node_ok = at<unsigned char>(a, P_VALID)[n] && all_keys;
      const unsigned char nb = node_bits[n];
      for (int k = 0; k < K; ++k) {
        if (!h_valid[k]) continue;
        const bool elig = node_ok && (!h_aff[k] || (nb & 1)) && (!h_taint[k] || (nb & 2));
        if (!elig) continue;
        const int cnt = released_groups(a, glist + (long long)(1 + RS + k) * G, sh.lens[1 + RS + k],
                                        h_groups + (long long)k * G, n, mask);
        if (h_host[k]) {
          atomicMin(&sh.min_h[k], cnt);
          atomicAdd(&sh.dom_h[k], 1);
        } else {
          const int d = topo[(long long)n * TK + h_slot[k]];
          if (d >= 0 && d < DV) {
            atomicAdd(&pts_tbl[k * DV + d], cnt);
            pts_pres[k * DV + d] = 1;
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0 && ipa) {
    long long total = 0;
    for (int t = 0; t < RA; ++t) {
      if (!ra_valid[t]) continue;
      if (ra_host[t]) {
        total += (long long)sh.ra_total[t];
      } else {
        for (int d = 0; d < DV; ++d) total += tbl_ra[t * DV + d];
      }
    }
    sh.counts_empty = total == 0;
  }
  if (pts && tid < K && h_valid[tid]) {
    const int k = tid;
    long long min_tbl, domains;
    if (h_host[k]) {
      min_tbl = sh.min_h[k];
      domains = sh.dom_h[k];
    } else {
      min_tbl = kI32Max;
      domains = 0;
      for (int d = 0; d < DV; ++d) {
        if (pts_pres[k * DV + d]) {
          ++domains;
          if (pts_tbl[k * DV + d] < min_tbl) min_tbl = pts_tbl[k * DV + d];
        }
      }
    }
    sh.min_match[k] = domains < h_mindom[k] ? 0 : min_tbl;
  }
  __syncthreads();

  // ---- Walk 2: each node's verdict and the carry. ----
  unsigned char* flags = at<unsigned char>(a, P_CARRY_FLAGS);
  for (int n = tid; n < N; n += blockDim.x) {
    const unsigned long long mask = tentative(a, n, s);
    const int* tv = topo + (long long)n * TK;
    bool ok = true;
    bool aff_ok = true;
    if (ipa && sh.any_ra) {
      // (2) Incoming required affinity.
      int cnt = -1;
      bool keys_ok = true, exist = true;
      for (int t = 0; t < RA; ++t) {
        if (!ra_valid[t]) continue;
        const int d = tv[ra_slot[t]];
        if (d < 0) {
          keys_ok = false;
          exist = false;
          continue;
        }
        int at_t;
        if (ra_host[t]) {
          if (cnt < 0) cnt = released_groups(a, glist, sh.lens[0], ra_mask, n, mask);
          at_t = cnt;
        } else {
          at_t = d < DV ? tbl_ra[t * DV + d] : 0;
        }
        if (at_t <= 0) exist = false;
      }
      aff_ok = keys_ok && (exist || (sh.counts_empty && sh.ra_self));
    }
    if (s == kHardStep) {
      bool keys = true;
      if (pts) {
        for (int k = 0; k < K; ++k) {
          if (h_valid[k] && tv[h_slot[k]] < 0) keys = false;
        }
      }
      if (!(aff_ok && keys)) flags[n] &= (unsigned char)~F_HARD;
      continue;
    }
    if (ipa) {
      ok = aff_ok;
      // (1) Existing pods' required anti-affinity.
      for (int k = 0; ok && k < TK; ++k) {
        const int d = tv[k];
        if (d >= 0 && d < DV && forb[k * DV + d]) ok = false;
      }
      for (int i = 0; ok && i < sh.elen; ++i) {
        const int e = elist[i];
        if (tv[et_slot[e]] >= 0 && released_term(a, e, n, mask) > 0) ok = false;
      }
      // (3) Incoming required anti-affinity.
      for (int t = 0; ok && t < RS; ++t) {
        if (!rs_valid[t]) continue;
        const int d = tv[rs_slot[t]];
        if (d < 0) continue;
        int at_t;
        if (rs_host[t]) {
          at_t = released_groups(a, glist + (long long)(1 + t) * G, sh.lens[1 + t], rs_groups + (long long)t * G,
                                 n, mask);
        } else {
          at_t = d < DV ? tbl_rs[t * DV + d] : 0;
        }
        if (at_t > 0) ok = false;
      }
    }
    if (ok && pts) {
      bool all_keys = true;
      for (int k = 0; k < K; ++k) {
        if (h_valid[k] && tv[h_slot[k]] < 0) all_keys = false;
      }
      const bool node_ok = at<unsigned char>(a, P_VALID)[n] && all_keys;
      const unsigned char nb = node_bits[n];
      for (int k = 0; ok && k < K; ++k) {
        if (!h_valid[k]) continue;
        const int d = tv[h_slot[k]];
        if (d < 0) {
          ok = false;
          continue;
        }
        long long match;
        if (h_host[k]) {
          const bool elig = node_ok && (!h_aff[k] || (nb & 1)) && (!h_taint[k] || (nb & 2));
          match = elig ? released_groups(a, glist + (long long)(1 + RS + k) * G, sh.lens[1 + RS + k],
                                         h_groups + (long long)k * G, n, mask)
                       : 0;
        } else {
          match = d < DV ? pts_tbl[k * DV + d] : 0;
        }
        if (match + (h_self[k] ? 1 : 0) - sh.min_match[k] > h_skew[k]) ok = false;
      }
    }
    // The closed form, then the node-local ops.
    const long long* crel = at<long long>(a, P_CARRY_REL) + (long long)n * R;
    int* ccnt = at<int>(a, P_CARRY_CNT);
    long long t_rel[kMaxR];
    for (int r = 0; r < R; ++r) t_rel[r] = crel[r];
    int t_cnt = ccnt[n];
    const bool has = s >= 0 && ((at<long long>(a, P_CARRY_MASK)[n] >> s) & 1LL);
    if (has) {
      const long long* vr = at<long long>(a, P_VIC_REQ) + ((long long)n * V + s) * R;
      for (int r = 0; r < R; ++r) t_rel[r] -= vr[r];
      --t_cnt;
    }
    ok = ok && fits(a, n, i0, t_rel, t_cnt) && local_ok(a, n, i0, mask);
    if (s == kPhase1) {
      if (ok) flags[n] |= (unsigned char)(F_FEAS | (rwop_blocked(a, i0) ? 0 : F_REPRIEVE));
    } else if (has && ok && (flags[n] & F_REPRIEVE)) {
      at<long long>(a, P_CARRY_MASK)[n] = (long long)mask;
      long long* w = at<long long>(a, P_CARRY_REL) + (long long)n * R;
      for (int r = 0; r < R; ++r) w[r] = t_rel[r];
      ccnt[n] = t_cnt;
    }
  }
}

}  // namespace

extern "C" int dom_release_launch(const void* group_dom, const void* et_dom, const void* topo_vals,
                                  const void* et_slot, const void* group, const void* terms,
                                  const void* carry_mask, int G, int ET, int TK, int DV, int N, int V,
                                  int TS, int s, void* out_group_dom, void* out_et_dom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out_group_dom, group_dom, (size_t)G * TK * DV * sizeof(float),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(out_et_dom, et_dom, (size_t)ET * DV * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)N * V;
  if (total == 0 || V > kMaxV) return V > kMaxV ? (int)cudaErrorInvalidValue : 0;
  dom_release_kernel<<<(int)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<float*>(out_group_dom), static_cast<float*>(out_et_dom),
      static_cast<const int*>(topo_vals), static_cast<const int*>(et_slot),
      static_cast<const int*>(group), static_cast<const int*>(terms),
      static_cast<const long long*>(carry_mask), TK, DV, N, V, TS, s);
  return (int)cudaGetLastError();
}

// ptrs: the search::Ptr table (nptrs entries), dims: the search::Dim
// values (ndims), both host arrays; D_STEP is the step, D_SMEM the bytes of
// the dynamic shared tables.
extern "C" int search_step_launch(const void* ptrs, int nptrs, const void* dims, int ndims,
                                  void* stream) {
  if (nptrs != P_COUNT || ndims != D_COUNT) return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = static_cast<void* const*>(ptrs)[i];
  for (int i = 0; i < D_COUNT; ++i) a.d[i] = static_cast<const int*>(dims)[i];
  if (a.d[D_R] > kMaxR || a.d[D_V] > kMaxV || a.d[D_QC] > kMaxSlots || a.d[D_RA] > kMaxSlots ||
      a.d[D_RS] > kMaxSlots || a.d[D_K] > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  if (a.d[D_N] == 0) return 0;
  const int smem = a.d[D_SMEM];
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(search_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  search_step_kernel<<<1, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(preempt_search)
