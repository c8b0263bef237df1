// preempt_search.cuh: device code shared by preempt.cu (preempt_eval) and
// preempt_search.cu (search_step) — the argument table of a dry-run, the
// closed-form fit and the node-local ops of preemption's what-if search.
//
// Replaces kubernetes_tpu/preemption.py:274-334 (released: the state with a
// node's masked victims removed) for the node-local ops, and the filters it
// feeds at :391-431 (ok_search): NodePorts (ops/nodeports.py:45),
// VolumeRestrictions (ops/volumes.py:217, the ReadWriteOncePod check
// forced true inside the what-if, :405-410) and NodeVolumeLimits
// (ops/volumes.py:238).  At node n each reads column n of its counts less
// the slots of n's masked victims, so no released copy of any table is
// made: a count is the live count minus the masked slots holding its id.
// NodeVolumeLimits' crossing rule (:320-334): a masked slot releases its
// driver's attachment when its volume's count less the node's masked slots
// holding that volume reaches 0 — two victims sharing a volume free it only
// together, and then each of their slots counts once, as the reference's
// scatter-add counts them.  DynamicResources (ops/dynamicresources.py:53,
// released at :335-353): a claim's count is its live count less the node's
// masked victim slots that move it (first slots, and the count-only slot
// of an externally charged claim its victim alone reserves), and a pool's
// dra_alloc less the devices of every masked slot whose claim's count so
// reaches 0 (two victims sharing a claim both release then, as the
// reference's scatter-add counts them); its hard filter (a missing claim,
// a pin elsewhere) joins the release-independent checks.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace search {

constexpr int kMaxR = 16;
constexpr int kMaxV = 64;
constexpr int kMaxSlots = 16;  // per-pod term and constraint slots held in shared memory
constexpr int kI32Max = 2147483647;
constexpr long long kNoStart = -(1LL << 61);

// The pointer table, in the order of kubernetes_tpu_torch/kernels/__init__.py
// _search_args; any entry may be null where the dry-run does not read it.
enum Ptr {
  P_VALID, P_NAME_ID, P_UNSCHED, P_NUM_PODS, P_ALLOWED_PODS, P_ALLOC, P_REQ, P_TOPO,
  P_GROUP_COUNTS, P_ET_COUNTS, P_PORT_COUNTS, P_PORTKEY_COUNTS, P_DEV_COUNTS, P_DEV_RW_COUNTS,
  P_CSIVOL_COUNTS, P_CSI_USED, P_CSI_LIMIT,
  P_VIC_PRIO, P_VIC_REQ, P_VIC_NONZERO, P_VIC_START, P_VIC_PDB, P_PDB_ALLOWED,
  P_VF_GROUP, P_VF_TERMS, P_VF_PORT_TRIPLES, P_VF_PORT_KEYS, P_VF_DEV_IDS, P_VF_DEV_RW,
  P_VF_CSI_IDS, P_VF_CSI_DRV,
  P_PRIORITY, P_POD_REQ, P_NODENAME_ID, P_TOL_UNSCHED, P_MATE_VALID, P_ELIG, P_SPEC_PICKS,
  P_NODE_BITS, P_RWOP_OK,
  P_POD_PORT_TRIPLES, P_POD_PORT_KEYS, P_POD_PORT_WILD, P_POD_PORT_IS_WILD, P_POD_DEV_IDS,
  P_POD_DEV_RW, P_POD_CSI_IDS, P_POD_CSI_DRV,
  P_RA_VALID, P_RA_SLOT, P_RA_HOST, P_RA_ALLMASK, P_RA_SELF, P_RS_VALID, P_RS_SLOT, P_RS_HOST,
  P_RS_GROUPS, P_ET_MATCH, P_ET_ANTI,
  P_H_VALID, P_H_SLOT, P_H_SKEW, P_H_MINDOM, P_H_SELF, P_H_HOSTNAME, P_H_AFF, P_H_TAINT, P_H_GROUPS,
  P_GROUP_DOM, P_ET_DOM, P_ET_SLOT, P_ET_HOST,
  P_CARRY_MASK, P_CARRY_REL, P_CARRY_CNT, P_CARRY_FLAGS,
  P_POSSIBLE, P_CRIT, P_VIC_MASK, P_N_VIC, P_REL, P_RELNZ,
  P_GLIST, P_ELIST,
  P_DRA_CAP, P_DRA_ALLOC, P_DRA_CLAIM_COUNTS, P_VF_DRA_KID, P_VF_DRA_CID, P_VF_DRA_CNT, P_VF_DRA_FIRST,
  P_POD_DRA_IDS, P_POD_DRA_CLS, P_POD_DRA_CNT, P_POD_DRA_PINS, P_POD_DRA_MISSING,
  P_COUNT
};

// The dimensions, in the order of _SEARCH_DIMS.
enum Dim {
  D_C, D_N, D_V, D_R, D_P, D_TK, D_DV, D_G, D_ET, D_TS, D_PS, D_SD, D_SC, D_QP, D_QD, D_QC, D_DR,
  D_RA, D_RS, D_K, D_BITS_MASK, D_FLAGS, D_STEP, D_SMEM, D_SK, D_QK, D_DC, D_PIN,
  D_COUNT
};

// D_FLAGS bits: the release-independent checks and the search ops.
enum SpecFlag {
  S_UNSCHED = 1, S_NODENAME = 2, S_PORTS = 4, S_VR = 8, S_NVL = 16, S_IPA = 32, S_PTS = 64, S_DRA = 128
};
// Carry flags (plain.F_*).
enum CarryFlag { F_BASE = 1, F_HARD = 2, F_FEAS = 4, F_REPRIEVE = 8 };
// preempt_eval's modes and search_step's non-slot steps (plain.FULL, ...).
enum Mode { FULL = 0, PROLOGUE = 1, TAIL = 2 };
constexpr int kHardStep = -2;
constexpr int kPhase1 = -1;

struct Args {
  void* p[P_COUNT];
  int d[D_COUNT];
};

template <class T>
__device__ __forceinline__ T* at(const Args& a, int i) {
  return static_cast<T*>(a.p[i]);
}

__device__ __forceinline__ bool has_flag(const Args& a, int f) { return (a.d[D_FLAGS] & f) != 0; }

__device__ __forceinline__ bool mate_valid(const Args& a, int i) {
  if (a.p[P_MATE_VALID] != nullptr) return at<unsigned char>(a, P_MATE_VALID)[i] != 0;
  return at<unsigned char>(a, P_ELIG)[i] != 0 && at<int>(a, P_SPEC_PICKS)[i] < 0;
}

// First valid mate, 0 when none (jnp.argmax of an all-false mask).
__device__ int representative(const Args& a) {
  for (int i = 0; i < a.d[D_C]; ++i) {
    if (mate_valid(a, i)) return i;
  }
  return 0;
}

// The closed-form fit of the representative at node n with ``rel`` released
// and ``cnt`` pods removed (preemption.py:383 ok_closed).
__device__ __forceinline__ bool fits(const Args& a, int n, int i0, const long long* rel, int cnt) {
  const int R = a.d[D_R];
  const long long* demand = at<long long>(a, P_POD_REQ) + (long long)i0 * R;
  const long long* alloc = at<long long>(a, P_ALLOC) + (long long)n * R;
  const long long* req = at<long long>(a, P_REQ) + (long long)n * R;
  for (int r = 0; r < R; ++r) {
    const long long d = demand[r];
    if (d != 0 && d > alloc[r] - (req[r] - rel[r])) return false;
  }
  return at<int>(a, P_NUM_PODS)[n] - cnt + 1 <= at<int>(a, P_ALLOWED_PODS)[n];
}

// The masked slots of node n whose id column ``col`` (width w) equals id,
// counting only slots where ``gate`` (the same layout, or null) is > 0.
__device__ __forceinline__ int held(const Args& a, int col, int w, int n, unsigned long long mask,
                                    int id, const int* gate = nullptr) {
  const int V = a.d[D_V];
  const int* ids = at<int>(a, col);
  if (ids == nullptr || w == 0) return 0;
  int c = 0;
  for (int v = 0; v < V; ++v) {
    if (!((mask >> v) & 1ULL)) continue;
    const long long base = ((long long)n * V + v) * w;
    for (int b = 0; b < w; ++b) {
      if (ids[base + b] >= 0 && ids[base + b] == id && (gate == nullptr || gate[base + b] > 0)) ++c;
    }
  }
  return c;
}

// NodePorts on the state released by ``mask`` at node n: the triples'
// counts less the masked slots holding them, the keys' counts less the
// masked slots whose triple is set (preemption.py:298-307).
__device__ bool ports_ok(const Args& a, int n, int i0, unsigned long long mask) {
  const int QP = a.d[D_QP], PS = a.d[D_PS], V = a.d[D_V], N = a.d[D_N];
  if (QP == 0) return true;
  const int* tr = at<int>(a, P_POD_PORT_TRIPLES) + (long long)i0 * QP;
  const int* keys = at<int>(a, P_POD_PORT_KEYS) + (long long)i0 * QP;
  const int* wild = at<int>(a, P_POD_PORT_WILD) + (long long)i0 * QP;
  const unsigned char* is_wild = at<unsigned char>(a, P_POD_PORT_IS_WILD) + (long long)i0 * QP;
  const int* counts = at<int>(a, P_PORT_COUNTS);
  const int* kcounts = at<int>(a, P_PORTKEY_COUNTS);
  const int* vpt = at<int>(a, P_VF_PORT_TRIPLES);
  const int* vpk = at<int>(a, P_VF_PORT_KEYS);
  for (int q = 0; q < QP; ++q) {
    if (tr[q] < 0) continue;
    if (is_wild[q]) {
      const int k = keys[q] > 0 ? keys[q] : 0;
      int use = kcounts[(long long)k * N + n];
      if (vpt != nullptr) {
        for (int v = 0; v < V; ++v) {
          if (!((mask >> v) & 1ULL)) continue;
          const long long base = ((long long)n * V + v) * PS;
          for (int b = 0; b < PS; ++b) {
            if (vpt[base + b] >= 0 && (vpk[base + b] > 0 ? vpk[base + b] : 0) == k) --use;
          }
        }
      }
      if (use > 0) return false;
    } else {
      const int e = tr[q], w = wild[q] > 0 ? wild[q] : 0;
      const int exact = counts[(long long)e * N + n] - held(a, P_VF_PORT_TRIPLES, PS, n, mask, e);
      const int wu = counts[(long long)w * N + n] - held(a, P_VF_PORT_TRIPLES, PS, n, mask, w);
      if (exact > 0 || wu > 0) return false;
    }
  }
  return true;
}

// VolumeRestrictions on the state released by ``mask`` at node n.
__device__ bool vr_ok(const Args& a, int n, int i0, unsigned long long mask) {
  const int QD = a.d[D_QD], SD = a.d[D_SD], N = a.d[D_N];
  if (QD == 0) return true;
  const int* ids = at<int>(a, P_POD_DEV_IDS) + (long long)i0 * QD;
  const unsigned char* rw = at<unsigned char>(a, P_POD_DEV_RW) + (long long)i0 * QD;
  for (int q = 0; q < QD; ++q) {
    const int id = ids[q];
    if (id < 0) continue;
    const int uses = at<int>(a, P_DEV_COUNTS)[(long long)id * N + n] - held(a, P_VF_DEV_IDS, SD, n, mask, id);
    const int rw_uses = at<int>(a, P_DEV_RW_COUNTS)[(long long)id * N + n] -
                        held(a, P_VF_DEV_IDS, SD, n, mask, id, at<int>(a, P_VF_DEV_RW));
    if (rw[q] ? uses > 0 : rw_uses > 0) return false;
  }
  return true;
}

// NodeVolumeLimits on the state released by ``mask`` at node n.
__device__ bool nvl_ok(const Args& a, int n, int i0, unsigned long long mask) {
  const int QC = a.d[D_QC], SC = a.d[D_SC], V = a.d[D_V], N = a.d[D_N], DR = a.d[D_DR];
  if (QC == 0) return true;
  const int* ids = at<int>(a, P_POD_CSI_IDS) + (long long)i0 * QC;
  const int* drv = at<int>(a, P_POD_CSI_DRV) + (long long)i0 * QC;
  const int* cv = at<int>(a, P_CSIVOL_COUNTS);
  const int* vci = at<int>(a, P_VF_CSI_IDS);
  const int* vcd = at<int>(a, P_VF_CSI_DRV);
  bool newv[kMaxSlots];
  for (int q = 0; q < QC; ++q) {
    const int id = ids[q];
    newv[q] = id >= 0 && cv[(long long)id * N + n] - held(a, P_VF_CSI_IDS, SC, n, mask, id) <= 0;
  }
  for (int q = 0; q < QC; ++q) {
    const int d = drv[q];
    if (!newv[q] || d < 0 || d >= DR) continue;
    bool first = true;
    int new_cnt = 0;
    for (int q2 = 0; q2 < QC; ++q2) {
      if (newv[q2] && drv[q2] == d) {
        if (q2 < q) first = false;
        ++new_cnt;
      }
    }
    if (!first) continue;  // this driver was checked at its first volume
    long long used = at<int>(a, P_CSI_USED)[(long long)d * N + n];
    if (vci != nullptr) {
      for (int v = 0; v < V; ++v) {
        if (!((mask >> v) & 1ULL)) continue;
        const long long base = ((long long)n * V + v) * SC;
        for (int b = 0; b < SC; ++b) {
          const int id = vci[base + b];
          if (id < 0 || (vcd[base + b] > 0 ? vcd[base + b] : 0) != d) continue;
          if (cv[(long long)id * N + n] - held(a, P_VF_CSI_IDS, SC, n, mask, id) == 0) --used;
        }
      }
    }
    if (used + new_cnt > (long long)at<int>(a, P_CSI_LIMIT)[(long long)d * N + n]) return false;
  }
  return true;
}

// DynamicResources' hard filter at node n: no missing claim and no pin
// elsewhere (deleting pods moves no allocation).
__device__ bool dra_hard_ok(const Args& a, int n, int i0) {
  const int PIN = a.d[D_PIN];
  return dra_pins_ok(at<unsigned char>(a, P_POD_DRA_MISSING)[i0], at<int>(a, P_POD_DRA_PINS) + (long long)i0 * PIN,
                     PIN, at<int>(a, P_NAME_ID)[n]);
}

// Claim id's count at node n with the masked victims released.
__device__ __forceinline__ int dra_count(const Args& a, int n, unsigned long long mask, int id) {
  return at<int>(a, P_DRA_CLAIM_COUNTS)[(long long)id * a.d[D_N] + n] -
         held(a, P_VF_DRA_KID, a.d[D_SK], n, mask, id, at<int>(a, P_VF_DRA_FIRST));
}

// Pool d's devices at node n that the masked victims' crossing claims release.
__device__ long long dra_released(const Args& a, int n, unsigned long long mask, int d) {
  const int SK = a.d[D_SK], V = a.d[D_V];
  const int* kid = at<int>(a, P_VF_DRA_KID);
  if (kid == nullptr || SK == 0) return 0;
  const int* cid = at<int>(a, P_VF_DRA_CID);
  const int* cnt = at<int>(a, P_VF_DRA_CNT);
  long long out = 0;
  for (int v = 0; v < V; ++v) {
    if (!((mask >> v) & 1ULL)) continue;
    const long long base = ((long long)n * V + v) * SK;
    for (int b = 0; b < SK; ++b) {
      const int k = kid[base + b];
      if (k < 0 || (cid[base + b] > 0 ? cid[base + b] : 0) != d) continue;
      if (dra_count(a, n, mask, k) == 0) out += cnt[base + b];
    }
  }
  return out;
}

// DynamicResources on the state released by ``mask`` at node n.
__device__ bool dra_ok(const Args& a, int n, int i0, unsigned long long mask) {
  if (!dra_hard_ok(a, n, i0)) return false;
  const int QK = a.d[D_QK], N = a.d[D_N];
  if (QK == 0) return true;
  const long long o = (long long)i0 * QK;
  return dra_demand_fits(
      at<int>(a, P_POD_DRA_IDS) + o, at<int>(a, P_POD_DRA_CLS) + o, at<int>(a, P_POD_DRA_CNT) + o, QK, a.d[D_DC],
      at<int>(a, P_DRA_CAP), N, n, [&](int k) { return dra_count(a, n, mask, k); },
      [&](int d) { return at<int>(a, P_DRA_ALLOC)[(long long)d * N + n] - dra_released(a, n, mask, d); });
}

// The node-local search ops at node n on the state released by ``mask``.
__device__ __forceinline__ bool local_ok(const Args& a, int n, int i0, unsigned long long mask) {
  if (has_flag(a, S_PORTS) && !ports_ok(a, n, i0, mask)) return false;
  if (has_flag(a, S_VR) && !vr_ok(a, n, i0, mask)) return false;
  if (has_flag(a, S_NVL) && !nvl_ok(a, n, i0, mask)) return false;
  if (has_flag(a, S_DRA) && !dra_ok(a, n, i0, mask)) return false;
  return true;
}

// A ReadWriteOncePod-blocked representative evicts every lower-priority
// pod with no reprieve (preemption.py:371-381, res_fail).
__device__ __forceinline__ bool rwop_blocked(const Args& a, int i0) {
  return has_flag(a, S_VR) && at<unsigned char>(a, P_RWOP_OK)[i0] == 0;
}

}  // namespace search
