// preempt: the PostFilter dry-run of batched preemption.
//
// Replaces kubernetes_tpu/preemption.py:172-658 (build_preempt_pass):
// eval_one (:257-536), the step's pick (:499-520 at chunk 1, the rank split
// :542-600 at chunk > 1) and the commit (:601-617).  The JAX scan over
// chunks of preemptors becomes a host loop of launches per step:
//
//   preempt_eval   one launch a dry-run (kernels.eval_split): a group of L
//                  lanes a node (L the power of two >= V, at most 32),
//                  each lane holding its slots (lane, lane + L) in
//                  registers, in one of three modes (D_STEP):
//                  FULL      the whole dry-run of the representative
//                            preemptor: the release-independent filters
//                            (NodeUnschedulable, NodeName, node_filters bits
//                            of NodeAffinity, TaintToleration, VolumeBinding
//                            and VolumeZone, and DynamicResources' hard
//                            filter), the victims below its priority, phase 1 (the closed-form
//                            fit and the node-local search ops — NodePorts,
//                            VolumeRestrictions, NodeVolumeLimits,
//                            DynamicResources — with all of them released),
//                            the greedy reprieve in reverse slot order with
//                            the release carried incrementally (:435-455),
//                            unless the preemptor is ReadWriteOncePod-blocked
//                            (evict all, :371-381), and the five
//                            pickOneNodeForPreemption criteria over the final
//                            victim set.  Used when no domain op
//                            (InterPodAffinity, PodTopologySpread) searches:
//                            the node-local ops read only their node's
//                            column, so the reprieve stays in this launch.
//                            The node's victim id spans sit in the group's
//                            shared memory; every live count an op reads
//                            (at the representative's ids and at the
//                            victims' own CSI and claim ids) is gathered
//                            once, in parallel over the lanes, and carried
//                            less the masked slots holding it; a count a
//                            tentative mask reads is that carry moved by
//                            what slot s holds, joined over the lanes.
//                  PROLOGUE  the carry of a search (preempt_search.cu): the
//                            masked victims (all below the priority), their
//                            release and count, the base flag.
//                  TAIL      the criteria over the carry the search left.
//                  The representative is the first valid mate (:564); under
//                  the speculative chain valid = eligible && pick < 0, read
//                  from the main pass's picks (:146 _chain_speculative);
//                  each warp finds it by its own ballots.
//   preempt_pick   one launch a pick (preempt_pick_kernel below): the
//                  possible nodes in the exact lexicographic order of the
//                  five criteria (fewest PDB violations, lowest max victim
//                  priority, smallest priority sum, fewest victims, latest
//                  start key), the lowest row last, and only the first
//                  min(C, N) ranks: at chunk 1 an argmin, above it a top-C
//                  selection over a cluster that splits the node axis.  Then
//                  each eligible same-signature mate takes the node at its
//                  cumsum rank; at chunk > 1 a valid mate left without a
//                  node defers (-2).
//   preempt_commit one thread per mate: subtracts the released requests,
//                  non-zero requests and victim count at the picked row of
//                  the carried state and raises the chosen victims'
//                  priorities to INT32_MAX (mates without a pick write
//                  nothing).
//
// Exactness: integer arithmetic throughout (requests and release sums
// int64, priorities int32, the PDB count an exact integer count); the start
// key is (int64)(-min_start * 1e6), truncated toward zero, over the
// victims at the maximal priority, -2^61 when none has a finite start.
//
// Bound: preempt_eval reads each node's row and its victims' priorities,
// the lower slots' requests, start times and PDB bits, the slots' port,
// device, CSI and claim ids where those ops search and the counts at them,
// and writes the criteria; bytes-bound.  Its time is a node's chain of
// dependent reads and reprieve steps: a group a node spreads the grid
// over every SM, the reads go out in rounds, each read once.
// preempt_pick reads the possible flags and the possible nodes' five
// criteria once; its time is the launch, the sort network's stages and
// the cluster barriers (latency).
// preempt_commit touches C rows; launch latency.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "preempt_search.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace search;

constexpr int kThreads = 256;

// ---- preempt_eval ----------------------------------------------------------

constexpr int kEvalMaxThreads = 256;  // kernels.EVAL_THREADS: the launch bound (two blocks an SM:
                                      // 128 registers a thread, a one-wave grid at N = 8192, V = 8)
constexpr int kRepBatch = 4;          // rounds of 32 mates a warp loads before its ballots

// Shared memory of a launch, in ints: one region a node group, then the
// representative's op slots once a warp (each warp finds the
// representative itself).  A node group's region holds node n's victims'
// requests (V x R int64, first: 8-byte aligned, every region an even
// number of ints; not in TAIL), and in FULL its victim id spans (V x width
// ints each, slot-major, as the tables lay them out), the live counts at
// the victims' own CSI and claim ids with the masked slots holding each
// (the crossing rules), and a counter a representative slot: its live
// count less the masked slots holding its id.  kernels.eval_smem mirrors
// it.  The launcher computes it and passes it with the launch: each offset
// is a sum over the widths before it, which the kernel would otherwise
// recompute at each use once registers run short.
struct EvalLayout {
  int r_pt, r_pk, r_pw, r_pi;  // ports: triples, keys and wild triples (clamped at 0), is_wild
  int r_vi, r_vw;              // VolumeRestrictions: device ids, read-write
  int r_ci, r_cd;              // NodeVolumeLimits: CSI ids, drivers
  int r_ki, r_kc, r_kn;        // DynamicResources: claim ids, pools, device counts
  int rep_ints;
  int rq;                            // the victims' requests (int64)
  int pt, pk, pa, pb;                // port triples, keys (clamped); exact and wildcard counters
  int vi, vw, vc;                    // device ids, read-write gates; counters
  int ci, cd, cl, ch, cD, cU, cL;    // CSI ids, drivers (clamped), live, held; counters, used, limit
  int ki, kc, kn, kf, kl, kh, kK, kA, kC;  // claim ids, pools (clamped), devices, first, live, held;
                                           // counters, dra_alloc, dra_cap at the slot's pool
  int group_ints;
};

__host__ __device__ inline EvalLayout eval_layout(const int* d) {
  const bool full = d[D_STEP] == FULL;
  const int V = d[D_V];
  const int ps = full ? d[D_PS] : 0, sd = full ? d[D_SD] : 0, sc = full ? d[D_SC] : 0, sk = full ? d[D_SK] : 0;
  const int qp = full ? d[D_QP] : 0, qd = full ? d[D_QD] : 0, qc = full ? d[D_QC] : 0, qk = full ? d[D_QK] : 0;
  EvalLayout l;
  int o = 0;
  l.r_pt = o; o += qp; l.r_pk = o; o += qp; l.r_pw = o; o += qp; l.r_pi = o; o += qp;
  l.r_vi = o; o += qd; l.r_vw = o; o += qd;
  l.r_ci = o; o += qc; l.r_cd = o; o += qc;
  l.r_ki = o; o += qk; l.r_kc = o; o += qk; l.r_kn = o; o += qk;
  l.rep_ints = o;
  o = 0;
  l.rq = o;
  o += d[D_STEP] == TAIL ? 0 : 2 * V * d[D_R];
  l.pt = o; o += V * ps; l.pk = o; o += V * ps; l.pa = o; o += qp; l.pb = o; o += qp;
  l.vi = o; o += V * sd; l.vw = o; o += V * sd; l.vc = o; o += qd;
  l.ci = o; o += V * sc; l.cd = o; o += V * sc; l.cl = o; o += V * sc; l.ch = o; o += V * sc;
  l.cD = o; o += qc; l.cU = o; o += qc; l.cL = o; o += qc;
  l.ki = o; o += V * sk; l.kc = o; o += V * sk; l.kn = o; o += V * sk; l.kf = o; o += V * sk;
  l.kl = o; o += V * sk; l.kh = o; o += V * sk;
  l.kK = o; o += qk; l.kA = o; o += qk; l.kC = o; o += qk;
  l.group_ints = (o + 1) & ~1;
  return l;
}

__host__ __device__ inline long long eval_smem_bytes(const EvalLayout& l, int warps, int nodes) {
  return 4LL * ((long long)warps * l.rep_ints + (long long)nodes * l.group_ints);
}

// A node's group of L lanes inside its warp.  Every group operation is a
// full-warp intrinsic (a shuffle of width L; one ballot, each group taking
// its own bits) that every lane of the warp reaches in step: with a tile's
// own mask, which differs from group to group, the compiler runs each
// collective once per distinct mask of the warp.  Each starts with a warp
// barrier, so that lanes a data-dependent branch left apart meet first:
// a diverged warp runs a collective once per converged subset.
template <int L>
struct Lanes {
  static constexpr unsigned int kBits = L == 32 ? 0xffffffffu : (1u << L) - 1u;
  int lane;   // rank in the group
  int first;  // the warp lane of rank 0

  __device__ __forceinline__ unsigned int ballot(bool p) const {
    __syncwarp();
    return (__ballot_sync(0xffffffffu, p) >> first) & kBits;
  }
  __device__ __forceinline__ bool all(bool p) const { return ballot(!p) == 0; }
  // A sum, max or min over the group's lanes, in every lane.
  template <class T, class Op>
  __device__ __forceinline__ T reduce(T x, Op op) const {
    __syncwarp();
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, off, L));
    return x;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

struct Sum {
  template <class T>
  __device__ __forceinline__ T operator()(T x, T y) const { return x + y; }
};
struct Max {
  template <class T>
  __device__ __forceinline__ T operator()(T x, T y) const { return y > x ? y : x; }
};
struct Min {
  template <class T>
  __device__ __forceinline__ T operator()(T x, T y) const { return y < x ? y : x; }
};

constexpr int kSpanRegs = 2;  // entries of each victim id table a lane stages in registers
constexpr int kReqRegs = 4;   // entries of the node's requests a lane stages in registers

constexpr int kStepRegs = 2;  // entries of slot s's id tables a step holds in registers

// Slot s's first kStepRegs entries of each victim id table (-1 ids, 0
// gates past the width), read once a reprieve step.
struct SlotCache {
  int s;
  int pt[kStepRegs], pk[kStepRegs], vi[kStepRegs], vw[kStepRegs], ci[kStepRegs], ki[kStepRegs], kf[kStepRegs];
};

constexpr int kOwnRegs = 2;  // entries of a lane's slot of the CSI and claim tables held in registers

// A lane's own slots' CSI and claim entries b < kOwnRegs (the rest stay in
// the group's span): ids, drivers or pools, devices, the live counts at
// the ids and the masked slots holding them (carried over the steps).
template <int L>
struct OwnRegs {
  static constexpr int kJ = L == 32 ? 2 : 1;
  int ci[kJ][kOwnRegs], cd[kJ][kOwnRegs], cl[kJ][kOwnRegs], ch[kJ][kOwnRegs];
  int ki[kJ][kOwnRegs], kc[kJ][kOwnRegs], kn[kJ][kOwnRegs], kl[kJ][kOwnRegs], kh[kJ][kOwnRegs];
};

// One slot q of each of the representative's ops, and the live counts at
// them.
struct RepSlot {
  int pt, pk, pw, pi, vi, vw, ci, cd, ki, kc;
};
struct RepCounts {
  int pa, pb, vc, cD, cU, cL, kK, kA, kC;
};

// A lane's staged entries of node n's victim id tables (entry lane + k L),
// and the live counts at its CSI and claim ids.
struct EvalSpans {
  int ci[kSpanRegs], ki[kSpanRegs], cl[kSpanRegs], kl[kSpanRegs];
  int pt[kSpanRegs], pk[kSpanRegs], vi[kSpanRegs], vw[kSpanRegs], cd[kSpanRegs], kc[kSpanRegs], kn[kSpanRegs],
      kf[kSpanRegs];
};

// One node's dry-run state in its group: what the node-local search ops
// read.  Every op evaluates the state released by ``tent`` = the masked
// slots less slot s (s < 0: none less); the counters hold the masked slots'
// release, so slot s's own ids (read by every lane from the group's span)
// move each count by what s holds.
template <int L>
struct EvalOps {
  static constexpr int kJ = L == 32 ? 2 : 1;
  const Args& a;
  const EvalLayout lay;  // (a kernel parameter: its fields are constant-bank operands)
  const Lanes<L>& g;
  const int* rep;  // the representative's op slots (the warp's copy)
  int* grp;        // this group's region
  int n, N, V, lane;

  __device__ __forceinline__ bool mine(unsigned long long m, int j) const {
    const int v = lane + j * L;
    return v < V && ((m >> v) & 1ULL);
  }

  // Slot s's entries in registers (sc.s < 0: no slot).
  __device__ __forceinline__ SlotCache cache(int s) const {
    const int* d = a.d;
    SlotCache c;
    c.s = s;
    const int PS = d[D_PS], SD = d[D_SD], SC = d[D_SC], SK = d[D_SK];
#pragma unroll
    for (int k = 0; k < kStepRegs; ++k) {
      c.pt[k] = k < PS ? grp[lay.pt + s * PS + k] : -1;
      c.pk[k] = k < PS ? grp[lay.pk + s * PS + k] : -1;
      c.vi[k] = k < SD ? grp[lay.vi + s * SD + k] : -1;
      c.vw[k] = k < SD ? grp[lay.vw + s * SD + k] : 0;
      c.ci[k] = k < SC ? grp[lay.ci + s * SC + k] : -1;
      c.ki[k] = k < SK ? grp[lay.ki + s * SK + k] : -1;
      c.kf[k] = k < SK ? grp[lay.kf + s * SK + k] : 0;
    }
    return c;
  }

  // Slot sc.s's entries of span ``ids`` (width w) equal to id, gated by
  // ``gate`` (the span's offset, -1: none): the cached ones (``cid``,
  // ``cgate``), then the rest from the span.
  __device__ __forceinline__ int at_s(const SlotCache& sc, const int (&cid)[kStepRegs],
                                      const int (&cgate)[kStepRegs], int w, int ids, int id, int gate = -1) const {
    const int s = sc.s;
    if (s < 0) return 0;
    int c = 0;
#pragma unroll
    for (int k = 0; k < kStepRegs; ++k) c += cid[k] == id && (gate < 0 || cgate[k] > 0);
    for (int b = kStepRegs; b < w; ++b) {
      if (grp[ids + s * w + b] == id && (gate < 0 || grp[gate + s * w + b] > 0)) ++c;
    }
    return c;
  }

  // The masked entries of this lane's own slots in span ``ids`` equal to id.
  __device__ __forceinline__ int own(unsigned long long m, int w, int ids, int id, int gate = -1) const {
    int c = 0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (!mine(m, j)) continue;
      const int v = lane + j * L;
      for (int b = 0; b < w; ++b) {
        if (grp[ids + v * w + b] == id && (gate < 0 || grp[gate + v * w + b] > 0)) ++c;
      }
    }
    return c;
  }

  // One table's first kSpanRegs entries of this lane (entry lane + k L of
  // node n's span, -1 past it), read into registers.
  __device__ __forceinline__ void stage(int ptr, int w, int (&x)[kSpanRegs]) const {
    const int len = V * w;
    const int* src = len ? at<int>(a, ptr) + (long long)n * len : nullptr;
#pragma unroll
    for (int k = 0; k < kSpanRegs; ++k) {
      const int e = lane + k * L;
      x[k] = e < len ? src[e] : -1;
    }
  }

  // Round 1: the victims' id tables.
  __device__ __forceinline__ void stage_spans(EvalSpans& sp) const {
    const int* d = a.d;
    stage(P_VF_CSI_IDS, d[D_SC], sp.ci);
    stage(P_VF_DRA_KID, d[D_SK], sp.ki);
    stage(P_VF_PORT_TRIPLES, d[D_PS], sp.pt);
    stage(P_VF_PORT_KEYS, d[D_PS], sp.pk);
    stage(P_VF_DEV_IDS, d[D_SD], sp.vi);
    stage(P_VF_DEV_RW, d[D_SD], sp.vw);
    stage(P_VF_CSI_DRV, d[D_SC], sp.cd);
    stage(P_VF_DRA_CID, d[D_SK], sp.kc);
    stage(P_VF_DRA_CNT, d[D_SK], sp.kn);
    stage(P_VF_DRA_FIRST, d[D_SK], sp.kf);
  }

  // Round 2: the counts at the victims' own CSI and claim ids.
  __device__ __forceinline__ void stage_counts(EvalSpans& sp) const {
#pragma unroll
    for (int k = 0; k < kSpanRegs; ++k) {
      sp.cl[k] = sp.ci[k] >= 0 ? at<int>(a, P_CSIVOL_COUNTS)[(long long)sp.ci[k] * N + n] : 0;
      sp.kl[k] = sp.ki[k] >= 0 ? at<int>(a, P_DRA_CLAIM_COUNTS)[(long long)sp.ki[k] * N + n] : 0;
    }
  }

  __device__ __forceinline__ void put(int off, int w, const int (&x)[kSpanRegs], bool clamp) const {
#pragma unroll
    for (int k = 0; k < kSpanRegs; ++k) {
      const int e = lane + k * L;
      if (e < V * w) grp[off + e] = clamp && x[k] < 0 ? 0 : x[k];
    }
  }

  // The entries of one table past the staged ones, copied here.
  __device__ __forceinline__ void copy_rest(int ptr, int w, int off, bool clamp, int counts = -1,
                                            int live_off = 0) const {
    const int* src = at<int>(a, ptr) + (long long)n * V * w;
    for (int e = lane + kSpanRegs * L; e < V * w; e += L) {
      const int x = src[e];
      grp[off + e] = clamp && x < 0 ? 0 : x;
      if (counts >= 0) grp[live_off + e] = x >= 0 ? at<int>(a, counts)[(long long)x * N + n] : 0;
    }
  }

  // Node n's victim id spans and the counts at the victims' own CSI and
  // claim ids into the group's region.
  __device__ __forceinline__ void store(const EvalSpans& sp) const {
    const int* d = a.d;
    const int PS = d[D_PS], SD = d[D_SD], SC = d[D_SC], SK = d[D_SK];
    put(lay.pt, PS, sp.pt, false);
    put(lay.pk, PS, sp.pk, true);
    put(lay.vi, SD, sp.vi, false);
    put(lay.vw, SD, sp.vw, false);
    put(lay.ci, SC, sp.ci, false);
    put(lay.cd, SC, sp.cd, true);
    put(lay.cl, SC, sp.cl, false);
    put(lay.ki, SK, sp.ki, false);
    put(lay.kc, SK, sp.kc, true);
    put(lay.kn, SK, sp.kn, false);
    put(lay.kf, SK, sp.kf, false);
    put(lay.kl, SK, sp.kl, false);
    if (V * max(max(PS, SD), max(SC, SK)) <= kSpanRegs * L) return;
    if (PS) {
      copy_rest(P_VF_PORT_TRIPLES, PS, lay.pt, false);
      copy_rest(P_VF_PORT_KEYS, PS, lay.pk, true);
    }
    if (SD) {
      copy_rest(P_VF_DEV_IDS, SD, lay.vi, false);
      copy_rest(P_VF_DEV_RW, SD, lay.vw, false);
    }
    if (SC) {
      copy_rest(P_VF_CSI_IDS, SC, lay.ci, false, P_CSIVOL_COUNTS, lay.cl);
      copy_rest(P_VF_CSI_DRV, SC, lay.cd, true);
    }
    if (SK) {
      copy_rest(P_VF_DRA_KID, SK, lay.ki, false, P_DRA_CLAIM_COUNTS, lay.kl);
      copy_rest(P_VF_DRA_CID, SK, lay.kc, true);
      copy_rest(P_VF_DRA_CNT, SK, lay.kn, false);
      copy_rest(P_VF_DRA_FIRST, SK, lay.kf, false);
    }
  }

  // The representative's slot q of each op in the warp's copy (-1 past an
  // op's slots).
  __device__ __forceinline__ RepSlot slot(int q) const {
    const int* d = a.d;
    RepSlot r;
    const bool p = q < d[D_QP], v = q < d[D_QD], c = q < d[D_QC], k = q < d[D_QK];
    r.pt = p ? rep[lay.r_pt + q] : -1;
    r.pk = p ? rep[lay.r_pk + q] : 0;
    r.pw = p ? rep[lay.r_pw + q] : 0;
    r.pi = p ? rep[lay.r_pi + q] : 0;
    r.vi = v ? rep[lay.r_vi + q] : -1;
    r.vw = v ? rep[lay.r_vw + q] : 0;
    r.ci = c ? rep[lay.r_ci + q] : -1;
    r.cd = c ? rep[lay.r_cd + q] : -1;
    r.ki = k ? rep[lay.r_ki + q] : -1;
    r.kc = k ? rep[lay.r_kc + q] : -1;
    return r;
  }

  // The live counts at the representative's slot q of each op, read
  // together.
  __device__ __forceinline__ RepCounts fetch(const RepSlot& r) const {
    const int DR = a.d[D_DR], DC = a.d[D_DC];
    // (predicated loads, no branch: they all go out together)
    RepCounts c;
    const bool port = r.pt >= 0, wild = port && r.pi, exact = port && !r.pi;
    const int* pa_src = at<int>(a, wild ? P_PORTKEY_COUNTS : P_PORT_COUNTS);
    c.pa = port ? pa_src[(long long)(wild ? r.pk : r.pt) * N + n] : 0;
    c.pb = exact ? at<int>(a, P_PORT_COUNTS)[(long long)r.pw * N + n] : 0;
    c.vc = r.vi >= 0 ? at<int>(a, r.vw ? P_DEV_COUNTS : P_DEV_RW_COUNTS)[(long long)r.vi * N + n] : 0;
    c.cD = r.ci >= 0 ? at<int>(a, P_CSIVOL_COUNTS)[(long long)r.ci * N + n] : 0;
    const bool drv = r.cd >= 0 && r.cd < DR, pool = r.ki >= 0 && r.kc >= 0 && r.kc < DC;
    c.cU = drv ? at<int>(a, P_CSI_USED)[(long long)r.cd * N + n] : 0;
    c.cL = drv ? at<int>(a, P_CSI_LIMIT)[(long long)r.cd * N + n] : 0;
    c.kK = r.ki >= 0 ? at<int>(a, P_DRA_CLAIM_COUNTS)[(long long)r.ki * N + n] : 0;
    c.kA = pool ? at<int>(a, P_DRA_ALLOC)[(long long)r.kc * N + n] : 0;
    c.kC = pool ? at<int>(a, P_DRA_CAP)[(long long)r.kc * N + n] : 0;
    return c;
  }

  // Slot q's live counts into the group's counters.
  __device__ __forceinline__ void put(int q, const RepCounts& c) const {
    const int* d = a.d;
    if (q < d[D_QP]) {
      grp[lay.pa + q] = c.pa;
      grp[lay.pb + q] = c.pb;
    }
    if (q < d[D_QD]) grp[lay.vc + q] = c.vc;
    if (q < d[D_QC]) {
      grp[lay.cD + q] = c.cD;
      grp[lay.cU + q] = c.cU;
      grp[lay.cL + q] = c.cL;
    }
    if (q < d[D_QK]) {
      grp[lay.kK + q] = c.kK;
      grp[lay.kA + q] = c.kA;
      grp[lay.kC + q] = c.kC;
    }
  }

  // The live counts at the representative's slots past the lanes' own
  // (read in round 2: lane q's), the victims' crossing counts and the
  // counters at the phase-1 mask.
  // The masked entries (gated) of span ``ids`` (width w) equal to id; 0
  // for id -1.
  __device__ __forceinline__ int walk(unsigned long long mask, int w, int ids, int id, int gate) const {
    int h = 0;
    for (unsigned long long m = id >= 0 ? mask : 0; m; m &= m - 1) {
      const int t = __ffsll((long long)m) - 1;
      for (int b = 0; b < w; ++b) h += grp[ids + t * w + b] == id && (gate < 0 || grp[gate + t * w + b] > 0);
    }
    return h;
  }

  __device__ __forceinline__ void count(unsigned long long mask, bool live, OwnRegs<L>& o) const {
    const int* d = a.d;
    const int PS = d[D_PS], SD = d[D_SD], SC = d[D_SC], SK = d[D_SK];
    const int QP = d[D_QP], QD = d[D_QD], QC = d[D_QC], QK = d[D_QK];
    for (int q = live ? lane + L : QP + QD + QC + QK; q < max(max(QP, QD), max(QC, QK)); q += L) put(q, fetch(slot(q)));
    g.sync();  // the spans and counters whole
    // The lane's own entries: the first kOwnRegs of each slot into
    // registers, each with the masked entries holding its id (a walk of
    // the group's masked ids); the rest in the span.
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int v = lane + j * L;
#pragma unroll
      for (int k = 0; k < kOwnRegs; ++k) {
        const bool c = SC && v < V && k < SC, kk = SK && v < V && k < SK;
        o.ci[j][k] = c ? grp[lay.ci + v * SC + k] : -1;
        o.cd[j][k] = c ? grp[lay.cd + v * SC + k] : 0;
        o.cl[j][k] = c ? grp[lay.cl + v * SC + k] : 0;
        o.ki[j][k] = kk ? grp[lay.ki + v * SK + k] : -1;
        o.kc[j][k] = kk ? grp[lay.kc + v * SK + k] : 0;
        o.kn[j][k] = kk ? grp[lay.kn + v * SK + k] : 0;
        o.kl[j][k] = kk ? grp[lay.kl + v * SK + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < kOwnRegs; ++k) {
        o.ch[j][k] = SC ? walk(mask, SC, lay.ci, o.ci[j][k], -1) : 0;
        o.kh[j][k] = SK ? walk(mask, SK, lay.ki, o.ki[j][k], lay.kf) : 0;
      }
      for (int b = kOwnRegs; v < V && b < SC; ++b) {
        grp[lay.ch + v * SC + b] = walk(mask, SC, lay.ci, grp[lay.ci + v * SC + b], -1);
      }
      for (int b = kOwnRegs; v < V && b < SK; ++b) {
        grp[lay.kh + v * SK + b] = walk(mask, SK, lay.ki, grp[lay.ki + v * SK + b], lay.kf);
      }
    }
    // Each counter less the masked slots holding its id: a reduction over
    // the lanes, each counting its own slots.
    for (int q = 0; q < QP; ++q) {
      const int tr = rep[lay.r_pt + q];
      if (tr < 0) continue;
      int x = 0, y = 0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (!mine(mask, j)) continue;
        const int v = lane + j * L;
        for (int b = 0; b < PS; ++b) {
          const int t = grp[lay.pt + v * PS + b];
          if (t < 0) continue;
          if (rep[lay.r_pi + q]) {
            x += grp[lay.pk + v * PS + b] == rep[lay.r_pk + q];
          } else {
            x += t == tr;
            y += t == rep[lay.r_pw + q];
          }
        }
      }
      x = g.reduce(x, Sum());
      y = g.reduce(y, Sum());
      if (lane == q % L) {
        grp[lay.pa + q] -= x;
        grp[lay.pb + q] -= y;
      }
    }
    for (int q = 0; q < QD; ++q) {
      const int id = rep[lay.r_vi + q];
      if (id < 0) continue;
      const int x = g.reduce(own(mask, SD, lay.vi, id, rep[lay.r_vw + q] ? -1 : lay.vw), Sum());
      if (lane == q % L) grp[lay.vc + q] -= x;
    }
    for (int q = 0; q < QC; ++q) {
      const int id = rep[lay.r_ci + q];
      if (id < 0) continue;
      const int x = g.reduce(own(mask, SC, lay.ci, id), Sum());
      if (lane == q % L) grp[lay.cD + q] -= x;
    }
    for (int q = 0; q < QK; ++q) {
      const int id = rep[lay.r_ki + q];
      if (id < 0) continue;
      const int x = g.reduce(own(mask, SK, lay.ki, id, lay.kf), Sum());
      if (lane == q % L) grp[lay.kK + q] -= x;
    }
    g.sync();
  }

  // NodePorts (preempt_search.cuh ports_ok): each lane its own slots q.
  __device__ __forceinline__ bool ports_ok(const SlotCache& sc) const {
    const int QP = a.d[D_QP], PS = a.d[D_PS];
    bool ok = true;
    for (int q = lane; q < QP; q += L) {
      const int tr = rep[lay.r_pt + q];
      if (tr < 0) continue;
      int x = grp[lay.pa + q], y = grp[lay.pb + q];
      if (rep[lay.r_pi + q]) {
        const int key = rep[lay.r_pk + q], s = sc.s;
#pragma unroll
        for (int k = 0; k < kStepRegs; ++k) x += s >= 0 && sc.pt[k] >= 0 && sc.pk[k] == key;
        for (int b = kStepRegs; s >= 0 && b < PS; ++b) {
          x += grp[lay.pt + s * PS + b] >= 0 && grp[lay.pk + s * PS + b] == key;
        }
        ok = ok && x <= 0;
      } else {
        x += at_s(sc, sc.pt, sc.pt, PS, lay.pt, tr);
        y += at_s(sc, sc.pt, sc.pt, PS, lay.pt, rep[lay.r_pw + q]);
        ok = ok && x <= 0 && y <= 0;
      }
    }
    return g.all(ok);
  }

  // VolumeRestrictions (vr_ok): the read-write uses, or all, of each
  // wanted device.
  __device__ __forceinline__ bool vr_ok(const SlotCache& sc) const {
    const int QD = a.d[D_QD], SD = a.d[D_SD];
    bool ok = true;
    for (int q = lane; q < QD; q += L) {
      const int id = rep[lay.r_vi + q];
      if (id < 0) continue;
      ok = ok && grp[lay.vc + q] + at_s(sc, sc.vi, sc.vw, SD, lay.vi, id, rep[lay.r_vw + q] ? -1 : lay.vw) <= 0;
    }
    return g.all(ok);
  }

  // NodeVolumeLimits (nvl_ok): the new volumes per driver against the
  // driver's attachments less those the released victims free (a masked
  // volume crosses when its count less the masked slots holding it is 0).
  // Each driver slot's freed count is reduced whatever the node's new
  // volumes (the warp's control flow stays one).
  __device__ __forceinline__ bool nvl_ok(unsigned long long tent, const SlotCache& sc, const OwnRegs<L>& o) const {
    const int QC = a.d[D_QC], SC = a.d[D_SC], DR = a.d[D_DR];
    unsigned int newv = 0;
    for (int q = 0; q < QC; ++q) {
      const int id = rep[lay.r_ci + q];
      if (id >= 0 && grp[lay.cD + q] + at_s(sc, sc.ci, sc.ci, SC, lay.ci, id) <= 0) newv |= 1u << q;
    }
    bool ok = true;
    for (int q = 0; q < QC; ++q) {
      const int dr = rep[lay.r_cd + q];
      if (dr < 0 || dr >= DR) continue;
      bool first = ((newv >> q) & 1u) != 0;  // the driver's first new volume
      int new_cnt = 0;
      for (int q2 = 0; q2 < QC; ++q2) {
        if (((newv >> q2) & 1u) && rep[lay.r_cd + q2] == dr) {
          first = first && q2 >= q;
          ++new_cnt;
        }
      }
      int freed = 0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (!mine(tent, j)) continue;
        const int v = lane + j * L;
#pragma unroll
        for (int k = 0; k < kOwnRegs; ++k) {
          const int id = o.ci[j][k];
          if (id < 0 || o.cd[j][k] != dr) continue;
          freed += o.cl[j][k] - (o.ch[j][k] - at_s(sc, sc.ci, sc.ci, SC, lay.ci, id)) == 0;
        }
        for (int b = kOwnRegs; b < SC; ++b) {
          const int e = v * SC + b, id = grp[lay.ci + e];
          if (id < 0 || grp[lay.cd + e] != dr) continue;
          freed += grp[lay.cl + e] - (grp[lay.ch + e] - at_s(sc, sc.ci, sc.ci, SC, lay.ci, id)) == 0;
        }
      }
      freed = g.reduce(freed, Sum());
      if (first && (long long)grp[lay.cU + q] - freed + new_cnt > (long long)grp[lay.cL + q]) ok = false;
    }
    return ok;
  }

  // DynamicResources (dra_ok): per pool, the devices of the wanted claims
  // no pod of the node reserves once released, against the pool's
  // capacity less the devices the released victims' crossing claims free;
  // ``hard``: its hard filter.
  __device__ __forceinline__ bool dra_ok(unsigned long long tent, const SlotCache& sc, const OwnRegs<L>& o,
                                         bool hard) const {
    const int QK = a.d[D_QK], SK = a.d[D_SK], DC = a.d[D_DC];
    bool ok = hard;
    for (int q = 0; q < QK; ++q) {
      const int id = rep[lay.r_ki + q], pool = rep[lay.r_kc + q];
      if (id < 0 || pool < 0 || pool >= DC) continue;
      bool dup = false;
      for (int q2 = 0; q2 < q; ++q2) dup = dup || (rep[lay.r_ki + q2] >= 0 && rep[lay.r_kc + q2] == pool);
      if (dup) continue;  // this pool was checked at its first slot
      long long need = 0;
      for (int q2 = 0; q2 < QK; ++q2) {
        const int id2 = rep[lay.r_ki + q2];
        if (id2 < 0 || rep[lay.r_kc + q2] != pool) continue;
        if (grp[lay.kK + q2] + at_s(sc, sc.ki, sc.kf, SK, lay.ki, id2, lay.kf) <= 0) need += rep[lay.r_kn + q2];
      }
      long long freed = 0;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (!mine(tent, j)) continue;
        const int v = lane + j * L;
#pragma unroll
        for (int k = 0; k < kOwnRegs; ++k) {
          const int id2 = o.ki[j][k];
          if (id2 < 0 || o.kc[j][k] != pool) continue;
          if (o.kl[j][k] - (o.kh[j][k] - at_s(sc, sc.ki, sc.kf, SK, lay.ki, id2, lay.kf)) == 0) freed += o.kn[j][k];
        }
        for (int b = kOwnRegs; b < SK; ++b) {
          const int e = v * SK + b, id2 = grp[lay.ki + e];
          if (id2 < 0 || grp[lay.kc + e] != pool) continue;
          if (grp[lay.kl + e] - (grp[lay.kh + e] - at_s(sc, sc.ki, sc.kf, SK, lay.ki, id2, lay.kf)) == 0) {
            freed += grp[lay.kn + e];
          }
        }
      }
      freed = g.reduce(freed, Sum());
      if (need != 0 && (long long)grp[lay.kA + q] - freed + need > (long long)grp[lay.kC + q]) ok = false;
    }
    return ok;
  }

  // The node-local search ops on the state released by ``tent``, every op
  // evaluated (no early exit: the warp's lanes stay in step); ``hard`` is
  // DynamicResources' hard filter.
  __device__ __forceinline__ bool ok(unsigned long long tent, const SlotCache& sc, const OwnRegs<L>& o,
                                     bool hard) const {
    bool ok = true;
    if (has_flag(a, S_PORTS)) ok = ports_ok(sc) && ok;
    if (has_flag(a, S_VR)) ok = vr_ok(sc) && ok;
    if (has_flag(a, S_NVL)) ok = nvl_ok(tent, sc, o) && ok;
    if (has_flag(a, S_DRA)) ok = dra_ok(tent, sc, o, hard) && ok;
    return ok;
  }

  // Slot sc.s reprieved where ``taken``: every count moves by what it
  // holds.  Every lane of the warp calls it at every step.
  __device__ __forceinline__ void take(const SlotCache& sc, bool taken, OwnRegs<L>& o) const {
    const int* d = a.d;
    const int PS = d[D_PS], SD = d[D_SD], SC = d[D_SC], SK = d[D_SK];
    const int QP = d[D_QP], QD = d[D_QD], QC = d[D_QC], QK = d[D_QK];
    g.sync();  // every lane's reads of this step done
    for (int q = taken ? lane : QP; q < QP; q += L) {
      const int tr = rep[lay.r_pt + q];
      if (tr < 0) continue;
      if (rep[lay.r_pi + q]) {
        const int key = rep[lay.r_pk + q], s = sc.s;
        int x = 0;
#pragma unroll
        for (int k = 0; k < kStepRegs; ++k) x += sc.pt[k] >= 0 && sc.pk[k] == key;
        for (int b = kStepRegs; b < PS; ++b) x += grp[lay.pt + s * PS + b] >= 0 && grp[lay.pk + s * PS + b] == key;
        grp[lay.pa + q] += x;
      } else {
        grp[lay.pa + q] += at_s(sc, sc.pt, sc.pt, PS, lay.pt, tr);
        grp[lay.pb + q] += at_s(sc, sc.pt, sc.pt, PS, lay.pt, rep[lay.r_pw + q]);
      }
    }
    for (int q = taken ? lane : QD; q < QD; q += L) {
      const int id = rep[lay.r_vi + q];
      if (id >= 0) grp[lay.vc + q] += at_s(sc, sc.vi, sc.vw, SD, lay.vi, id, rep[lay.r_vw + q] ? -1 : lay.vw);
    }
    for (int q = taken ? lane : QC; q < QC; q += L) {
      const int id = rep[lay.r_ci + q];
      if (id >= 0) grp[lay.cD + q] += at_s(sc, sc.ci, sc.ci, SC, lay.ci, id);
    }
    for (int q = taken ? lane : QK; q < QK; q += L) {
      const int id = rep[lay.r_ki + q];
      if (id >= 0) grp[lay.kK + q] += at_s(sc, sc.ki, sc.kf, SK, lay.ki, id, lay.kf);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int v = lane + j * L;
      if (!taken || v >= V) continue;
#pragma unroll
      for (int k = 0; k < kOwnRegs; ++k) {
        if (o.ci[j][k] >= 0) o.ch[j][k] -= at_s(sc, sc.ci, sc.ci, SC, lay.ci, o.ci[j][k]);
        if (o.ki[j][k] >= 0) o.kh[j][k] -= at_s(sc, sc.ki, sc.kf, SK, lay.ki, o.ki[j][k], lay.kf);
      }
      for (int b = kOwnRegs; b < SC; ++b) {
        const int id = grp[lay.ci + v * SC + b];
        if (id >= 0) grp[lay.ch + v * SC + b] -= at_s(sc, sc.ci, sc.ci, SC, lay.ci, id);
      }
      for (int b = kOwnRegs; b < SK; ++b) {
        const int id = grp[lay.ki + v * SK + b];
        if (id >= 0) grp[lay.kh + v * SK + b] -= at_s(sc, sc.ki, sc.kf, SK, lay.ki, id, lay.kf);
      }
    }
    g.sync();
  }
};

// The closed-form fit (preempt_search.cuh fits) with the release t_rel,
// the node's slack (alloc - req) and the representative's demand spread
// over the lanes (resource r in lane r % L), and cnt pods removed.
template <int L>
__device__ __forceinline__ bool group_fits(const Lanes<L>& g, const long long* t_rel,
                                           const long long* slack, const long long* demand, int R, int cnt,
                                           int pods, int allowed) {
  constexpr int kRL = (kMaxR + L - 1) / L;
  bool ok = pods - cnt + 1 <= allowed;
  const int lane = g.lane;
#pragma unroll
  for (int k = 0; k < kRL; ++k) {
    const int r = lane + k * L;
    if (r >= R) break;
    const long long d = demand[k];
    // alloc - (req - rel), in int64's wrap-around arithmetic
    const long long room = (long long)((unsigned long long)slack[k] + (unsigned long long)t_rel[k]);
    ok = ok && (d == 0 || d <= room);
  }
  return g.all(ok);
}

constexpr int kPdbRegs = 4;  // PDB bytes a slot stages in registers (more are read at the tail)
constexpr int kPinRegs = 4;  // pins of the representative's claims staged in registers (more: read)

// A lane's slots as the dry-run and the criteria read them, read once.
template <int L>
struct EvalSlots {
  static constexpr int kJ = L == 32 ? 2 : 1;
  int prio[kJ];
  double start[kJ];
  long long nz[kJ][2];
  unsigned char pdb[kJ][kPdbRegs];
};

// The representative's row as a dry-run reads it: its priority, filters,
// pins, demand (lane r % L's resources) and, warp lane q, its op slot q.
template <int L>
struct RepRow {
  static constexpr int kRL = (kMaxR + L - 1) / L;
  int prio, want, pins[kPinRegs];
  unsigned char tol, bits, missing, rwop_ok;
  long long demand[kRL];
  int pt, pk, pw, pi, vi, vw, ci, cd, ki, kc, kn;
};

// Mate i0's row (node n's node_filters byte of it); ``row``: a live node
// outside TAIL, ``full``: a live node in FULL (the op slots are read by
// every lane of a FULL launch: the warp keeps one copy).
template <int L>
__device__ __forceinline__ void load_rep(const Args& a, int i0, int n, bool row, bool full, int lane, int warp_lane,
                                         RepRow<L>& rr) {
  const int* d = a.d;
  const int N = d[D_N], R = d[D_R], PIN = d[D_PIN];
  rr.prio = row ? at<int>(a, P_PRIORITY)[i0] : 0;
  rr.tol = row && has_flag(a, S_UNSCHED) ? at<unsigned char>(a, P_TOL_UNSCHED)[i0] : 0;
  rr.want = row && has_flag(a, S_NODENAME) ? at<int>(a, P_NODENAME_ID)[i0] : -1;
  rr.bits = row && d[D_BITS_MASK] != 0 ? at<unsigned char>(a, P_NODE_BITS)[(long long)i0 * N + n] : 0;
  const bool dra = row && has_flag(a, S_DRA);
  rr.missing = dra ? at<unsigned char>(a, P_POD_DRA_MISSING)[i0] : 0;
#pragma unroll
  for (int k = 0; k < kPinRegs; ++k) {
    rr.pins[k] = dra && k < PIN ? at<int>(a, P_POD_DRA_PINS)[(long long)i0 * PIN + k] : -1;
  }
  rr.rwop_ok = full && has_flag(a, S_VR) ? at<unsigned char>(a, P_RWOP_OK)[i0] : 1;
#pragma unroll
  for (int k = 0; k < RepRow<L>::kRL; ++k) {
    const int r = lane + k * L;
    rr.demand[k] = full && r < R ? at<long long>(a, P_POD_REQ)[(long long)i0 * R + r] : 0;
  }
  const int q = warp_lane, QP = d[D_QP], QD = d[D_QD], QC = d[D_QC], QK = d[D_QK];
  const bool ops = d[D_STEP] == FULL;
  const long long o = (long long)i0;
  rr.pt = ops && q < QP ? at<int>(a, P_POD_PORT_TRIPLES)[o * QP + q] : -1;
  rr.pk = ops && q < QP ? at<int>(a, P_POD_PORT_KEYS)[o * QP + q] : 0;
  rr.pw = ops && q < QP ? at<int>(a, P_POD_PORT_WILD)[o * QP + q] : 0;
  rr.pi = ops && q < QP ? at<unsigned char>(a, P_POD_PORT_IS_WILD)[o * QP + q] : 0;
  rr.vi = ops && q < QD ? at<int>(a, P_POD_DEV_IDS)[o * QD + q] : -1;
  rr.vw = ops && q < QD ? at<unsigned char>(a, P_POD_DEV_RW)[o * QD + q] : 0;
  rr.ci = ops && q < QC ? at<int>(a, P_POD_CSI_IDS)[o * QC + q] : -1;
  rr.cd = ops && q < QC ? at<int>(a, P_POD_CSI_DRV)[o * QC + q] : -1;
  rr.ki = ops && q < QK ? at<int>(a, P_POD_DRA_IDS)[o * QK + q] : -1;
  rr.kc = ops && q < QK ? at<int>(a, P_POD_DRA_CLS)[o * QK + q] : -1;
  rr.kn = ops && q < QK ? at<int>(a, P_POD_DRA_CNT)[o * QK + q] : 0;
}

// The five criteria and the outputs of node n over its final victim set
// (preemption.py:457-536), from the group: PDB counts by ballots, the
// sums and extrema by reductions in int64 (exact in any order), the
// earliest start at the top priority by a min of doubles.
template <int L>
__device__ __forceinline__ void eval_tail(const Args& a, const Lanes<L>& g, int n, bool live,
                                          unsigned long long mask, const EvalSlots<L>& sl, unsigned char flags,
                                          bool rep_ok) {
  constexpr int kJ = L == 32 ? 2 : 1;
  const int V = a.d[D_V], N = a.d[D_N], P = a.d[D_P];
  const int lane = g.lane;
  bool m[kJ];
  int nv = 0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int v = lane + j * L;
    m[j] = v < V && ((mask >> v) & 1ULL);
    nv += __popc(g.ballot(m[j]));
  }
  const int need = F_BASE | F_HARD | F_FEAS;
  const bool poss = (flags & need) == need && nv >= 1 && rep_ok;
  const unsigned char* pdb = at<unsigned char>(a, P_VIC_PDB);
  const long long* allowed = at<long long>(a, P_PDB_ALLOWED);
  long long violations = 0;
  for (int q = 0; q < P; ++q) {
    long long c = 0;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const bool hit =
          m[j] && (q < kPdbRegs ? sl.pdb[j][q] != 0 : pdb[((long long)n * V + lane + j * L) * P + q] != 0);
      c += __popc(g.ballot(hit));
    }
    const long long over = c - allowed[q];
    violations += over > 0 ? over : 0;
  }
  int top = -1;
  long long prio_sum = 0, nz0 = 0, nz1 = 0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (!m[j]) continue;
    top = sl.prio[j] > top ? sl.prio[j] : top;
    prio_sum += sl.prio[j];
    nz0 += sl.nz[j][0];
    nz1 += sl.nz[j][1];
  }
  // The four reductions a level at a time (independent shuffles in flight
  // together).
  int max_prio = top;
  __syncwarp();
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const int t = __shfl_xor_sync(0xffffffffu, max_prio, off, L);
    const long long ps = __shfl_xor_sync(0xffffffffu, prio_sum, off, L);
    const long long z0 = __shfl_xor_sync(0xffffffffu, nz0, off, L);
    const long long z1 = __shfl_xor_sync(0xffffffffu, nz1, off, L);
    max_prio = t > max_prio ? t : max_prio;
    prio_sum += ps;
    nz0 += z0;
    nz1 += z1;
  }
  double min_start = INFINITY;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (m[j] && sl.prio[j] == max_prio) min_start = sl.start[j] < min_start ? sl.start[j] : min_start;
  }
  min_start = g.reduce(min_start, Min());
  if (!live) return;
  unsigned char* vm = at<unsigned char>(a, P_VIC_MASK);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int v = lane + j * L;
    if (v < V) vm[(long long)n * V + v] = m[j];
  }
  if (lane != 0) return;
  const long long start_key = isfinite(min_start) ? (long long)(-min_start * 1e6) : kNoStart;
  long long* crit = at<long long>(a, P_CRIT);
  at<unsigned char>(a, P_POSSIBLE)[n] = poss;
  crit[0 * (long long)N + n] = violations;
  crit[1 * (long long)N + n] = max_prio;
  crit[2 * (long long)N + n] = prio_sum;
  crit[3 * (long long)N + n] = nv;
  crit[4 * (long long)N + n] = start_key;
  at<int>(a, P_N_VIC)[n] = nv;
  at<long long>(a, P_RELNZ)[(long long)n * 2 + 0] = nz0;
  at<long long>(a, P_RELNZ)[(long long)n * 2 + 1] = nz1;
}

// One launch a dry-run (kernels.eval_split): a group of L lanes a node,
// blockDim.x / L nodes a block.  Lane l owns slots l and l + L (L = 32 and
// V > 32 only) with their priorities, start times, non-zero requests and
// PDB bits in registers, and the resources l, l + L, ... of the node's
// release; the node's requests sit in the group's shared memory.  Every
// lane of a warp runs every step (a group past N, or one with nothing to
// reprieve, with its results unused), so the group operations are
// full-warp ones.  The kernel is a chain of dependent reads, so it reads
// in rounds, each round's loads in flight
// together: (1) what does not depend on the representative (the lane's
// slots, the node's row, the carry, the victims' CSI and claim ids) while
// each warp finds the representative by its own ballots (no block
// barrier); (2) the representative's row (its priority, filters, demand
// and op slots), the victims' other id tables and the counts at their own
// ids; (3) in FULL, the counts at the representative's ids.
template <int L, bool kOps>
__global__ void __launch_bounds__(kEvalMaxThreads, 2) preempt_eval_kernel(Args a, EvalLayout lay) {
  extern __shared__ __align__(16) unsigned char eval_smem[];
  constexpr int kJ = L == 32 ? 2 : 1;
  constexpr int kRL = (kMaxR + L - 1) / L;
  const int N = a.d[D_N], V = a.d[D_V], R = a.d[D_R], C = a.d[D_C], P = a.d[D_P], mode = a.d[D_STEP];
  const int warp_lane = (int)threadIdx.x % 32, lane = warp_lane % L, grp_at = (int)threadIdx.x / L;
  const Lanes<L> g{lane, warp_lane - lane};
  const int n = (int)blockIdx.x * ((int)blockDim.x / L) + grp_at;
  const bool live = n < N, full = live && mode == FULL, row = live && mode != TAIL;
  int* s_grp = reinterpret_cast<int*>(eval_smem) + grp_at * lay.group_ints;
  int* s_rep = reinterpret_cast<int*>(eval_smem) + ((int)blockDim.x / L) * lay.group_ints +
               ((int)threadIdx.x / 32) * lay.rep_ints;
  long long* s_req = reinterpret_cast<long long*>(s_grp + lay.rq);
  const EvalOps<L> ops{a, lay, g, s_rep, s_grp, n, N, V, lane};

  // Round 1: the first mates, then everything that does not wait on the
  // representative, and its row at mate 0 (the representative unless an
  // earlier mate is invalid; read again then).  Nothing read here is used
  // before the ballots, so all of it is in flight together.
  const bool spec_view = a.p[P_MATE_VALID] == nullptr;
  unsigned char mv[kRepBatch];
  int msp[kRepBatch];
#pragma unroll
  for (int b = 0; b < kRepBatch; ++b) {
    const int i = b * 32 + warp_lane;
    mv[b] = i < C ? at<unsigned char>(a, spec_view ? P_ELIG : P_MATE_VALID)[i] : 0;
    msp[b] = i < C && spec_view ? at<int>(a, P_SPEC_PICKS)[i] : -1;
  }
  EvalSlots<L> sl;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int v = lane + j * L;
    const bool has = live && v < V;
    const long long slot = (long long)n * V + v;
    sl.prio[j] = has ? at<int>(a, P_VIC_PRIO)[slot] : kI32Max;
    const bool crit = has && mode != PROLOGUE;
    sl.start[j] = crit ? at<double>(a, P_VIC_START)[slot] : INFINITY;
    sl.nz[j][0] = crit ? at<long long>(a, P_VIC_NONZERO)[slot * 2 + 0] : 0;
    sl.nz[j][1] = crit ? at<long long>(a, P_VIC_NONZERO)[slot * 2 + 1] : 0;
#pragma unroll
    for (int q = 0; q < kPdbRegs; ++q) sl.pdb[j][q] = crit && q < P ? at<unsigned char>(a, P_VIC_PDB)[slot * P + q] : 0;
  }
  // The node's V x R requests, a contiguous span: lane-strided, staged.
  const int VR = V * R;
  const long long* vreq = at<long long>(a, P_VIC_REQ) + (long long)n * VR;
  long long rq[kReqRegs];
#pragma unroll
  for (int k = 0; k < kReqRegs; ++k) {
    const int e = lane + k * L;
    rq[k] = row && e < VR ? vreq[e] : 0;
  }
  const unsigned char valid_b = row ? at<unsigned char>(a, P_VALID)[n] : 0;
  const unsigned char unsched_b = row && has_flag(a, S_UNSCHED) ? at<unsigned char>(a, P_UNSCHED)[n] : 0;
  const int name = row ? at<int>(a, P_NAME_ID)[n] : -1;
  long long alloc_r[kRL], req_r[kRL];
#pragma unroll
  for (int k = 0; k < kRL; ++k) {
    const int r = lane + k * L;
    alloc_r[k] = full && r < R ? at<long long>(a, P_ALLOC)[(long long)n * R + r] : 0;
    req_r[k] = full && r < R ? at<long long>(a, P_REQ)[(long long)n * R + r] : 0;
  }
  const int pods = full ? at<int>(a, P_NUM_PODS)[n] : 0;
  const int allowed = full ? at<int>(a, P_ALLOWED_PODS)[n] : 0;
  const bool tail_only = live && mode == TAIL;
  const unsigned long long carry_mask = tail_only ? (unsigned long long)at<long long>(a, P_CARRY_MASK)[n] : 0;
  const unsigned char carry_flags = tail_only ? at<unsigned char>(a, P_CARRY_FLAGS)[n] : 0;
  EvalSpans sp;
  if (kOps && full) ops.stage_spans(sp);
  RepRow<L> rr = {};
  if (mode != TAIL) load_rep<L>(a, 0, n, row, full, lane, warp_lane, rr);

  // The representative: the first valid mate, 0 when none (jnp.argmax of
  // an all-false mask), by this warp's ballots, kRepBatch x 32 mates a
  // round (every lane of the warp is here: none has returned).
  int found = -1;
#pragma unroll
  for (int b = 0; b < kRepBatch; ++b) {
    const unsigned int ballot = __ballot_sync(0xffffffffu, mv[b] != 0 && msp[b] < 0);
    if (found < 0 && ballot != 0) found = b * 32 + __ffs(ballot) - 1;
  }
  for (int base_i = 32 * kRepBatch; base_i < C && found < 0; base_i += 32 * kRepBatch) {
    bool valid[kRepBatch];
#pragma unroll
    for (int b = 0; b < kRepBatch; ++b) {
      const int i = base_i + b * 32 + warp_lane;
      valid[b] = i < C && mate_valid(a, i);
    }
#pragma unroll
    for (int b = 0; b < kRepBatch; ++b) {
      const unsigned int ballot = __ballot_sync(0xffffffffu, valid[b]);
      if (found < 0 && ballot != 0) found = base_i + b * 32 + __ffs(ballot) - 1;
    }
  }
  const int i0 = found < 0 ? 0 : found;
  const bool rep_ok = found >= 0;
  if (i0 != 0 && mode != TAIL) load_rep<L>(a, i0, n, row, full, lane, warp_lane, rr);  // (warp-uniform)

  // Round 2, in FULL: the counts at the victims' own CSI and claim ids and
  // at the representative's slot q = lane of each op (warp lane q holds
  // it: a shuffle).
  RepCounts rc = {};
  if (kOps) {
    RepSlot r;
    r.pt = __shfl_sync(0xffffffffu, rr.pt, lane);
    r.pk = max(__shfl_sync(0xffffffffu, rr.pk, lane), 0);
    r.pw = max(__shfl_sync(0xffffffffu, rr.pw, lane), 0);
    r.pi = __shfl_sync(0xffffffffu, rr.pi, lane);
    r.vi = __shfl_sync(0xffffffffu, rr.vi, lane);
    r.vw = __shfl_sync(0xffffffffu, rr.vw, lane);
    r.ci = __shfl_sync(0xffffffffu, rr.ci, lane);
    r.cd = __shfl_sync(0xffffffffu, rr.cd, lane);
    r.ki = __shfl_sync(0xffffffffu, rr.ki, lane);
    r.kc = __shfl_sync(0xffffffffu, rr.kc, lane);
    if (full) rc = ops.fetch(r);
  }
  if (kOps && full) ops.stage_counts(sp);
  const bool valid_n = valid_b != 0, unsched = unsched_b != 0;
  bool base = valid_n && (!unsched || rr.tol);
  base = base && (rr.want == -1 || name == rr.want || !has_flag(a, S_NODENAME));
  const int bits = a.d[D_BITS_MASK];
  base = base && (bits == 0 || (rr.bits & bits) == bits);
  bool hard = true;
  if (row && has_flag(a, S_DRA)) {
    const int PIN = a.d[D_PIN];
    hard = !rr.missing;
#pragma unroll
    for (int k = 0; k < kPinRegs; ++k) hard = hard && (k >= PIN || rr.pins[k] < 0 || rr.pins[k] == name);
    for (int k = kPinRegs; k < PIN; ++k) {
      const int pin = at<int>(a, P_POD_DRA_PINS)[(long long)i0 * PIN + k];
      hard = hard && (pin < 0 || pin == name);
    }
  }
  base = base && hard;
  const int prio0 = rr.prio;
  const bool no_reprieve = full && has_flag(a, S_VR) && !rr.rwop_ok;
  long long slack[kRL], demand[kRL];
#pragma unroll
  for (int k = 0; k < kRL; ++k) {
    slack[k] = (long long)((unsigned long long)alloc_r[k] - (unsigned long long)req_r[k]);
    demand[k] = rr.demand[k];
  }
  if (kOps) {
    const int* d = a.d;
    const int q = warp_lane;
    if (q < d[D_QP]) {
      s_rep[lay.r_pt + q] = rr.pt;
      s_rep[lay.r_pk + q] = rr.pk > 0 ? rr.pk : 0;
      s_rep[lay.r_pw + q] = rr.pw > 0 ? rr.pw : 0;
      s_rep[lay.r_pi + q] = rr.pi;
    }
    if (q < d[D_QD]) {
      s_rep[lay.r_vi + q] = rr.vi;
      s_rep[lay.r_vw + q] = rr.vw;
    }
    if (q < d[D_QC]) {
      s_rep[lay.r_ci + q] = rr.ci;
      s_rep[lay.r_cd + q] = rr.cd;
    }
    if (q < d[D_QK]) {
      s_rep[lay.r_ki + q] = rr.ki;
      s_rep[lay.r_kc + q] = rr.kc;
      s_rep[lay.r_kn + q] = rr.kn;
    }
  }
  if (kOps && full) {
    ops.store(sp);
    ops.put(lane, rc);
  }
  if (row) {
#pragma unroll
    for (int k = 0; k < kReqRegs; ++k) {
      const int e = lane + k * L;
      if (e < VR) s_req[e] = rq[k];
    }
    for (int e = lane + kReqRegs * L; e < VR; e += L) s_req[e] = vreq[e];
  }
  __syncwarp();  // the warp's copy of the representative's op slots, the group's spans

  if (mode == TAIL) {
    // The carry's release is the output's (the same rows).
    if (live) {
      const long long* crel = at<long long>(a, P_CARRY_REL) + (long long)n * R;
      long long* out_rel = at<long long>(a, P_REL) + (long long)n * R;
      for (int r = lane; r < R; r += L) out_rel[r] = crel[r];
    }
    eval_tail<L>(a, g, n, live, carry_mask, sl, carry_flags, rep_ok);
    return;
  }

  // Phase 1: every lower-priority victim released (the lanes' ballots);
  // lane r % L sums resource r of the masked slots.
  unsigned long long mask = 0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    mask |= (unsigned long long)g.ballot(lane + j * L < V && sl.prio[j] < prio0) << (j * L);
  }
  int cnt = __popcll(mask);
  long long rel[kRL];
#pragma unroll
  for (int k = 0; k < kRL; ++k) {
    const int r = lane + k * L;
    rel[k] = 0;
    for (unsigned long long m = r < R ? mask : 0; m; m &= m - 1) rel[k] += s_req[(__ffsll((long long)m) - 1) * R + r];
  }
  unsigned char flags = (base ? F_BASE : 0) | F_HARD;
  if (mode == PROLOGUE) {
    if (live && lane == 0) {
      at<long long>(a, P_CARRY_MASK)[n] = (long long)mask;
      at<int>(a, P_CARRY_CNT)[n] = cnt;
      at<unsigned char>(a, P_CARRY_FLAGS)[n] = flags;
    }
#pragma unroll
    for (int k = 0; k < kRL; ++k) {
      const int r = lane + k * L;
      if (live && r < R) at<long long>(a, P_CARRY_REL)[(long long)n * R + r] = rel[k];
    }
    return;
  }

  // FULL: round 3, the counts at the representative's ids; then the
  // closed-form fit and the ops on every tentative mask.
  OwnRegs<L> own;
  if (kOps) ops.count(mask, live, own);
  const bool fit_all = group_fits<L>(g, rel, slack, demand, R, cnt, pods, allowed);
  SlotCache none;
  none.s = -1;
  const bool feas_all = (!kOps || ops.ok(mask, none, own, hard)) && fit_all;
  if (feas_all) flags |= F_FEAS;

  // Phase 2: the greedy reprieve in reverse slot order, in lockstep: each
  // lane takes slot s's requests of its resources from the group's copy,
  // the fit and the ops are joined over the lanes, and the group takes or
  // refuses it together.  A reprieve clears only bit s, so the masked slots
  // below s are those of phase 1.  Every group of the warp runs each slot
  // that some group of it may reprieve.
  const bool may = live && feas_all && !no_reprieve;
  for (int s = V - 1; s >= 0; --s) {
    const bool act = may && ((mask >> s) & 1ULL);
    __syncwarp();
    if (!__any_sync(0xffffffffu, act)) continue;
    long long t_rel[kRL];
#pragma unroll
    for (int k = 0; k < kRL; ++k) {
      const int r = lane + k * L;
      t_rel[k] = r < R ? rel[k] - s_req[s * R + r] : 0;
    }
    const unsigned long long tent = mask & ~(1ULL << s);
    const bool fit = group_fits<L>(g, t_rel, slack, demand, R, cnt - 1, pods, allowed);
    SlotCache sc;
    if (kOps) sc = ops.cache(s);
    const bool taken = (!kOps || ops.ok(tent, sc, own, hard)) && fit && act;
    if (kOps && __any_sync(0xffffffffu, taken)) ops.take(sc, taken, own);
    if (taken) {
      mask = tent;
#pragma unroll
      for (int k = 0; k < kRL; ++k) rel[k] = t_rel[k];
      --cnt;
    }
  }
#pragma unroll
  for (int k = 0; k < kRL; ++k) {
    const int r = lane + k * L;
    if (live && r < R) at<long long>(a, P_REL)[(long long)n * R + r] = rel[k];
  }
  eval_tail<L>(a, g, n, live, mask, sl, flags, rep_ok);
}

// ---- preempt_pick ----------------------------------------------------------

// The mates of a chunk as preempt_pick reads them: valid, or the
// speculative pair (eligible, the main pass's pick).
struct PodView {
  const unsigned char* valid;  // (C,) or null: elig + spec_picks
  const unsigned char* elig;   // (C,)
  const int* spec_picks;       // (C,)
  int C;
};

__device__ __forceinline__ bool mate_valid(const PodView& p, int i) {
  if (p.valid != nullptr) return p.valid[i] != 0;
  return p.elig[i] != 0 && p.spec_picks[i] < 0;
}

// A node's sort key: the five criteria, then its row.  Rows are distinct,
// so (keys, row) is a total order; padding (every key INT64_MAX, row
// INT32_MAX) sorts after every node.
struct alignas(16) Rec {
  long long k[5];
  int row;
  int unused;
};

constexpr int kPickMax = 1024;  // threads a CTA at most: the widest bitonic network
constexpr int kArgmin = 0, kSplit = 1, kTiled = 2;  // kernels.PICK_ARGMIN, PICK_SPLIT, PICK_TILED
constexpr long long kBig = 1LL << 62;  // the rank split's sentinel on violations (:579)

__device__ __forceinline__ Rec pad_rec() {
  Rec r;
#pragma unroll
  for (int q = 0; q < 5; ++q) r.k[q] = LLONG_MAX;
  r.row = INT_MAX;
  r.unused = 0;
  return r;
}

// a sorts before b: signed int64 keys, most significant first, then row;
// without branches.
__device__ __forceinline__ bool before(const Rec& a, const Rec& b) {
  bool lt = a.row < b.row;
#pragma unroll
  for (int q = 4; q >= 0; --q) lt = a.k[q] < b.k[q] || (a.k[q] == b.k[q] && lt);
  return lt;
}

__device__ __forceinline__ Rec shfl_rec(const Rec& r, int mask) {
  Rec o;
#pragma unroll
  for (int q = 0; q < 5; ++q) o.k[q] = __shfl_xor_sync(0xffffffffu, r.k[q], mask);
  o.row = __shfl_xor_sync(0xffffffffu, r.row, mask);
  o.unused = 0;
  return o;
}

// Elements of the sorted arr[0, len) that sort before e.
__device__ __forceinline__ int lower_bound(const Rec* arr, int len, const Rec& e) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(arr[mid], e)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct PickArgs {
  const unsigned char* possible;  // (N,)
  const long long* crit;          // (5, N)
  PodView mates;
  const int* sig;   // (C,)
  int* picks;       // (C,)
  int* order_at;    // (Cp,): the node of each rank below Cp (split and tiled modes)
  int* lists;       // (K, 2, L): each CTA's kept list, two buffers (tiled mode)
  int N, Cp, S, L, mode, chunk_mode;  // Cp = min(C, N); S rows a CTA; L = min(Cp, S)
};

// The record of node row n.
__device__ __forceinline__ Rec node_rec(const PickArgs& a, int n) {
  Rec r;
#pragma unroll
  for (int q = 0; q < 5; ++q) r.k[q] = a.crit[(long long)q * a.N + n];
  r.row = n;
  r.unused = 0;
  return r;
}

// Node row n's record, and whether it takes part: possible and below the
// rank split's sentinel (the plain version's vio_m < 2^62; violations
// never come near it).
__device__ __forceinline__ Rec load_node(const PickArgs& a, int n, bool& cand) {
  const unsigned char p = a.possible[n];
  const Rec r = node_rec(a, n);
  cand = p != 0 && r.k[0] < kBig;
  return r;
}

// Gather the block's records that take part (cand) to the front of
// ``stage`` in thread order, by warp ballots and the warps' counts;
// returns their count.  Ends with a barrier.
__device__ int compact(const Rec& r, bool cand, Rec* stage, int* s_count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned int ballot = __ballot_sync(0xffffffffu, cand);
  __syncthreads();  // s_count and stage free
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int at = __popc(ballot & ((1u << lane) - 1u)), total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) at += s_count[w];
    total += s_count[w];
  }
  if (cand) stage[at] = r;
  __syncthreads();
  return total;
}

// The network's width for m records: a power of two, at least a warp.
__device__ __forceinline__ int width_for(int m) {
  return m <= 32 ? 32 : 1 << (32 - __clz(m - 1));
}

// Sort W records ascending (W a power of two, a multiple of 32; thread t <
// W holds position t, the others only meet the barriers): a bitonic
// network in registers, partners within a warp by shuffles, across warps
// through ``sx`` (2W records: two buffers taken in turn, one barrier a
// stage).  Each thread compares its pair once a stage.
__device__ void bitonic(Rec& r, Rec* sx, int W) {
  const int t = threadIdx.x;
  const bool in = t < W;
  int buf = 0;
  for (int k = 2; k <= W; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      Rec o;
      if (j >= 32) {
        Rec* x = sx + buf * W;
        buf ^= 1;
        if (in) x[t] = r;
        __syncthreads();
        if (in) o = x[t ^ j];
      } else if (in) {
        o = shfl_rec(r, j);
      }
      if (in) {
        // The lower place of an ascending pair keeps the smaller: take the
        // partner's record where it sorts before this one, or, keeping the
        // larger, where it does not (equal records are padding: taking
        // one for the other changes nothing).
        const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
        if (before(o, r) == keep_min) r = o;
      }
    }
  }
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kPeerRecs = 2048;  // records of peers' lists a round brings into shared memory
constexpr int kPieces = 16;      // pieces of lists a round at most

// One launch a pick, one thread block cluster of K CTAs; CTA r owns the
// node rows [r*S, min(N, (r+1)*S)).
//   argmin (Cp = 1: chunk 1, or one node row): each thread folds its rows
//     into the least (keys, row) in registers, warps by shuffles, the CTA
//     by its warps' minima; CTA 0 folds the K minima over distributed
//     shared memory.  Rank 0 is the narrowing's argmin.
//   split (Cp > 1, S <= T): each CTA gathers its slice's m nodes that take
//     part, sorts them with one bitonic network of width_for(m) in
//     registers and keeps the first min(Cp, m).  A kept node's rank is its
//     place in its own list plus, for each other CTA, how many of that
//     CTA's kept nodes sort before it: a lower bound in the peer's list,
//     copied over distributed shared memory into this CTA's shared memory
//     (as many peers' lists a round as kPeerRecs holds).  A node of rank
//     below Cp is written to order_at[rank]: every such node is in its
//     CTA's kept list (its local rank is at most its rank), and ranks are
//     distinct (a total order), so order_at[0, min(Cp, M)) is written
//     exactly once, M the nodes taking part.
//   tiled (Cp > 1, S > T): as split, but each CTA walks its slice in tiles
//     of T rows, merging each sorted tile into a running kept list of L rows
//     in global memory (two buffers); the lists are read in pieces.
// Then every CTA arrives at a cluster barrier (its order_at writes
// released, its last remote read done) and CTA 0 assigns the mates: the
// representative is the first valid mate; eligible mates (valid, its
// signature) take order_at[min(r, N-1)], r their cumsum rank, when that is
// below M; at chunk > 1 a valid mate without a node defers (-2).
__global__ void __launch_bounds__(kPickMax) preempt_pick_kernel(PickArgs a) {
  extern __shared__ __align__(16) unsigned char pick_smem[];
  Rec* s_rec = reinterpret_cast<Rec*>(pick_smem);  // (T,) the sorted slice or tile
  Rec* s_peer = s_rec + blockDim.x;                 // (kPeerRecs,) peers' lists; the network's exchange
  __shared__ Rec s_warp[kPickMax / 32];
  __shared__ int s_count[kPickMax / 32];
  __shared__ int s_len, s_cnt, s_buf;  // published: kept length, nodes taking part, tiled list buffer
  __shared__ int s_lens[16], s_cnts[16], s_bufs[16];
  __shared__ int s_pj[kPieces], s_pc[kPieces], s_pw[kPieces], s_pb[kPieces];  // a round's pieces
  __shared__ int s_np, s_used, s_nd, s_nc;
  __shared__ int s_idx0, s_m, s_order0;

  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(a.N, me * a.S), hi = min(a.N, lo + a.S);
  const int C = a.mates.C;

  // CTA 0: the representative, while the slices load.
  if (me == 0) {
    if (tid == 0) s_idx0 = C;
    __syncthreads();
    for (int i = tid; i < C; i += T) {
      if (mate_valid(a.mates, i)) {
        atomicMin(&s_idx0, i);
        break;
      }
    }
  }

  if (a.mode == kArgmin) {
    Rec best = pad_rec();
    int cnt = 0;
    for (int n = lo + tid; n < hi; n += T) {
      bool cand;
      const Rec r = load_node(a, n, cand);
      if (cand) {
        ++cnt;
        if (before(r, best)) best = r;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const Rec o = shfl_rec(best, off);
      if (before(o, best)) best = o;
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0) {
      s_warp[warp] = best;
      s_count[warp] = cnt;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < T / 32 ? s_warp[lane] : pad_rec();
      cnt = lane < T / 32 ? s_count[lane] : 0;
      for (int off = 16; off > 0; off >>= 1) {
        const Rec o = shfl_rec(best, off);
        if (before(o, best)) best = o;
        cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      }
      if (lane == 0) {
        s_warp[0] = best;
        s_cnt = cnt;
        s_order0 = best.row;
        s_m = cnt;
      }
    }
    if (K > 1) {
      cluster.sync();
      if (me == 0 && warp == 0) {
        best = lane < K ? *cluster.map_shared_rank(&s_warp[0], lane) : pad_rec();
        cnt = lane < K ? *cluster.map_shared_rank(&s_cnt, lane) : 0;
        for (int off = 16; off > 0; off >>= 1) {
          const Rec o = shfl_rec(best, off);
          if (before(o, best)) best = o;
          cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
        }
        if (lane == 0) {
          s_order0 = best.row;
          s_m = cnt;
        }
      }
      cluster_arrive_relaxed();
      cluster_wait();
    }
  } else {
    int len = 0, cnt = 0, cur = 0;
    Rec mine = pad_rec();  // split mode: this thread's place in the sorted slice
    if (a.mode == kSplit) {
      bool cand = false;
      Rec r = pad_rec();
      if (lo + tid < hi) r = load_node(a, lo + tid, cand);
      cnt = compact(r, cand, s_rec, s_count);
      r = tid < cnt ? s_rec[tid] : pad_rec();
      bitonic(r, s_peer, width_for(cnt));
      s_rec[tid] = r;  // only this thread read s_rec[tid]
      mine = r;
      len = min(a.Cp, cnt);
    } else {
      int* const own = a.lists + (long long)me * 2 * a.L;
      for (int base = lo; base < hi; base += T) {
        bool cand = false;
        Rec r = pad_rec();
        if (base + tid < hi) r = load_node(a, base + tid, cand);
        const int m = compact(r, cand, s_rec, s_count);
        r = tid < m ? s_rec[tid] : pad_rec();
        bitonic(r, s_peer, width_for(m));
        s_rec[tid] = r;
        const int* A = own + cur * a.L;
        int* B = own + (1 - cur) * a.L;
        const int keep = min(a.L, len + m);
        // A tile node's place: its place in the tile plus the kept nodes
        // before it, counted over pieces of the kept list.
        int pos = tid;
        for (int c0 = 0; c0 < len; c0 += kPeerRecs) {
          const int w = min(kPeerRecs, len - c0);
          __syncthreads();  // s_peer free
          for (int i = tid; i < w; i += T) s_peer[i] = node_rec(a, A[c0 + i]);
          __syncthreads();
          if (tid < m && pos < keep) pos += lower_bound(s_peer, w, r);
        }
        __syncthreads();  // s_rec holds the whole tile
        if (tid < m && pos < keep) B[pos] = r.row;
        // A kept node's place: its place in the list plus the tile's nodes
        // before it.
        for (int i = tid; i < len; i += T) {
          const Rec x = node_rec(a, A[i]);
          const int p = i + lower_bound(s_rec, m, x);
          if (p < keep) B[p] = x.row;
        }
        __syncthreads();  // B whole before it is read as A
        cur = 1 - cur;
        len = keep;
        cnt += m;
      }
      __threadfence();
    }
    if (tid == 0) {
      s_len = len;
      s_cnt = cnt;
      s_buf = cur;
    }
    if (K > 1) {
      cluster.sync();
      if (tid < K) {
        s_lens[tid] = *cluster.map_shared_rank(&s_len, tid);
        s_cnts[tid] = *cluster.map_shared_rank(&s_cnt, tid);
        s_bufs[tid] = *cluster.map_shared_rank(&s_buf, tid);
      }
    } else if (tid == 0) {
      s_lens[0] = len;
      s_cnts[0] = cnt;
      s_bufs[0] = cur;
    }
    __syncthreads();
    if (me == 0 && tid == 0) {
      int m = 0;
      for (int j = 0; j < K; ++j) m += s_cnts[j];
      s_m = m;
    }
    // The cross-slice rank of each kept node, T of them at a time (split:
    // one round, each thread its own place).  Each round brings pieces of
    // the peers' lists (peers in staggered order, so the CTAs read
    // different peers) into s_peer, up to kPeerRecs records.
    for (int ob = 0; ob < len; ob += T) {
      const int i = ob + tid;
      const bool keeps = i < len;
      Rec e = mine;
      if (a.mode == kTiled && keeps) e = node_rec(a, a.lists[((long long)me * 2 + cur) * a.L + i]);
      int rank = i;
      if (tid == 0) {
        s_nd = 1;
        s_nc = 0;
      }
      for (;;) {
        __syncthreads();  // s_peer and the last round's plan free
        if (tid == 0) {
          int np = 0, used = 0, d = s_nd, c0 = s_nc;
          while (d < K && np < kPieces && used < kPeerRecs) {
            const int j = (me + d) & (K - 1);
            const int left = s_lens[j] - c0;
            if (left <= 0) {
              ++d;
              c0 = 0;
              continue;
            }
            const int w = min(left, kPeerRecs - used);
            s_pj[np] = j;
            s_pc[np] = c0;
            s_pw[np] = w;
            s_pb[np] = used;
            ++np;
            used += w;
            if (w < left) {
              c0 += w;
            } else {
              ++d;
              c0 = 0;
            }
          }
          s_np = np;
          s_used = used;
          s_nd = d;
          s_nc = c0;
        }
        __syncthreads();
        const int np = s_np;
        if (np == 0) break;
        for (int x = tid; x < s_used; x += T) {
          int p = 0;
          while (p + 1 < np && s_pb[p + 1] <= x) ++p;
          const int j = s_pj[p], at = s_pc[p] + x - s_pb[p];
          if (a.mode == kSplit) {
            s_peer[x] = cluster.map_shared_rank(s_rec, j)[at];
          } else {
            s_peer[x] = node_rec(a, a.lists[((long long)j * 2 + s_bufs[j]) * a.L + at]);
          }
        }
        __syncthreads();
        if (keeps) {
          for (int p = 0; p < np && rank < a.Cp; ++p) rank += lower_bound(s_peer + s_pb[p], s_pw[p], e);
        }
      }
      if (keeps && rank < a.Cp) a.order_at[rank] = e.row;
    }
    if (K > 1) {
      __threadfence();
      cluster_arrive_release();
      cluster_wait();
    } else {
      __syncthreads();
    }
  }
  if (me != 0) return;

  // The mates' picks: T mates a round, their cumsum ranks by a ballot and
  // the warps' counts.
  __syncthreads();
  const int m_all = s_m;
  const int* order = a.mode == kArgmin ? &s_order0 : a.order_at;
  const int idx0 = s_idx0 < C ? s_idx0 : 0;
  const int sig0 = a.sig[idx0];
  int running = 0;
  for (int base = 0; base < C; base += T) {
    const int i = base + tid;
    const bool valid = i < C && mate_valid(a.mates, i);
    const bool eligible = valid && a.sig[i] == sig0;
    const unsigned int ballot = __ballot_sync(0xffffffffu, eligible);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int rank = running, round = 0;
    for (int w = 0; w < T / 32; ++w) {
      if (w < warp) rank += s_count[w];
      round += s_count[w];
    }
    rank += __popc(ballot & ((1u << lane) - 1u));
    if (i < C) {
      int pick = -1;
      const int r = rank < a.N - 1 ? rank : a.N - 1;
      if (eligible && r >= 0 && r < m_all) pick = order[r];
      if (a.chunk_mode && valid && pick < 0) pick = -2;
      a.picks[i] = pick;
    }
    running += round;
    __syncthreads();
  }
}

__device__ __forceinline__ void sub_i64(long long* p, long long x) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p), (unsigned long long)(-x));
}

__global__ void preempt_commit_kernel(const int* __restrict__ picks, int C, int V, int R,
                                      const unsigned char* __restrict__ vic_mask,
                                      const int* __restrict__ n_vic,
                                      const long long* __restrict__ rel,
                                      const long long* __restrict__ relnz, long long* req,
                                      long long* nonzero_req, int* num_pods, int* vic_prio,
                                      unsigned char* mask_out, int* nvic_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const int row = picks[i];
  const bool act = row >= 0;
  for (int v = 0; v < V; ++v) {
    const unsigned char chosen = act ? vic_mask[(long long)row * V + v] : 0;
    mask_out[(long long)i * V + v] = chosen;
    if (chosen) vic_prio[(long long)row * V + v] = search::kI32Max;
  }
  nvic_out[i] = act ? n_vic[row] : 0;
  if (!act) return;
  // Atomics: two mates pick one row only when more mates are eligible than
  // the node axis holds (the clipped rank); their releases then add up, as
  // the reference's scatter-add adds them.
  for (int r = 0; r < R; ++r) sub_i64(&req[(long long)row * R + r], rel[(long long)row * R + r]);
  sub_i64(&nonzero_req[(long long)row * 2 + 0], relnz[(long long)row * 2 + 0]);
  sub_i64(&nonzero_req[(long long)row * 2 + 1], relnz[(long long)row * 2 + 1]);
  atomicSub(&num_pods[row], n_vic[row]);
}

}  // namespace

static long long g_eval_smem[12] = {};  // the opt-in set a lane count, with and without the ops

template <int L, bool kOps>
static int launch_eval_as(const Args& a, int threads, int blocks, long long smem, cudaStream_t stream, int slot) {
  if (smem > 48 * 1024 && smem > g_eval_smem[slot]) {
    const cudaError_t err =
        cudaFuncSetAttribute(preempt_eval_kernel<L, kOps>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    g_eval_smem[slot] = smem;
  }
  preempt_eval_kernel<L, kOps><<<blocks, threads, (size_t)smem, stream>>>(a, eval_layout(a.d));
  return (int)cudaGetLastError();
}

// The kernel with the node-local ops compiled in (FULL with an op of the
// search on), or without them.
template <int L>
static int launch_eval(const Args& a, int threads, int blocks, long long smem, cudaStream_t stream, int slot) {
  const bool ops = a.d[D_STEP] == FULL && (a.d[D_FLAGS] & (S_PORTS | S_VR | S_NVL | S_DRA)) != 0;
  return ops ? launch_eval_as<L, true>(a, threads, blocks, smem, stream, slot)
             : launch_eval_as<L, false>(a, threads, blocks, smem, stream, 6 + slot);
}

// ptrs: the search::Ptr table (nptrs entries), dims: the search::Dim
// values (ndims), both host arrays; lanes, threads: kernels.eval_split
// (lanes a node, threads a block).
extern "C" int preempt_eval_launch(const void* ptrs, int nptrs, const void* dims, int ndims, int lanes,
                                   int threads, void* stream) {
  if (nptrs != P_COUNT || ndims != D_COUNT) return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = static_cast<void* const*>(ptrs)[i];
  for (int i = 0; i < D_COUNT; ++i) a.d[i] = static_cast<const int*>(dims)[i];
  if (a.d[D_R] > kMaxR || a.d[D_V] > kMaxV || a.d[D_QC] > kMaxSlots) return (int)cudaErrorInvalidValue;
  const int V = a.d[D_V], N = a.d[D_N];
  const bool pow2 = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (!pow2 || V > lanes * (lanes == 32 ? 2 : 1) || threads < 32 || threads > kEvalMaxThreads ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return 0;
  const int nodes = threads / lanes;
  const long long smem = eval_smem_bytes(eval_layout(a.d), threads / 32, nodes);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (N + nodes - 1) / nodes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: return launch_eval<1>(a, threads, blocks, smem, st, 0);
    case 2: return launch_eval<2>(a, threads, blocks, smem, st, 1);
    case 4: return launch_eval<4>(a, threads, blocks, smem, st, 2);
    case 8: return launch_eval<8>(a, threads, blocks, smem, st, 3);
    case 16: return launch_eval<16>(a, threads, blocks, smem, st, 4);
    default: return launch_eval<32>(a, threads, blocks, smem, st, 5);
  }
}

static int g_pick_smem = 0;
static bool g_pick_nonportable = false;

// mode, K, threads: kernels.pick_split(C, N).  order_at: (min(C, N),)
// int32 scratch (split and tiled), lists: (K, 2, min(C, N, S)) int32
// scratch (tiled); neither needs filling.
extern "C" int preempt_pick_launch(const void* possible, const void* crit, const void* valid,
                                   const void* elig, const void* spec_picks, const void* sig,
                                   int chunk_mode, int C, int N, int mode, int K, int threads,
                                   void* order_at, void* lists, void* picks, void* stream) {
  if (C < 0 || N < 0 || K < 1 || K > 16 || (K & (K - 1)) != 0 || threads < 32 ||
      threads > kPickMax || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (C == 0) return 0;
  const int S = (N + K - 1) / K;
  const int Cp = C < N ? C : N;
  const bool pow2 = (threads & (threads - 1)) == 0;
  const bool ok = mode == kArgmin ? Cp <= 1
                  : mode == kSplit ? Cp > 1 && pow2 && S <= threads && order_at != nullptr
                  : mode == kTiled ? Cp > 1 && pow2 && order_at != nullptr && lists != nullptr
                                   : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  const int smem = mode == kArgmin ? 0 : (threads + kPeerRecs) * (int)sizeof(Rec);
  if (smem > g_pick_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        preempt_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_pick_smem = smem;
  }
  if (K > 8 && !g_pick_nonportable) {
    const cudaError_t err = cudaFuncSetAttribute(
        preempt_pick_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    g_pick_nonportable = true;
  }
  PickArgs a;
  a.possible = static_cast<const unsigned char*>(possible);
  a.crit = static_cast<const long long*>(crit);
  a.mates = PodView{static_cast<const unsigned char*>(valid), static_cast<const unsigned char*>(elig),
                    static_cast<const int*>(spec_picks), C};
  a.sig = static_cast<const int*>(sig);
  a.picks = static_cast<int*>(picks);
  a.order_at = static_cast<int*>(order_at);
  a.lists = static_cast<int*>(lists);
  a.N = N;
  a.Cp = Cp;
  a.S = S;
  a.L = Cp < S ? Cp : S;
  a.mode = mode;
  a.chunk_mode = chunk_mode;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, preempt_pick_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int preempt_commit_launch(const void* picks, int C, int V, int R,
                                     const void* vic_mask, const void* n_vic, const void* rel,
                                     const void* relnz, void* req, void* nonzero_req,
                                     void* num_pods, void* vic_prio, void* mask_out,
                                     void* nvic_out, void* stream) {
  if (C == 0) return 0;
  preempt_commit_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(picks), C, V, R, static_cast<const unsigned char*>(vic_mask),
      static_cast<const int*>(n_vic), static_cast<const long long*>(rel),
      static_cast<const long long*>(relnz), static_cast<long long*>(req),
      static_cast<long long*>(nonzero_req), static_cast<int*>(num_pods),
      static_cast<int*>(vic_prio), static_cast<unsigned char*>(mask_out),
      static_cast<int*>(nvic_out));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(preempt)
