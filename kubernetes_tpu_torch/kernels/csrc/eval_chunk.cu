// eval_chunk: filters and weighted score of C pods against all N nodes.
//
// Replaces the JAX batch pass's per-pod evaluation (kubernetes_tpu/engine/
// pass_.py:494-554 eval_pod, vmapped over the chunk) for the ops of the
// first port slice: NodeUnschedulable and NodeName (ops/trivial.py:30,40),
// NodeResourcesFit's filter and score (ops/noderesources.py:58,142, with
// the LeastAllocated / MostAllocated scorers :110-125) and
// NodeResourcesBalancedAllocation (:163).  RequestedToCapacityRatio is
// refused by the Python wrapper before launch.  NodeAffinity,
// TaintToleration, VolumeBinding, VolumeZone, VolumeRestrictions,
// NodeVolumeLimits and PodTopologySpread take filter code 3: their results
// are precomputed planes (node_filters' bits 0-3 per batch, vol_filter's
// bits 0-1 and spread_filter's mask per chunk) that this kernel reads at
// the op's place in the filter order, so fail bits stay in profile order.
// A 3-bit selector per filter (ext_sel) names the plane and bit.
//
// Pinned mode (pin_row non-null; the pinned-batch pass, kubernetes_tpu/
// engine/pass_.py:941-985): pod c is evaluated on node pin_row[c] alone and
// the outputs are (C, 1), so its fail bits are those of its own node, as
// the JAX pass's vmapped own-row evaluation gives them.
//
// One thread per (pod, node).  Filters run in profile order from
// state.valid; a filter's fail bit is set only for nodes that passed every
// earlier filter (the reference's first-failing plugin per node), OR-reduced
// per warp and then with one atomicOr per warp into fail_mask[pod].  Scores
// are computed on feasible nodes only; total is 0 elsewhere.
//
// Bound: bytes.  Per chunk it reads the node state once (~0.7 MB at
// N=8192, R=4) and writes C*N*(1+8) bytes of feasible/total (~4.7 MB at
// C=64), a few operations per byte.  The design keeps every node's state
// row in registers for the whole filter/score chain and writes each output
// once, coalesced along the node axis.
//
// Arithmetic follows the JAX package: int64 scores with floor division,
// BalancedAllocation in f64 in the reference's operation order.  The build
// passes -fmad=false so no multiply-add is contracted.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kUnschedulable = 0;
constexpr int kNodeName = 1;
constexpr int kFit = 2;
constexpr int kExt = 3;  // precomputed plane, chosen by ext_sel
// ext_sel values: 0-3 a node_bits bit, 4-5 a vol_bits bit, 6 spread_ok.
constexpr int kSelVol = 4;
constexpr int kSelSpread = 6;
constexpr int kMaxBalanced = 8;

struct EvalArgs {
  // Node state.
  const unsigned char* valid;
  const int* name_id;
  const unsigned char* unschedulable;
  const int* num_pods;
  const int* allowed_pods;
  const long long* alloc;        // (N, R)
  const long long* req;          // (N, R)
  const long long* nonzero_req;  // (N, 2)
  // Nominated-pod overlay; nom_req == nullptr when absent.
  const long long* nom_req;  // (N, R)
  const int* nom_cnt;
  const int* nom_prio;
  // Pod features of the chunk.
  const int* nodename_id;                // (C,)
  const unsigned char* tol_unsched;      // (C,)
  const long long* pod_req;              // (C, R)
  const long long* pod_nonzero;          // (C, 2)
  const int* priority;                   // (C,)
  const int* nominated_row;              // (C,)
  // Precomputed filter planes (null when no filter reads them).
  const unsigned char* node_bits;        // (C, N): bit 0 NodeAffinity, bit 1 TaintToleration
  const unsigned char* spread_ok;        // (C, N): PodTopologySpread
  const unsigned char* vol_bits;         // (C, N): bit 0 VolumeRestrictions, bit 1 NodeVolumeLimits
  const int* pin_row;                    // (C,) pinned mode, else null
  // Static profile config.
  const unsigned char* fit_ignored;  // (R,)
  const long long* strat_cols;       // (S, 3): kind, col, weight
  int n_strat;
  int most_allocated;
  const int* bal_cols;  // (B,)
  int n_bal;
  int score_fit;
  long long fit_weight;
  int score_bal;
  long long bal_weight;
  int filter_codes;  // 2 bits per filter, in fail-bit order
  int n_filters;
  long long ext_sel;  // 3 bits per kExt filter (see kSelVol, kSelSpread)
  int C, N, R;
  // Outputs.
  unsigned char* feasible;  // (C, N)
  long long* total;         // (C, N)
  unsigned int* fail_mask;  // (C,)
};

__device__ bool fit_filter(const EvalArgs& a, int c, int n) {
  const int R = a.R;
  const long long* preq = a.pod_req + (size_t)c * R;
  const long long* alloc = a.alloc + (size_t)n * R;
  const long long* req = a.req + (size_t)n * R;
  bool fits = a.num_pods[n] + 1 <= a.allowed_pods[n];
  for (int r = 0; r < R; ++r) {
    long long rf = a.fit_ignored[r] ? 0 : preq[r];
    long long free_r = alloc[r] - req[r];
    if (!(rf == 0 || rf <= free_r)) fits = false;
  }
  if (a.nom_req != nullptr) {
    const int own = a.nominated_row[c];
    const bool self = own >= 0 && own == n;
    const long long* nreq = a.nom_req + (size_t)n * R;
    bool fits_nom = true;
    for (int r = 0; r < R; ++r) {
      long long rf = a.fit_ignored[r] ? 0 : preq[r];
      long long eff = nreq[r] - (self ? preq[r] : 0);
      if (eff < 0) eff = 0;
      long long free_r = alloc[r] - req[r];
      if (!(rf == 0 || rf <= free_r - eff)) fits_nom = false;
    }
    int eff_cnt = a.nom_cnt[n] - (self ? 1 : 0);
    if (eff_cnt < 0) eff_cnt = 0;
    fits_nom = fits_nom && (a.num_pods[n] + 1 + eff_cnt <= a.allowed_pods[n]);
    const bool applies = a.priority[c] <= a.nom_prio[n];
    fits = fits && (fits_nom || !applies);
  }
  return fits;
}

__device__ long long fit_score(const EvalArgs& a, int c, int n) {
  const int R = a.R;
  long long node_score = 0, weight_sum = 0;
  for (int s = 0; s < a.n_strat; ++s) {
    const long long kind = a.strat_cols[3 * s];
    const int col = (int)a.strat_cols[3 * s + 1];
    const long long w = a.strat_cols[3 * s + 2];
    long long al, rq;
    if (kind == 0) {  // NonZeroRequested.MilliCPU
      al = a.alloc[(size_t)n * R];
      rq = a.nonzero_req[(size_t)n * 2] + a.pod_nonzero[(size_t)c * 2];
    } else if (kind == 1) {  // NonZeroRequested.Memory
      al = a.alloc[(size_t)n * R + 1];
      rq = a.nonzero_req[(size_t)n * 2 + 1] + a.pod_nonzero[(size_t)c * 2 + 1];
    } else {  // Requested column
      al = a.alloc[(size_t)n * R + col];
      rq = a.req[(size_t)n * R + col] + a.pod_req[(size_t)c * R + col];
    }
    if (al > 0) {  // absent resources skip their weight too
      long long sc = 0;
      if (rq <= al) {
        sc = a.most_allocated ? floordiv_i64(rq * 100, al)
                              : floordiv_i64((al - rq) * 100, al);
      }
      node_score += sc * w;
      weight_sum += w;
    }
  }
  return weight_sum > 0 ? floordiv_i64(node_score, weight_sum) : 0;
}

__device__ long long balanced_score(const EvalArgs& a, int c, int n) {
  const int R = a.R;
  double f[kMaxBalanced];
  bool p[kMaxBalanced];
  double total = 0.0;
  long long count = 0;
  for (int b = 0; b < a.n_bal; ++b) {
    const int col = a.bal_cols[b];
    const long long al = a.alloc[(size_t)n * R + col];
    const long long rq = a.req[(size_t)n * R + col] + a.pod_req[(size_t)c * R + col];
    double fr = (double)rq / (double)(al > 1 ? al : 1);
    if (fr > 1.0) fr = 1.0;
    p[b] = al > 0;
    f[b] = p[b] ? fr : 0.0;
    count += p[b] ? 1 : 0;
    total = total + f[b];
  }
  const double mean = count > 0 ? total / (double)count : 0.0;
  double sq = 0.0, ab = 0.0;
  for (int b = 0; b < a.n_bal; ++b) {
    if (p[b]) {
      const double d = f[b] - mean;
      sq = sq + d * d;
      ab = ab + fabs(d);
    }
  }
  double stdv = 0.0;
  if (count == 2) {
    stdv = ab / 2.0;
  } else if (count > 2) {
    stdv = sqrt(sq / (double)count);
  }
  return (long long)((1.0 - stdv) * 100.0);
}

__global__ void eval_chunk_kernel(EvalArgs a) {
  const int c = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool pinned = a.pin_row != nullptr;
  const int n = pinned ? (j == 0 ? a.pin_row[c] : -1) : j;
  unsigned int bits = 0;
  if (n >= 0 && n < a.N) {
    bool feas = a.valid[n] != 0;
    for (int b = 0; b < a.n_filters; ++b) {
      const int code = (a.filter_codes >> (2 * b)) & 3;
      bool ok;
      if (code == kUnschedulable) {
        ok = !a.unschedulable[n] || a.tol_unsched[c];
      } else if (code == kNodeName) {
        const int want = a.nodename_id[c];
        ok = want == -1 || a.name_id[n] == want;
      } else if (code == kFit) {
        ok = fit_filter(a, c, n);
      } else {
        const int sel = (int)((a.ext_sel >> (3 * b)) & 7);
        const size_t o = (size_t)c * a.N + n;
        if (sel == kSelSpread) {
          ok = a.spread_ok[o] != 0;
        } else if (sel >= kSelVol) {
          ok = ((a.vol_bits[o] >> (sel - kSelVol)) & 1) != 0;
        } else {
          ok = ((a.node_bits[o] >> sel) & 1) != 0;
        }
      }
      if (feas && !ok) bits |= 1u << b;
      feas = feas && ok;
    }
    long long tot = 0;
    if (feas) {
      if (a.score_fit) tot += fit_score(a, c, n) * a.fit_weight;
      if (a.score_bal) tot += balanced_score(a, c, n) * a.bal_weight;
    }
    const size_t o = pinned ? (size_t)c : (size_t)c * a.N + n;
    a.feasible[o] = feas ? 1 : 0;
    a.total[o] = tot;
  }
  const unsigned int warp_bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && warp_bits != 0) atomicOr(a.fail_mask + c, warp_bits);
}

}  // namespace

extern "C" int eval_chunk_launch(
    const void* valid, const void* name_id, const void* unschedulable,
    const void* num_pods, const void* allowed_pods, const void* alloc,
    const void* req, const void* nonzero_req, const void* nom_req,
    const void* nom_cnt, const void* nom_prio, const void* nodename_id,
    const void* tol_unsched, const void* pod_req, const void* pod_nonzero,
    const void* priority, const void* nominated_row, const void* node_bits,
    const void* spread_ok, const void* vol_bits, const void* pin_row, const void* fit_ignored,
    const void* strat_cols, int n_strat, int most_allocated,
    const void* bal_cols, int n_bal, int score_fit, long long fit_weight,
    int score_bal, long long bal_weight, int filter_codes, int n_filters,
    long long ext_sel, int C, int N, int R, void* feasible, void* total, void* fail_mask,
    void* stream) {
  if (n_bal > kMaxBalanced) return (int)cudaErrorInvalidValue;
  EvalArgs a;
  a.valid = static_cast<const unsigned char*>(valid);
  a.name_id = static_cast<const int*>(name_id);
  a.unschedulable = static_cast<const unsigned char*>(unschedulable);
  a.num_pods = static_cast<const int*>(num_pods);
  a.allowed_pods = static_cast<const int*>(allowed_pods);
  a.alloc = static_cast<const long long*>(alloc);
  a.req = static_cast<const long long*>(req);
  a.nonzero_req = static_cast<const long long*>(nonzero_req);
  a.nom_req = static_cast<const long long*>(nom_req);
  a.nom_cnt = static_cast<const int*>(nom_cnt);
  a.nom_prio = static_cast<const int*>(nom_prio);
  a.nodename_id = static_cast<const int*>(nodename_id);
  a.tol_unsched = static_cast<const unsigned char*>(tol_unsched);
  a.pod_req = static_cast<const long long*>(pod_req);
  a.pod_nonzero = static_cast<const long long*>(pod_nonzero);
  a.priority = static_cast<const int*>(priority);
  a.nominated_row = static_cast<const int*>(nominated_row);
  a.node_bits = static_cast<const unsigned char*>(node_bits);
  a.spread_ok = static_cast<const unsigned char*>(spread_ok);
  a.vol_bits = static_cast<const unsigned char*>(vol_bits);
  a.pin_row = static_cast<const int*>(pin_row);
  a.fit_ignored = static_cast<const unsigned char*>(fit_ignored);
  a.strat_cols = static_cast<const long long*>(strat_cols);
  a.n_strat = n_strat;
  a.most_allocated = most_allocated;
  a.bal_cols = static_cast<const int*>(bal_cols);
  a.n_bal = n_bal;
  a.score_fit = score_fit;
  a.fit_weight = fit_weight;
  a.score_bal = score_bal;
  a.bal_weight = bal_weight;
  a.filter_codes = filter_codes;
  a.n_filters = n_filters;
  a.ext_sel = ext_sel;
  a.C = C;
  a.N = N;
  a.R = R;
  a.feasible = static_cast<unsigned char*>(feasible);
  a.total = static_cast<long long*>(total);
  a.fail_mask = static_cast<unsigned int*>(fail_mask);
  const int threads = pin_row != nullptr ? 32 : 256;
  dim3 grid(pin_row != nullptr ? 1 : (N + threads - 1) / threads, C);
  eval_chunk_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(eval_chunk)
