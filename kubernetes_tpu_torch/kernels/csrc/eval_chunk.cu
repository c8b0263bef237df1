// eval_chunk: filters and weighted score of C pods against all N nodes.
//
// Replaces the JAX batch pass's per-pod evaluation (kubernetes_tpu/engine/
// pass_.py:494-554 eval_pod, vmapped over the chunk) for the ops of the
// first port slice: NodeUnschedulable and NodeName (ops/trivial.py:30,40),
// NodeResourcesFit's filter and score (ops/noderesources.py:58,142, with
// the LeastAllocated / MostAllocated scorers :110-125) and
// NodeResourcesBalancedAllocation (:163), NodePorts' filter
// (ops/nodeports.py:45) against the live port counts, DynamicResources'
// filter (ops/dynamicresources.py:53) against the live claim counts and
// pool columns, and ImageLocality's
// score (ops/imagelocality.py:53) read from the per-batch plane that
// image_scores (image_locality.cu) computes: images and node validity do
// not change within a pass, and the plane's raw 0-100 score is added with
// the op's weight.  Filter codes are 3 bits a filter in a 64-bit word (0-2
// the trivial filters and fit, 3 a plane, 4 NodePorts, 5
// DynamicResources).
//
// Three more score terms:
// - RequestedToCapacityRatio, NodeResourcesFit's third strategy
//   (ops/noderesources.py:125 _ratio_scorer): utilization reqd*100/alloc in
//   f64, jnp.interp's broken-linear interpolation over the shape points
//   (searchsorted right, the same operation order, the last step one fused
//   multiply-add as XLA computes it), times 10 truncated to int64; a resource with alloc == 0 is skipped with its weight.  The
//   shape holds at most kMaxShape points (the wrapper refuses more).
// - ThroughputAware (ops/throughput.py:149): the pod's (DV,) score table
//   at the node's accelerator-class id, topo_vals[n, tp_slot[c]], 0 where
//   the node has none; an exact integer gather.
// - LearnedScorer (ops/learned.py:154): the 5 -> H -> 1 f32 MLP, tanh then
//   sigmoid, floor(y*100 + 0.5), in the arithmetic XLA on the CPU gives
//   the reference's jitted score: its tanh and exp approximations
//   (xla_tanh, xla_exp_plus_one), its algebraic rewrites, and fmaf()
//   exactly where its object code fuses a multiply-add; every other
//   product and sum rounds on its own (-fmad=false), division is IEEE.  H
//   is at most kMaxHidden.
//
// Filter range: a launch with feas_in non-null starts from that
// feasible set instead of every valid node, sets filter b's fail bit at
// bit0 + b, ORs into the given fail_mask, adds its scores to the given
// total and zeroes total where the node left the set.  The pass evaluates
// the filters a profile orders after InterPodAffinity (DynamicResources in
// the default profile) with such a second launch on the nodes ipa_eval's
// filter left, so each fail bit is the first filter that rejected the node
// in profile order.
//
// DynamicResources at (pod c, node n): no missing claim, every allocation
// pin names node n, and for every pool d the pod's slots of pool d whose
// claim no pod of node n reserves yet (dra_claim_counts[kid, n] == 0) sum
// to a demand that is 0 or fits: dra_alloc[d, n] + need <= dra_cap[d, n].
// The demand of a slot's pool is summed over the pod's slots where that
// slot is met, so no per-pool array is held and the pool count is not
// bounded.
// NodeAffinity, TaintToleration, VolumeBinding, VolumeZone,
// VolumeRestrictions, NodeVolumeLimits and PodTopologySpread take code 3:
// their results are precomputed planes (node_filters' bits 0-3 per batch,
// vol_filter's bits 0-1 and spread_filter's mask per chunk) that this
// kernel reads at the op's place in the filter order, so fail bits stay
// in profile order.  A 3-bit selector per filter (ext_sel) names the plane
// and bit.
//
// Pinned mode (pin_row non-null; the pinned-batch pass, kubernetes_tpu/
// engine/pass_.py:941-985): pod c is evaluated on node pin_row[c] alone and
// the outputs are (C, 1), so its fail bits are those of its own node, as
// the JAX pass's vmapped own-row evaluation gives them; the planes
// (node_filters' pinned bits, ImageLocality's scores) are then (C, 1) too.
// One thread a pod.
//
// Filters run in profile order from state.valid; a filter's fail bit is
// set only for nodes that passed every earlier filter (the reference's
// first-failing plugin per node), OR-reduced per warp and then with one
// atomicOr per warp into fail_mask[pod].  Scores are computed on feasible
// nodes only; total is 0 elsewhere.
//
// Bound: bytes.  Per chunk it reads the node state once (~0.7 MB at
// N=8192, R=4) and writes C*N*(1+8) bytes of feasible/total (~4.7 MB at
// C=64), a few operations per byte; NodePorts adds at most two count reads
// per want of a port pod, coalesced along the node axis, ImageLocality
// C*N bytes of its plane, and DynamicResources per pod up to S*S
// claim-count reads and two pool reads per claim slot, coalesced likewise.
// One thread a (pod, node) made every pod of the chunk re-read the same
// node rows with strided loads and three int64 floor divisions a pair,
// each a software routine on this card.  So a chunk of several pods takes
// the node-tiled launch: a block owns a tile of up to kTile nodes and a
// group of up to kGroup pods.  Every load of the block is issued before its
// one barrier: each thread its node's scalars and the first kStageR
// columns of its R-wide alloc, req and nominated rows (into its own column
// of the tile in shared memory), the threads together the group's pod
// features and the static config.  Each thread then loops over the group's
// pods, the per-node part of the fit score (the weight sum of the columns
// its node has) computed once, and writes feasible and total coalesced
// along the node axis.  The host picks the tile and group from C and N so
// that C=1 and C=64 both give the card's SMs two blocks each or more
// (kernels.eval_tile); where that leaves one pod a block (C=1, or few node
// tiles), the launch is one thread a pair without the staging
// (eval_direct_kernel), and the pinned mode one thread a pod.  Every int64
// floor division is floordiv_f64 (common.cuh): exact, without the 64-bit
// divide.  On the H100 the time of every mapping is latency (dependent
// load levels, the per-pair filter and score chain), not the division: the
// node tile gains where a block shares nodes between pods (C=64 at
// N=8192), and the one-pair launch ties the first design at a group of one.
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
constexpr int kPorts = 4;
constexpr int kDra = 5;
// ext_sel values: 0-3 a node_bits bit, 4-5 a vol_bits bit, 6 spread_ok.
constexpr int kSelVol = 4;
constexpr int kSelSpread = 6;
constexpr int kMaxBalanced = 8;
constexpr int kMaxShape = 16;   // RequestedToCapacityRatio shape points
constexpr int kMaxHidden = 16;  // LearnedScorer hidden units
constexpr int kFeatures = 5;    // LearnedScorer input features
// Scoring strategies of NodeResourcesFit.
constexpr int kLeast = 0;
constexpr int kMost = 1;
constexpr int kRatio = 2;
// np.spacing(np.finfo(np.float64).eps): jnp.interp's zero-width segment test.
constexpr double kInterpEps = 4.930380657631324e-32;
// The node tile: nodes a block at most (its threads), pods a block at most,
// and the resource columns staged in shared memory (columns past it are
// read from global memory, so R is not bounded).
constexpr int kTile = 128;
constexpr int kGroup = 4;
constexpr int kStageR = 8;
constexpr int kStageS = 8;  // fit strategy entries staged (more are read from global memory)

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
  const unsigned char* node_bits;        // (C, N), or (C, 1) pinned: bit 0 NodeAffinity, bit 1 TaintToleration
  const unsigned char* spread_ok;        // (C, N): PodTopologySpread
  const unsigned char* vol_bits;         // (C, N): bit 0 VolumeRestrictions, bit 1 NodeVolumeLimits
  const int* pin_row;                    // (C,) pinned mode, else null
  // Host ports: the node counts and the chunk's wants (null when the batch
  // carries no port feature: nothing conflicts).
  const int* port_counts;                // (P, N)
  const int* portkey_counts;             // (PK, N)
  const int* port_triples;               // (C, S), -1 pad
  const int* port_keys;                  // (C, S)
  const int* port_wild;                  // (C, S): the want's wildcard-IP triple
  const unsigned char* port_is_wild;     // (C, S)
  // ImageLocality's raw score, (C, N), or (C, 1) pinned; null: not scored.
  const unsigned char* il_scores;
  // DynamicResources: the node columns and the chunk's claim slots (null
  // when the batch carries no resolved claim), pins and missing flags.
  const int* dra_cap;                    // (DC, N)
  const int* dra_alloc;                  // (DC, N)
  const int* dra_claim_counts;           // (CLM, N)
  const int* dra_ids;                    // (C, SK), -1 pad
  const int* dra_cls;                    // (C, SK)
  const int* dra_cnt;                    // (C, SK)
  const int* dra_pins;                   // (C, PIN), -1 pad
  const unsigned char* dra_missing;      // (C,)
  int SK, PIN, DC;
  // ThroughputAware and LearnedScorer: the node's topology values, the
  // chunk's score tables and class slot, the learned term's requests and
  // weights (w1 (5, H) row-major, b1 (H,), w2 (H,), b2).
  const int* topo_vals;                  // (N, TK)
  const long long* tp_scores;            // (C, DV)
  const int* tp_slot;                    // (C,)
  const long long* ls_req_cpu;           // (C,)
  const long long* ls_req_mem;           // (C,)
  const float* lw;                       // (5H + H + H + 1,)
  int TK, DV, H;
  // Filter range: the feasible set to start from, (C, N) or (C, 1), and
  // the fail bit of the first filter; null: every valid node, bit 0.
  const unsigned char* feas_in;
  int bit0;
  // Static profile config.
  const unsigned char* fit_ignored;  // (R,)
  const long long* strat_cols;       // (S, 3): kind, col, weight
  int n_strat;
  int strategy;                      // kLeast, kMost or kRatio
  const double* shape;               // (2, n_shape): utilizations, then scores
  int n_shape;
  const int* bal_cols;  // (B,)
  int n_bal;
  int score_fit;
  long long fit_weight;
  int score_bal;
  long long bal_weight;
  long long il_weight;
  long long tp_weight;  // 0: ThroughputAware does not score
  long long ls_weight;  // 0: LearnedScorer does not score
  long long filter_codes;  // 3 bits per filter, in fail-bit order
  int n_filters;
  long long ext_sel;  // 3 bits per kExt filter (see kSelVol, kSelSpread)
  int C, N, R, S;
  // Outputs.
  unsigned char* feasible;  // (C, N)
  long long* total;         // (C, N)
  unsigned int* fail_mask;  // (C,)
};

// One node as a thread sees it: its scalars in registers, its R-wide rows
// in the block's shared tile (columns below ``staged``, column r at
// s_*[r * kTile]) or in global memory.
struct NodeRow {
  int n;
  bool valid, unsched;
  int name, num_pods, allowed, nom_cnt, nom_prio;
  long long nz0, nz1;       // nonzero_req
  long long weight_sum;     // NodeResourcesFit: the weights of the columns the node has
  const long long* s_alloc;
  const long long* s_req;
  const long long* s_nreq;
  const long long* g_alloc;
  const long long* g_req;
  const long long* g_nreq;
  int staged;
  __device__ long long alloc(int r) const { return r < staged ? s_alloc[r * kTile] : g_alloc[r]; }
  __device__ long long req(int r) const { return r < staged ? s_req[r * kTile] : g_req[r]; }
  __device__ long long nreq(int r) const { return r < staged ? s_nreq[r * kTile] : g_nreq[r]; }
};

// One pod of the chunk: its scalars, its request row staged (columns below
// ``staged``) or in global memory.
struct PodRow {
  int c;
  int nodename, prio, nomrow;
  bool tol;
  long long nz0, nz1;  // pod_nonzero
  const long long* s_req;
  const long long* g_req;
  int staged;
  __device__ long long req(int r) const { return r < staged ? s_req[r] : g_req[r]; }
};

// The static config a pair reads, staged in shared memory by the tiled
// launch (entries below ``strat_staged``, columns below ``ign_staged``;
// the rest from global memory) or read from global memory.
struct Cfg {
  const long long* strat;     // (n_strat, 3): kind, col, weight
  const int* bal;             // (n_bal,)
  const unsigned char* ign;   // (R,)
  int strat_staged, ign_staged;
  __device__ long long st(const EvalArgs& a, int s, int k) const {
    return s < strat_staged ? strat[3 * s + k] : a.strat_cols[3 * s + k];
  }
  __device__ bool ignored(const EvalArgs& a, int r) const { return (r < ign_staged ? ign[r] : a.fit_ignored[r]) != 0; }
};

__device__ Cfg global_cfg(const EvalArgs& a) {
  return Cfg{a.strat_cols, a.bal_cols, a.fit_ignored, a.n_strat, a.R};
}

// The NodeResourcesFit column a strategy entry scores: its allocatable.
__device__ __forceinline__ long long strat_alloc(const NodeRow& row, long long kind, int col) {
  return kind == 0 ? row.alloc(0) : (kind == 1 ? row.alloc(1) : row.alloc(col));
}

// A node's scalars and global rows; the caller points the staged rows.
__device__ void load_node(const EvalArgs& a, int n, NodeRow& row) {
  row.n = n;
  row.valid = a.valid[n] != 0;
  row.unsched = a.unschedulable[n] != 0;
  row.name = a.name_id[n];
  row.num_pods = a.num_pods[n];
  row.allowed = a.allowed_pods[n];
  row.nz0 = a.nonzero_req[(size_t)n * 2];
  row.nz1 = a.nonzero_req[(size_t)n * 2 + 1];
  row.g_alloc = a.alloc + (size_t)n * a.R;
  row.g_req = a.req + (size_t)n * a.R;
  row.g_nreq = a.nom_req == nullptr ? nullptr : a.nom_req + (size_t)n * a.R;
  row.nom_cnt = a.nom_req == nullptr ? 0 : a.nom_cnt[n];
  row.nom_prio = a.nom_req == nullptr ? 0 : a.nom_prio[n];
  row.staged = 0;
}

// The per-node part of the fit score: absent resources (alloc <= 0) skip
// their weight, so the divisor of the weighted sum is the node's alone.
__device__ void node_weights(const EvalArgs& a, const Cfg& cfg, NodeRow& row) {
  long long ws = 0;
  for (int s = 0; a.score_fit && s < a.n_strat; ++s) {
    if (strat_alloc(row, cfg.st(a, s, 0), (int)cfg.st(a, s, 1)) > 0) ws += cfg.st(a, s, 2);
  }
  row.weight_sum = ws;
}

// Pod c's features read from global memory (pinned and columns launches).
__device__ PodRow load_pod(const EvalArgs& a, int c) {
  PodRow p;
  p.c = c;
  p.nodename = a.nodename_id == nullptr ? -1 : a.nodename_id[c];
  p.tol = a.tol_unsched != nullptr && a.tol_unsched[c] != 0;
  p.prio = a.priority == nullptr ? 0 : a.priority[c];
  p.nomrow = a.nominated_row == nullptr ? -1 : a.nominated_row[c];
  p.nz0 = a.pod_nonzero[(size_t)c * 2];
  p.nz1 = a.pod_nonzero[(size_t)c * 2 + 1];
  p.g_req = a.pod_req + (size_t)c * a.R;
  p.s_req = nullptr;
  p.staged = 0;
  return p;
}

__device__ bool fit_filter(const EvalArgs& a, const Cfg& cfg, const NodeRow& row, const PodRow& pod) {
  const int R = a.R;
  bool fits = row.num_pods + 1 <= row.allowed;
  for (int r = 0; r < R; ++r) {
    long long rf = cfg.ignored(a, r) ? 0 : pod.req(r);
    long long free_r = row.alloc(r) - row.req(r);
    if (!(rf == 0 || rf <= free_r)) fits = false;
  }
  if (a.nom_req != nullptr) {
    const bool self = pod.nomrow >= 0 && pod.nomrow == row.n;
    bool fits_nom = true;
    for (int r = 0; r < R; ++r) {
      long long rf = cfg.ignored(a, r) ? 0 : pod.req(r);
      long long eff = row.nreq(r) - (self ? pod.req(r) : 0);
      if (eff < 0) eff = 0;
      long long free_r = row.alloc(r) - row.req(r);
      if (!(rf == 0 || rf <= free_r - eff)) fits_nom = false;
    }
    int eff_cnt = row.nom_cnt - (self ? 1 : 0);
    if (eff_cnt < 0) eff_cnt = 0;
    fits_nom = fits_nom && (row.num_pods + 1 + eff_cnt <= row.allowed);
    const bool applies = pod.prio <= row.nom_prio;
    fits = fits && (fits_nom || !applies);
  }
  return fits;
}

// HostPortInfo.CheckConflict for each active want of pod c on node n: a
// wildcard-IP want conflicts with any use of its (proto, port) key, a
// specific one with its own triple or the wildcard triple in use.
__device__ bool ports_filter(const EvalArgs& a, int c, int n) {
  if (a.port_triples == nullptr) return true;
  for (int s = 0; s < a.S; ++s) {
    const size_t o = (size_t)c * a.S + s;
    const int triple = a.port_triples[o];
    if (triple < 0) continue;
    bool conflict;
    if (a.port_is_wild[o]) {
      conflict = a.portkey_counts[(size_t)max(a.port_keys[o], 0) * a.N + n] > 0;
    } else {
      conflict = a.port_counts[(size_t)triple * a.N + n] > 0 ||
                 a.port_counts[(size_t)max(a.port_wild[o], 0) * a.N + n] > 0;
    }
    if (conflict) return false;
  }
  return true;
}

__device__ bool dra_filter(const EvalArgs& a, int c, int n, int name) {
  if (!dra_pins_ok(a.dra_missing[c], a.dra_pins + (size_t)c * a.PIN, a.PIN, name)) return false;
  if (a.dra_ids == nullptr) return true;
  const size_t o = (size_t)c * a.SK;
  return dra_demand_fits(
      a.dra_ids + o, a.dra_cls + o, a.dra_cnt + o, a.SK, a.DC, a.dra_cap, a.N, n,
      [&](int k) { return a.dra_claim_counts[(size_t)k * a.N + n]; },
      [&](int d) { return (long long)a.dra_alloc[(size_t)d * a.N + n]; });
}

// jnp.interp(util, xs, ys) (constant outside [xs[0], xs[P-1]]) in jnp's
// operation order; xs are the shape's utilizations, ys its scores.
__device__ double interp(const double* xs, const double* ys, int P, double util) {
  int i = 0;
  while (i < P && xs[i] <= util) ++i;  // searchsorted(xs, util, side="right")
  i = i < 1 ? 1 : (i > P - 1 ? P - 1 : i);
  const double df = ys[i] - ys[i - 1];
  const double dx = xs[i] - xs[i - 1];
  const double delta = util - xs[i - 1];
  const bool dx0 = fabs(dx) <= kInterpEps;
  // One rounding for the last multiply-add, as XLA fuses it (the build's
  // -fmad=false keeps every other product and sum separate).
  double f = dx0 ? ys[i - 1] : fma(delta / (dx0 ? 1.0 : dx), df, ys[i - 1]);
  if (util < xs[0]) f = ys[0];
  if (util > xs[P - 1]) f = ys[P - 1];
  return f;
}

// RequestedToCapacityRatio's score of one resource with al > 0
// (requested_to_capacity_ratio.go): the shape at the utilization, scaled
// by MaxNodeScore/10 and truncated; 0 when requested exceeds allocatable.
__device__ long long ratio_score(const EvalArgs& a, long long al, long long rq) {
  const double util = ((double)rq * 100.0) / (double)(al > 1 ? al : 1);
  const double raw = interp(a.shape, a.shape + a.n_shape, a.n_shape, util);
  return rq <= al ? (long long)(raw * 10.0) : 0;
}

// The pod's throughput table at the node's accelerator-class id (slot and
// id clamped into range as JAX's gather clamps), 0 where the node has none.
__device__ long long tput_gather(const EvalArgs& a, int c, int n) {
  int slot = a.tp_slot[c];
  slot = slot < 0 ? 0 : (slot > a.TK - 1 ? a.TK - 1 : slot);
  int v = a.topo_vals[(size_t)n * a.TK + slot];
  if (v < 0) return 0;
  v = v > a.DV - 1 ? a.DV - 1 : v;
  return a.tp_scores[(size_t)c * a.DV + v];
}

// XLA's f32 tanh on the CPU (ops/learned.py xla_tanh): the input clamped,
// x*P(x^2)/Q(x^2) with every Horner step one fused multiply-add, x itself
// below 0.0004 and +-1 from 20 on.
__device__ float xla_tanh(float x) {
  const float xc = fminf(fmaxf(x, -7.998811721801758f), 7.998811721801758f);
  const float x2 = xc * xc;
  float p = -2.7607683663038313e-16f;
  p = fmaf(x2, p, 2.0001879384549948e-13f);
  p = fmaf(x2, p, -8.604671836165423e-11f);
  p = fmaf(x2, p, 5.122297253024044e-08f);
  p = fmaf(x2, p, 1.4857223504805006e-05f);
  p = fmaf(x2, p, 0.0006372619536705315f);
  p = fmaf(x2, p, 0.004893524572253227f);
  float q = 1.1982583600911312e-06f;
  q = fmaf(x2, q, 0.00011853470641653985f);
  q = fmaf(x2, q, 0.0022684347350150347f);
  q = fmaf(x2, q, 0.0048935250379145145f);
  float r = (xc * p) / q;
  const float ax = fabsf(x);
  if (ax < 0.00039999998989515007f) r = x;
  if (ax >= 20.0f) r = copysignf(1.0f, x);
  return r;
}

// exp(x) + 1 as XLA's f32 exp followed by + 1 on the CPU (ops/learned.py
// xla_exp_plus_one): range reduction by floor, a fused Horner polynomial,
// and the scaling by 2^n fused with the + 1.
__device__ float xla_exp_plus_one(float x) {
  x = fminf(fmaxf(x, -87.80000305175781f), 88.80000305175781f);
  const float n = fminf(fmaxf(floorf(fmaf(x, 1.4426950216293335f, 0.5f)), -127.0f), 127.0f);
  float r = fmaf(n, -0.693359375f, x);
  r = fmaf(n, 0.00021219444170128554f, r);
  float p = 0.00019875691214110702f;
  p = fmaf(p, r, 0.001398199936375022f);
  p = fmaf(p, r, 0.008333452045917511f);
  p = fmaf(p, r, 0.04166579619050026f);
  p = fmaf(p, r, 0.1666666567325592f);
  p = fmaf(p, r, 0.5f);
  const float e = fmaf(p, r * r, r) + 1.0f;
  return fmaf(e, __int_as_float(((int)n + 127) << 23), 1.0f);
}

// bias + sum of w[i] * x[i] left to right, each step one fused multiply-add;
// a zero bias vanishes and the first two products then meet in one fused
// step (ops/learned.py _affine).
__device__ float affine(const float* x, const float* w, int k, float bias) {
  float acc;
  int i0 = 1;
  if (bias == 0.0f) {
    acc = fmaf(x[0], w[0], x[1] * w[1]);
    i0 = 2;
  } else {
    acc = fmaf(x[0], w[0], bias);
  }
  for (int i = i0; i < k; ++i) acc = fmaf(x[i], w[i], acc);
  return acc;
}

// LearnedScorer's f32 forward pass for pod c on node n, in the arithmetic
// XLA's vectorized loop gives the reference's jitted score (ops/learned.py
// pre_floor): each sum is a chain of fused multiply-adds from the bias, a
// zero bias vanishes (then the first two products meet in one fused
// step), and the throughput feature's / 100 folds into its weight.
__device__ long long learned_score(const EvalArgs& a, const NodeRow& row, int c) {
  const int H = a.H;
  const float alloc_cpu = (float)row.alloc(0);
  const float alloc_mem = (float)row.alloc(1);
  const float safe_cpu = fmaxf(alloc_cpu, 1.0f);
  const float safe_mem = fmaxf(alloc_mem, 1.0f);
  const float req_cpu = (float)a.ls_req_cpu[c];
  const float req_mem = (float)a.ls_req_mem[c];
  float x[kFeatures];
  x[0] = fmaxf((alloc_cpu - req_cpu) / safe_cpu, 0.0f);
  x[1] = fmaxf((alloc_mem - req_mem) / safe_mem, 0.0f);
  x[2] = (float)row.num_pods / fmaxf((float)row.allowed, 1.0f);
  x[3] = (float)tput_gather(a, c, row.n);
  x[4] = req_cpu / safe_cpu;
  const float* w1 = a.lw;
  const float* b1 = a.lw + kFeatures * H;
  const float* w2 = b1 + H;  // then b2
  float h[kMaxHidden];
  for (int j = 0; j < H; ++j) {
    float w[kFeatures];
    for (int i = 0; i < kFeatures; ++i) w[i] = i == 3 ? w1[i * H + j] / 100.0f : w1[i * H + j];
    h[j] = xla_tanh(affine(x, w, kFeatures, b1[j]));
  }
  const float y = affine(h, w2, H, w2[H]);
  const float s = 1.0f / xla_exp_plus_one(-y);
  return (long long)floorf(fmaf(s, 100.0f, 0.5f));
}

// kTerms: the instantiation with the three score terms above
// (RequestedToCapacityRatio, ThroughputAware, LearnedScorer); launches without them take the other,
// whose registers stay those of the terms-free chain.  The weight sum of
// the node's columns comes from node_weights.
template <bool kTerms>
__device__ long long fit_score(const EvalArgs& a, const Cfg& cfg, const NodeRow& row, const PodRow& pod) {
  long long node_score = 0;
  for (int s = 0; s < a.n_strat; ++s) {
    const long long kind = cfg.st(a, s, 0);
    const int col = (int)cfg.st(a, s, 1);
    const long long w = cfg.st(a, s, 2);
    const long long al = strat_alloc(row, kind, col);
    long long rq;
    if (kind == 0) {  // NonZeroRequested.MilliCPU
      rq = row.nz0 + pod.nz0;
    } else if (kind == 1) {  // NonZeroRequested.Memory
      rq = row.nz1 + pod.nz1;
    } else {  // Requested column
      rq = row.req(col) + pod.req(col);
    }
    if (al > 0) {  // absent resources skip their weight too
      long long sc = 0;
      if (kTerms && a.strategy == kRatio) {
        sc = ratio_score(a, al, rq);
      } else if (rq <= al) {
        sc = a.strategy == kMost ? floordiv_f64(rq * 100, al)
                                 : floordiv_f64((al - rq) * 100, al);
      }
      node_score += sc * w;
    }
  }
  return row.weight_sum > 0 ? floordiv_f64(node_score, row.weight_sum) : 0;
}

__device__ long long balanced_score(const EvalArgs& a, const Cfg& cfg, const NodeRow& row, const PodRow& pod) {
  double f[kMaxBalanced];
  bool p[kMaxBalanced];
  double total = 0.0;
  long long count = 0;
  for (int b = 0; b < a.n_bal; ++b) {
    const int col = cfg.bal[b];
    const long long al = row.alloc(col);
    const long long rq = row.req(col) + pod.req(col);
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

// A pair's bytes of the precomputed planes, read before its filter chain
// (null planes read as 0).
struct Planes {
  unsigned char node_bits, spread_ok, vol_bits;
};

__device__ __forceinline__ Planes load_planes(const EvalArgs& a, size_t op) {
  return Planes{a.node_bits == nullptr ? (unsigned char)0 : a.node_bits[op],
                a.spread_ok == nullptr ? (unsigned char)0 : a.spread_ok[op],
                a.vol_bits == nullptr ? (unsigned char)0 : a.vol_bits[op]};
}

// Filter b's own verdict for the pod on the node.
__device__ __forceinline__ bool filter_ok(const EvalArgs& a, const Cfg& cfg, int b, const NodeRow& row,
                                          const PodRow& pod, const Planes& pl) {
  const int code = (int)((a.filter_codes >> (3 * b)) & 7);
  if (code == kUnschedulable) return !row.unsched || pod.tol;
  if (code == kNodeName) return pod.nodename == -1 || row.name == pod.nodename;
  if (code == kFit) return fit_filter(a, cfg, row, pod);
  if (code == kPorts) return ports_filter(a, pod.c, row.n);
  if (code == kDra) return dra_filter(a, pod.c, row.n, row.name);
  const int sel = (int)((a.ext_sel >> (3 * b)) & 7);
  if (sel == kSelSpread) return pl.spread_ok != 0;
  if (sel >= kSelVol) return ((pl.vol_bits >> (sel - kSelVol)) & 1) != 0;
  return ((pl.node_bits >> sel) & 1) != 0;
}

// One pair: the filter chain (stopping at the first that fails: later
// verdicts set no bit), the weighted scores, both outputs at ``o``.  The
// pair's plane bytes, its image score and, in a filter range, its input
// feasibility and total are loaded first, together.  Returns the pair's
// fail bits.
template <bool kTerms>
__device__ unsigned int eval_pair(const EvalArgs& a, const Cfg& cfg, const NodeRow& row, const PodRow& pod,
                                  size_t o) {
  const Planes pl = load_planes(a, o);
  const bool in_range = a.feas_in == nullptr || a.feas_in[o] != 0;
  const long long total_in = a.feas_in == nullptr ? 0 : a.total[o];
  const long long il = a.il_scores == nullptr ? 0 : (long long)a.il_scores[o];
  unsigned int bits = 0;
  bool feas = row.valid && in_range;
  for (int b = 0; feas && b < a.n_filters; ++b) {
    if (!filter_ok(a, cfg, b, row, pod, pl)) {
      bits |= 1u << (b + a.bit0);
      feas = false;
    }
  }
  long long tot = 0;
  if (feas) {
    if (a.score_fit) tot += fit_score<kTerms>(a, cfg, row, pod) * a.fit_weight;
    if (a.score_bal) tot += balanced_score(a, cfg, row, pod) * a.bal_weight;
    tot += il * a.il_weight;
    if (kTerms && a.tp_weight != 0) tot += tput_gather(a, pod.c, row.n) * a.tp_weight;
    if (kTerms && a.ls_weight != 0) tot += learned_score(a, row, pod.c) * a.ls_weight;
    tot += total_in;  // a filter range adds to the set's scores
  }
  a.feasible[o] = feas ? 1 : 0;
  a.total[o] = tot;
  return bits;
}

// The node-tiled launch: block (x, y) evaluates nodes [x*T, x*T + T) for
// pods [y*group, y*group + group) of the chunk, T = blockDim.x.  Every
// load of the block is issued before its one barrier: each thread its
// node's scalars and the first kStageR columns of its rows (into its own
// column of the tile), the threads together the group's pod features and
// the static config.
template <bool kTerms>
__global__ void __launch_bounds__(kTile) eval_chunk_kernel(EvalArgs a, int group) {
  __shared__ long long s_node[3][kStageR][kTile];  // alloc, req, nom_req columns
  __shared__ long long s_preq[kGroup][kStageR];
  __shared__ long long s_pnz[kGroup][2];
  __shared__ int s_pi[kGroup][4];  // node-name id, toleration, priority, nominated row
  __shared__ long long s_strat[kStageS * 3];
  __shared__ int s_bal[kMaxBalanced];
  __shared__ unsigned char s_ign[kStageR];
  const int t = threadIdx.x, T = blockDim.x;
  const int n = blockIdx.x * T + t;
  const int c0 = blockIdx.y * group;
  const int pods = min(group, a.C - c0);
  const int R = a.R;
  const bool live = n < a.N;
  NodeRow row;
  if (live) {
    load_node(a, n, row);
#pragma unroll
    for (int r = 0; r < kStageR; ++r) {
      if (r < R) {
        s_node[0][r][t] = row.g_alloc[r];
        s_node[1][r][t] = row.g_req[r];
        if (row.g_nreq != nullptr) s_node[2][r][t] = row.g_nreq[r];
      }
    }
    row.s_alloc = &s_node[0][0][t];
    row.s_req = &s_node[1][0][t];
    row.s_nreq = &s_node[2][0][t];
    row.staged = kStageR;
  }
  const int rs = min(R, kStageR);
  for (int e = t; e < pods * kStageR; e += T) {
    const int g = e / kStageR, r = e % kStageR;
    if (r < rs) s_preq[g][r] = a.pod_req[(size_t)(c0 + g) * R + r];
  }
  if (t < pods) {
    const PodRow p = load_pod(a, c0 + t);
    s_pnz[t][0] = p.nz0;
    s_pnz[t][1] = p.nz1;
    s_pi[t][0] = p.nodename;
    s_pi[t][1] = p.tol;
    s_pi[t][2] = p.prio;
    s_pi[t][3] = p.nomrow;
  }
  const int ss = min(a.n_strat, kStageS);
  if (t < ss * 3) s_strat[t] = a.strat_cols[t];
  if (t < a.n_bal) s_bal[t] = a.bal_cols[t];
  if (t < rs) s_ign[t] = a.fit_ignored[t];
  __syncthreads();
  const Cfg cfg{s_strat, s_bal, s_ign, ss, rs};
  if (live) node_weights(a, cfg, row);
  for (int g = 0; g < pods; ++g) {
    PodRow pod;
    pod.c = c0 + g;
    pod.nodename = s_pi[g][0];
    pod.tol = s_pi[g][1] != 0;
    pod.prio = s_pi[g][2];
    pod.nomrow = s_pi[g][3];
    pod.nz0 = s_pnz[g][0];
    pod.nz1 = s_pnz[g][1];
    pod.s_req = s_preq[g];
    pod.g_req = a.pod_req + (size_t)pod.c * R;
    pod.staged = kStageR;
    const unsigned int bits = live ? eval_pair<kTerms>(a, cfg, row, pod, (size_t)pod.c * a.N + n) : 0u;
    const unsigned int warp_bits = __reduce_or_sync(0xffffffffu, bits);
    if ((t & 31) == 0 && warp_bits != 0) atomicOr(a.fail_mask + pod.c, warp_bits);
  }
}

// One thread a pair, for launches whose group is one pod (kernels.eval_tile
// gives a group of one where a grid of larger groups would leave SMs idle):
// a tile would share no node row between pods, so the node's rows, the
// pod and the config are read from global memory without the staging and
// its barrier, which measured slower at those shapes.
template <bool kTerms>
__global__ void eval_direct_kernel(EvalArgs a) {
  const int c = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int bits = 0;
  if (n < a.N) {
    NodeRow row;
    load_node(a, n, row);
    const Cfg cfg = global_cfg(a);
    node_weights(a, cfg, row);
    bits = eval_pair<kTerms>(a, cfg, row, load_pod(a, c), (size_t)c * a.N + n);
  }
  const unsigned int warp_bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && warp_bits != 0) atomicOr(a.fail_mask + c, warp_bits);
}

// Pinned mode: one thread a pod, on its own row; the tile gains nothing
// (no two pods share a node's reads).
template <bool kTerms>
__global__ void eval_pinned_kernel(EvalArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const int n = a.pin_row[c];
  if (n < 0 || n >= a.N) return;
  NodeRow row;
  load_node(a, n, row);
  const Cfg cfg = global_cfg(a);
  node_weights(a, cfg, row);
  const unsigned int bits = eval_pair<kTerms>(a, cfg, row, load_pod(a, c), (size_t)c);
  if (bits != 0) atomicOr(a.fail_mask + c, bits);
}

// Columns mode (the attribution pass, kubernetes_tpu/engine/pass_.py:
// 812-886): every filter's own verdict as bit b of ok_bits, not masked by
// the filters before it; feasible, the valid nodes passing them all; each
// scorer's column before its weight, on every node, in the row of cols
// that col_rows gives it (4 bits a scorer: fit, balanced, image,
// throughput, learned; 15 when it does not score); total, the weighted
// sum.  No scorer here normalizes over the feasible set, so nothing waits
// for the filters of the other kernels.  It keeps one thread per (pod,
// node) with its rows read from global memory: the attribution pass runs
// it at C=1, where a tile shares nothing; the block width is the tile's.
constexpr int kColFit = 0;
constexpr int kColBal = 1;
constexpr int kColImage = 2;
constexpr int kColTput = 3;
constexpr int kColLearned = 4;

__device__ __forceinline__ void put_col(long long* cols, int col_rows, int kind, size_t plane, size_t o,
                                        long long v) {
  cols[(size_t)((col_rows >> (4 * kind)) & 15) * plane + o] = v;
}

template <bool kTerms>
__global__ void eval_cols_kernel(EvalArgs a, int* ok_bits, long long* cols, int col_rows) {
  const int c = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const size_t o = (size_t)c * a.N + n;
  const size_t plane = (size_t)a.C * a.N;
  NodeRow row;
  load_node(a, n, row);
  const Cfg cfg = global_cfg(a);
  node_weights(a, cfg, row);
  const PodRow pod = load_pod(a, c);
  const Planes pl = load_planes(a, o);
  int bits = 0;
  bool feas = row.valid;
  for (int b = 0; b < a.n_filters; ++b) {
    const bool ok = filter_ok(a, cfg, b, row, pod, pl);
    bits |= ok ? 1 << b : 0;
    feas = feas && ok;
  }
  long long tot = 0;
  if (a.score_fit) {
    const long long v = fit_score<kTerms>(a, cfg, row, pod);
    put_col(cols, col_rows, kColFit, plane, o, v);
    tot += v * a.fit_weight;
  }
  if (a.score_bal) {
    const long long v = balanced_score(a, cfg, row, pod);
    put_col(cols, col_rows, kColBal, plane, o, v);
    tot += v * a.bal_weight;
  }
  if (a.il_scores != nullptr) {
    const long long v = a.il_scores[o];
    put_col(cols, col_rows, kColImage, plane, o, v);
    tot += v * a.il_weight;
  }
  if (kTerms && a.tp_weight != 0) {
    const long long v = tput_gather(a, c, n);
    put_col(cols, col_rows, kColTput, plane, o, v);
    tot += v * a.tp_weight;
  }
  if (kTerms && a.ls_weight != 0) {
    const long long v = learned_score(a, row, c);
    put_col(cols, col_rows, kColLearned, plane, o, v);
    tot += v * a.ls_weight;
  }
  ok_bits[o] = bits;
  a.feasible[o] = feas ? 1 : 0;
  a.total[o] = tot;
}

}  // namespace

// The launchers' shared parameters (eval_chunk_launch and
// eval_chunk_cols_launch differ only in their outputs).
#define EVAL_PARAMS \
    const void* valid, const void* name_id, const void* unschedulable, const void* num_pods, \
    const void* allowed_pods, const void* alloc, const void* req, const void* nonzero_req, \
    const void* nom_req, const void* nom_cnt, const void* nom_prio, const void* nodename_id, \
    const void* tol_unsched, const void* pod_req, const void* pod_nonzero, const void* priority, \
    const void* nominated_row, const void* node_bits, const void* spread_ok, const void* vol_bits, \
    const void* pin_row, const void* fit_ignored, const void* port_counts, const void* portkey_counts, \
    const void* port_triples, const void* port_keys, const void* port_wild, const void* port_is_wild, \
    const void* il_scores, const void* dra_cap, const void* dra_alloc, const void* dra_claim_counts, \
    const void* dra_ids, const void* dra_cls, const void* dra_cnt, const void* dra_pins, \
    const void* dra_missing, int SK, int PIN, int DC, const void* topo_vals, const void* tp_scores, \
    const void* tp_slot, const void* ls_req_cpu, const void* ls_req_mem, const void* lw, int TK, \
    int DV, int H, const void* feas_in, int bit0, const void* strat_cols, int n_strat, int strategy, \
    const void* shape, int n_shape, const void* bal_cols, int n_bal, int score_fit, \
    long long fit_weight, int score_bal, long long bal_weight, long long il_weight, \
    long long tp_weight, long long ls_weight, long long filter_codes, int n_filters, long long ext_sel, \
    int C, int N, int R, int S
#define EVAL_ARGS \
    valid, name_id, unschedulable, num_pods, allowed_pods, alloc, req, nonzero_req, nom_req, nom_cnt, \
    nom_prio, nodename_id, tol_unsched, pod_req, pod_nonzero, priority, nominated_row, node_bits, \
    spread_ok, vol_bits, pin_row, fit_ignored, port_counts, portkey_counts, port_triples, port_keys, \
    port_wild, port_is_wild, il_scores, dra_cap, dra_alloc, dra_claim_counts, dra_ids, dra_cls, \
    dra_cnt, dra_pins, dra_missing, SK, PIN, DC, topo_vals, tp_scores, tp_slot, ls_req_cpu, ls_req_mem, \
    lw, TK, DV, H, feas_in, bit0, strat_cols, n_strat, strategy, shape, n_shape, bal_cols, n_bal, \
    score_fit, fit_weight, score_bal, bal_weight, il_weight, tp_weight, ls_weight, filter_codes, \
    n_filters, ext_sel, C, N, R, S

namespace {

// The argument block of a launch, or cudaErrorInvalidValue in *rc.
EvalArgs make_args(EVAL_PARAMS, int* rc) {
  *rc = 0;
  if (n_bal > kMaxBalanced || H > kMaxHidden || bit0 < 0 || bit0 + n_filters > 32) {
    *rc = (int)cudaErrorInvalidValue;
  }
  if (strategy == kRatio && (n_shape < 2 || n_shape > kMaxShape)) *rc = (int)cudaErrorInvalidValue;
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
  a.port_counts = static_cast<const int*>(port_counts);
  a.portkey_counts = static_cast<const int*>(portkey_counts);
  a.port_triples = static_cast<const int*>(port_triples);
  a.port_keys = static_cast<const int*>(port_keys);
  a.port_wild = static_cast<const int*>(port_wild);
  a.port_is_wild = static_cast<const unsigned char*>(port_is_wild);
  a.il_scores = static_cast<const unsigned char*>(il_scores);
  a.dra_cap = static_cast<const int*>(dra_cap);
  a.dra_alloc = static_cast<const int*>(dra_alloc);
  a.dra_claim_counts = static_cast<const int*>(dra_claim_counts);
  a.dra_ids = static_cast<const int*>(dra_ids);
  a.dra_cls = static_cast<const int*>(dra_cls);
  a.dra_cnt = static_cast<const int*>(dra_cnt);
  a.dra_pins = static_cast<const int*>(dra_pins);
  a.dra_missing = static_cast<const unsigned char*>(dra_missing);
  a.SK = SK;
  a.PIN = PIN;
  a.DC = DC;
  a.topo_vals = static_cast<const int*>(topo_vals);
  a.tp_scores = static_cast<const long long*>(tp_scores);
  a.tp_slot = static_cast<const int*>(tp_slot);
  a.ls_req_cpu = static_cast<const long long*>(ls_req_cpu);
  a.ls_req_mem = static_cast<const long long*>(ls_req_mem);
  a.lw = static_cast<const float*>(lw);
  a.TK = TK;
  a.DV = DV;
  a.H = H;
  a.feas_in = static_cast<const unsigned char*>(feas_in);
  a.bit0 = bit0;
  a.strat_cols = static_cast<const long long*>(strat_cols);
  a.n_strat = n_strat;
  a.strategy = strategy;
  a.shape = static_cast<const double*>(shape);
  a.n_shape = n_shape;
  a.bal_cols = static_cast<const int*>(bal_cols);
  a.n_bal = n_bal;
  a.score_fit = score_fit;
  a.fit_weight = fit_weight;
  a.score_bal = score_bal;
  a.bal_weight = bal_weight;
  a.il_weight = il_weight;
  a.tp_weight = tp_weight;
  a.ls_weight = ls_weight;
  a.filter_codes = filter_codes;
  a.n_filters = n_filters;
  a.ext_sel = ext_sel;
  a.C = C;
  a.N = N;
  a.R = R;
  a.S = S;
  return a;
}

bool needs_terms(const EvalArgs& a) { return a.strategy == kRatio || a.tp_weight != 0 || a.ls_weight != 0; }

}  // namespace

// tile: nodes a block (a multiple of 32, at most kTile); group: pods a
// block (at most kGroup; 1 takes the one-thread-a-pair launch); both from
// kernels.eval_tile.  A pinned launch runs one thread a pod and ignores
// them.
extern "C" int eval_chunk_launch(EVAL_PARAMS, int tile, int group, void* feasible, void* total, void* fail_mask,
                                 void* stream) {
  int rc;
  EvalArgs a = make_args(EVAL_ARGS, &rc);
  if (rc != 0) return rc;
  if (tile < 32 || tile > kTile || tile % 32 != 0 || group < 1 || group > kGroup) {
    return (int)cudaErrorInvalidValue;
  }
  a.feasible = static_cast<unsigned char*>(feasible);
  a.total = static_cast<long long*>(total);
  a.fail_mask = static_cast<unsigned int*>(fail_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool terms = needs_terms(a);
  if (pin_row != nullptr) {
    const int threads = 128;
    const int blocks = (C + threads - 1) / threads;
    if (terms) {
      eval_pinned_kernel<true><<<blocks, threads, 0, s>>>(a);
    } else {
      eval_pinned_kernel<false><<<blocks, threads, 0, s>>>(a);
    }
  } else if (group == 1) {
    dim3 grid((N + tile - 1) / tile, C);
    if (terms) {
      eval_direct_kernel<true><<<grid, tile, 0, s>>>(a);
    } else {
      eval_direct_kernel<false><<<grid, tile, 0, s>>>(a);
    }
  } else {
    dim3 grid((N + tile - 1) / tile, (C + group - 1) / group);
    if (terms) {
      eval_chunk_kernel<true><<<grid, tile, 0, s>>>(a, group);
    } else {
      eval_chunk_kernel<false><<<grid, tile, 0, s>>>(a, group);
    }
  }
  return (int)cudaGetLastError();
}

// Columns mode: feasible (C, N), total (C, N), ok_bits (C, N) i32 and cols
// (S, C, N) i64, scorer k in row (col_rows >> 4k) & 15; no pin, no filter
// range; ``tile`` threads a block.
extern "C" int eval_chunk_cols_launch(EVAL_PARAMS, int tile, void* feasible, void* total, void* ok_bits,
                                      void* cols, int col_rows, void* stream) {
  int rc;
  EvalArgs a = make_args(EVAL_ARGS, &rc);
  if (rc != 0) return rc;
  if (pin_row != nullptr || feas_in != nullptr || bit0 != 0) return (int)cudaErrorInvalidValue;
  if (tile < 32 || tile > kTile || tile % 32 != 0) return (int)cudaErrorInvalidValue;
  a.feasible = static_cast<unsigned char*>(feasible);
  a.total = static_cast<long long*>(total);
  a.fail_mask = nullptr;
  dim3 grid((N + tile - 1) / tile, C);
  int* bits = static_cast<int*>(ok_bits);
  long long* out = static_cast<long long*>(cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (needs_terms(a)) {
    eval_cols_kernel<true><<<grid, tile, 0, s>>>(a, bits, out, col_rows);
  } else {
    eval_cols_kernel<false><<<grid, tile, 0, s>>>(a, bits, out, col_rows);
  }
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(eval_chunk)
