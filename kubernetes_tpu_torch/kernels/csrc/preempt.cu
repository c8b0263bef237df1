// preempt: the PostFilter dry-run of batched preemption.
//
// Replaces kubernetes_tpu/preemption.py:172-658 (build_preempt_pass):
// eval_one (:257-536), the step's pick (:499-520 at chunk 1, the rank split
// :542-600 at chunk > 1) and the commit (:601-617).  The JAX scan over
// chunks of preemptors becomes a host loop of launches per step:
//
//   preempt_eval   one thread per node, in one of three modes (D_STEP):
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
//                  PROLOGUE  the carry of a search (preempt_search.cu): the
//                            masked victims (all below the priority), their
//                            release and count, the base flag.
//                  TAIL      the criteria over the carry the search left.
//                  The representative is the first valid mate (:564); under
//                  the speculative chain valid = eligible && pick < 0, read
//                  from the main pass's picks (:146 _chain_speculative).
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
// Bound: preempt_eval reads each node's V victim slots once (N*V*(R+2)*8
// bytes of requests plus priorities, starts and PDB bits, and the slots'
// port, device and CSI ids where those ops search) and writes the
// criteria; bytes-bound.  preempt_pick reads the possible flags and the
// possible nodes' five criteria once; its time is the launch, the sort
// network's stages and the cluster barriers (latency).
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

// The criteria and outputs of node n over its final victim set.
__device__ void write_tail(const Args& a, int n, int i0, unsigned long long mask, const long long* rel,
                           unsigned char flags) {
  const int V = a.d[D_V], R = a.d[D_R], N = a.d[D_N], P = a.d[D_P];
  const int* vp = at<int>(a, P_VIC_PRIO) + (long long)n * V;
  const long long* nonzero = at<long long>(a, P_VIC_NONZERO);
  const unsigned char* pdb = at<unsigned char>(a, P_VIC_PDB);
  const long long* allowed = at<long long>(a, P_PDB_ALLOWED);
  const int nv = __popcll(mask);
  const int need = F_BASE | F_HARD | F_FEAS;
  const bool poss = (flags & need) == need && nv >= 1 && mate_valid(a, i0);
  long long violations = 0;
  for (int q = 0; q < P; ++q) {
    long long c = 0;
    for (int v = 0; v < V; ++v) {
      if ((mask >> v) & 1ULL) c += pdb[((long long)n * V + v) * P + q];
    }
    const long long over = c - allowed[q];
    violations += over > 0 ? over : 0;
  }
  int max_prio = -1;
  long long prio_sum = 0, nz0 = 0, nz1 = 0;
  for (int v = 0; v < V; ++v) {
    if ((mask >> v) & 1ULL) {
      max_prio = vp[v] > max_prio ? vp[v] : max_prio;
      prio_sum += vp[v];
      nz0 += nonzero[((long long)n * V + v) * 2 + 0];
      nz1 += nonzero[((long long)n * V + v) * 2 + 1];
    }
  }
  double min_start = INFINITY;
  for (int v = 0; v < V; ++v) {
    if (((mask >> v) & 1ULL) && vp[v] == max_prio) {
      const double st = at<double>(a, P_VIC_START)[(long long)n * V + v];
      min_start = st < min_start ? st : min_start;
    }
  }
  const long long start_key = isfinite(min_start) ? (long long)(-min_start * 1e6) : kNoStart;
  long long* crit = at<long long>(a, P_CRIT);
  at<unsigned char>(a, P_POSSIBLE)[n] = poss;
  crit[0 * (long long)N + n] = violations;
  crit[1 * (long long)N + n] = max_prio;
  crit[2 * (long long)N + n] = prio_sum;
  crit[3 * (long long)N + n] = nv;
  crit[4 * (long long)N + n] = start_key;
  unsigned char* vm = at<unsigned char>(a, P_VIC_MASK);
  for (int v = 0; v < V; ++v) vm[(long long)n * V + v] = (mask >> v) & 1ULL;
  at<int>(a, P_N_VIC)[n] = nv;
  long long* out_rel = at<long long>(a, P_REL);
  for (int r = 0; r < R; ++r) out_rel[(long long)n * R + r] = rel[r];
  at<long long>(a, P_RELNZ)[(long long)n * 2 + 0] = nz0;
  at<long long>(a, P_RELNZ)[(long long)n * 2 + 1] = nz1;
}

__global__ void preempt_eval_kernel(Args a) {
  __shared__ int s_idx0;
  if (threadIdx.x == 0) s_idx0 = representative(a);
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = a.d[D_N];
  if (n >= N) return;
  const int i0 = s_idx0;
  const int R = a.d[D_R], V = a.d[D_V], mode = a.d[D_STEP];
  long long rel[kMaxR];
  if (mode == TAIL) {
    const long long* crel = at<long long>(a, P_CARRY_REL) + (long long)n * R;
    for (int r = 0; r < R; ++r) rel[r] = crel[r];
    write_tail(a, n, i0, (unsigned long long)at<long long>(a, P_CARRY_MASK)[n], rel,
               at<unsigned char>(a, P_CARRY_FLAGS)[n]);
    return;
  }

  bool base = at<unsigned char>(a, P_VALID)[n] != 0;
  if (has_flag(a, S_UNSCHED)) {
    base = base && (!at<unsigned char>(a, P_UNSCHED)[n] || at<unsigned char>(a, P_TOL_UNSCHED)[i0]);
  }
  if (has_flag(a, S_NODENAME)) {
    const int want = at<int>(a, P_NODENAME_ID)[i0];
    base = base && (want == -1 || at<int>(a, P_NAME_ID)[n] == want);
  }
  const int bits = a.d[D_BITS_MASK];
  if (bits != 0) {
    base = base && ((at<unsigned char>(a, P_NODE_BITS)[(long long)i0 * N + n] & bits) == bits);
  }
  if (has_flag(a, S_DRA)) base = base && dra_hard_ok(a, n, i0);
  const int prio = at<int>(a, P_PRIORITY)[i0];
  const int* vp = at<int>(a, P_VIC_PRIO) + (long long)n * V;
  const long long* vr = at<long long>(a, P_VIC_REQ) + (long long)n * V * R;

  // Phase 1: every lower-priority victim released.
  unsigned long long mask = 0;
  for (int r = 0; r < R; ++r) rel[r] = 0;
  int cnt = 0;
  for (int v = 0; v < V; ++v) {
    if (vp[v] < prio) {
      mask |= 1ULL << v;
      ++cnt;
      for (int r = 0; r < R; ++r) rel[r] += vr[(long long)v * R + r];
    }
  }
  unsigned char flags = (base ? F_BASE : 0) | F_HARD;
  if (mode == PROLOGUE) {
    at<long long>(a, P_CARRY_MASK)[n] = (long long)mask;
    long long* crel = at<long long>(a, P_CARRY_REL) + (long long)n * R;
    for (int r = 0; r < R; ++r) crel[r] = rel[r];
    at<int>(a, P_CARRY_CNT)[n] = cnt;
    at<unsigned char>(a, P_CARRY_FLAGS)[n] = flags;
    return;
  }
  const bool feas_all = fits(a, n, i0, rel, cnt) && local_ok(a, n, i0, mask);
  if (feas_all) flags |= F_FEAS;

  // Phase 2: greedy reprieve, most important first = reverse slot order.
  if (feas_all && !rwop_blocked(a, i0)) {
    long long t_rel[kMaxR];
    for (int s = V - 1; s >= 0; --s) {
      if (!((mask >> s) & 1ULL)) continue;
      for (int r = 0; r < R; ++r) t_rel[r] = rel[r] - vr[(long long)s * R + r];
      const unsigned long long tent = mask & ~(1ULL << s);
      if (fits(a, n, i0, t_rel, cnt - 1) && local_ok(a, n, i0, tent)) {
        mask = tent;
        for (int r = 0; r < R; ++r) rel[r] = t_rel[r];
        --cnt;
      }
    }
  }
  write_tail(a, n, i0, mask, rel, flags);
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

// ptrs: the search::Ptr table (nptrs entries), dims: the search::Dim
// values (ndims), both host arrays.
extern "C" int preempt_eval_launch(const void* ptrs, int nptrs, const void* dims, int ndims,
                                   void* stream) {
  if (nptrs != P_COUNT || ndims != D_COUNT) return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = static_cast<void* const*>(ptrs)[i];
  for (int i = 0; i < D_COUNT; ++i) a.d[i] = static_cast<const int*>(dims)[i];
  if (a.d[D_R] > kMaxR || a.d[D_V] > kMaxV || a.d[D_QC] > kMaxSlots) return (int)cudaErrorInvalidValue;
  const int N = a.d[D_N];
  if (N == 0) return 0;
  preempt_eval_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
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
