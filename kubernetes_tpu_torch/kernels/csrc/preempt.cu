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
//   preempt_pick   the lexicographic rank of every possible node (fewest
//                  PDB violations, lowest max victim priority, smallest
//                  priority sum, fewest victims, latest start key, lowest
//                  row), counted by comparing against every other possible
//                  node; then each eligible same-signature mate takes the
//                  node at its cumsum rank.  At chunk 1 the single mate
//                  takes rank 0, the narrowing's argmin; at chunk > 1 a
//                  valid mate left without a node defers (-2).
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
// criteria; bytes-bound.  preempt_pick compares N^2 key tuples of the
// possible nodes; operations-bound at large N, tiled through shared memory.
// preempt_commit touches C rows; launch latency.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "preempt_search.cuh"

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

__device__ int representative(const PodView& p) {
  for (int i = 0; i < p.C; ++i) {
    if (mate_valid(p, i)) return i;
  }
  return 0;
}

// Node a sorts before node b (both possible): the five criteria, then row.
__device__ __forceinline__ bool before(const long long* ka, int ra, const long long* kb, int rb) {
  for (int q = 0; q < 5; ++q) {
    if (ka[q] != kb[q]) return ka[q] < kb[q];
  }
  return ra < rb;
}

// Rank of every possible node among the possible nodes; the node at rank
// r < C is written to order_at[r] (pre-filled with -1).
__global__ void preempt_rank_kernel(const unsigned char* __restrict__ possible,
                                    const long long* __restrict__ crit, int N, int C,
                                    int* order_at) {
  __shared__ long long s_key[kThreads][5];
  __shared__ unsigned char s_ok[kThreads];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  long long mine[5];
  const bool live = n < N && possible[n];
  for (int q = 0; q < 5; ++q) mine[q] = n < N ? crit[(long long)q * N + n] : 0;
  int rank = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int m = base + threadIdx.x;
    s_ok[threadIdx.x] = m < N ? possible[m] : 0;
    for (int q = 0; q < 5; ++q) s_key[threadIdx.x][q] = m < N ? crit[(long long)q * N + m] : 0;
    __syncthreads();
    if (live) {
      const int lim = N - base < kThreads ? N - base : kThreads;
      for (int j = 0; j < lim; ++j) {
        if (s_ok[j] && before(s_key[j], base + j, mine, n)) ++rank;
      }
    }
    __syncthreads();
  }
  if (live && rank < C) order_at[rank] = n;
}

// Each mate's pick: eligible mates (valid, same signature as the
// representative) take the node at their cumsum rank, clipped to N-1 as
// the reference's jnp.clip(rank, 0, n - 1) clips it.
__global__ void preempt_assign_kernel(PodView p, const int* __restrict__ sig,
                                      const int* __restrict__ order_at, int chunk_mode, int N,
                                      int* picks) {
  __shared__ int s_idx0;
  __shared__ int s_count[kThreads / 32];
  __shared__ int s_running;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_idx0 = representative(p);
    s_running = 0;
  }
  __syncthreads();
  const int sig0 = sig[s_idx0];
  for (int base = 0; base < p.C; base += kThreads) {
    const int i = base + tid;
    const bool valid = i < p.C && mate_valid(p, i);
    const bool eligible = valid && sig[i] == sig0;
    const unsigned int ballot = __ballot_sync(0xffffffffu, eligible);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int rank = s_running;
    int tile = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) rank += s_count[w];
      tile += s_count[w];
    }
    rank += __popc(ballot & ((1u << lane) - 1u));
    if (i < p.C) {
      int pick = -1;
      const int r = rank < N - 1 ? rank : N - 1;
      if (eligible && r >= 0 && r < p.C && order_at[r] >= 0) pick = order_at[r];
      if (chunk_mode && valid && pick < 0) pick = -2;
      picks[i] = pick;
    }
    __syncthreads();
    if (tid == 0) s_running += tile;
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

// order_at: (C,) int32 scratch.
extern "C" int preempt_pick_launch(const void* possible, const void* crit, const void* valid,
                                   const void* elig, const void* spec_picks, const void* sig,
                                   int chunk_mode, int C, int N, void* order_at, void* picks,
                                   void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(order_at, 0xff, (size_t)C * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (N > 0) {
    preempt_rank_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(possible), static_cast<const long long*>(crit), N, C,
        static_cast<int*>(order_at));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  PodView p{static_cast<const unsigned char*>(valid), static_cast<const unsigned char*>(elig),
            static_cast<const int*>(spec_picks), C};
  preempt_assign_kernel<<<1, kThreads, 0, s>>>(p, static_cast<const int*>(sig),
                                               static_cast<const int*>(order_at), chunk_mode, N,
                                               static_cast<int*>(picks));
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
