// preempt: the PostFilter dry-run of closed-form batched preemption.
//
// Replaces kubernetes_tpu/preemption.py:172-658 (build_preempt_pass) for
// active filter sets whose release-dependent filters reduce to
// NodeResourcesFit: eval_one (:257-536) in its closed form, the step's pick
// (:499-520 at chunk 1, the rank split :542-600 at chunk > 1) and the
// commit (:601-617).  The JAX scan over chunks of preemptors becomes a host
// loop of three launches per step:
//
//   preempt_eval   one thread per node: the representative preemptor's
//                  release-independent filters (NodeUnschedulable, NodeName,
//                  NodeAffinity/TaintToleration bits), the victims below its
//                  priority, the closed-form fit with all of them released,
//                  the greedy reprieve in reverse slot order with the
//                  release carried incrementally (:435-455), and the five
//                  pickOneNodeForPreemption criteria over the final victim
//                  set.  The representative is the first valid mate (:564);
//                  under the speculative chain valid = eligible && pick < 0,
//                  read from the main pass's picks (:146 _chain_speculative).
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
// bytes of requests plus priorities, starts and PDB bits) and writes the
// criteria; bytes-bound.  preempt_pick compares N^2 key tuples of the
// possible nodes; operations-bound at large N, tiled through shared memory.
// preempt_commit touches C rows; launch latency.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 16;
constexpr int kMaxV = 64;
constexpr int kI32Max = 2147483647;
constexpr long long kNoStart = -(1LL << 61);

struct PodView {
  const int* priority;                  // (C,)
  const long long* req;                 // (C, R)
  const int* nodename_id;               // (C,) or null: NodeName inactive
  const unsigned char* tol_unsched;     // (C,) or null: NodeUnschedulable inactive
  const unsigned char* valid;           // (C,) or null: elig + spec_picks
  const unsigned char* elig;            // (C,) speculative eligibility
  const int* spec_picks;                // (C,) the main pass's picks
  const unsigned char* node_bits;       // (C, N) or null
  int bits_mask;                        // node_bits bits that must be set
  int C;
};

__device__ __forceinline__ bool mate_valid(const PodView& p, int i) {
  if (p.valid != nullptr) return p.valid[i] != 0;
  return p.elig[i] != 0 && p.spec_picks[i] < 0;
}

// First valid mate, 0 when none (jnp.argmax of an all-false mask).
__device__ int representative(const PodView& p) {
  for (int i = 0; i < p.C; ++i) {
    if (mate_valid(p, i)) return i;
  }
  return 0;
}

struct EvalArgs {
  // Cluster state.
  const unsigned char* node_valid;  // (N,)
  const int* name_id;               // (N,)
  const unsigned char* unsched;     // (N,)
  const int* num_pods;              // (N,)
  const int* allowed_pods;          // (N,)
  const long long* alloc;           // (N, R)
  const long long* req;             // (N, R)
  // Victims.
  const int* vic_prio;              // (N, V)
  const long long* vic_req;         // (N, V, R)
  const long long* vic_nonzero;     // (N, V, 2)
  const double* vic_start;          // (N, V)
  const unsigned char* vic_pdb;     // (N, V, P)
  const long long* pdb_allowed;     // (P,)
  PodView pod;
  int N, V, R, P;
  // Outputs.
  unsigned char* possible;  // (N,)
  long long* crit;          // (5, N)
  unsigned char* vic_mask;  // (N, V)
  int* n_vic;               // (N,)
  long long* rel;           // (N, R)
  long long* relnz;         // (N, 2)
};

__device__ __forceinline__ bool fits(const EvalArgs& a, int n, const long long* demand,
                                     const long long* rel, int cnt) {
  for (int r = 0; r < a.R; ++r) {
    const long long d = demand[r];
    const long long free_r = a.alloc[(long long)n * a.R + r] - (a.req[(long long)n * a.R + r] - rel[r]);
    if (d != 0 && d > free_r) return false;
  }
  return a.num_pods[n] - cnt + 1 <= a.allowed_pods[n];
}

__global__ void preempt_eval_kernel(EvalArgs a) {
  __shared__ int s_idx0;
  if (threadIdx.x == 0) s_idx0 = representative(a.pod);
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.N) return;
  const int i0 = s_idx0;
  const PodView& p = a.pod;
  const int R = a.R, V = a.V;

  bool base = a.node_valid[n] != 0;
  if (p.tol_unsched != nullptr) base = base && (!a.unsched[n] || p.tol_unsched[i0]);
  if (p.nodename_id != nullptr) {
    const int want = p.nodename_id[i0];
    base = base && (want == -1 || a.name_id[n] == want);
  }
  if (p.node_bits != nullptr) {
    base = base && ((p.node_bits[(long long)i0 * a.N + n] & p.bits_mask) == p.bits_mask);
  }

  long long demand[kMaxR];
  for (int r = 0; r < R; ++r) demand[r] = p.req[(long long)i0 * R + r];
  const int prio = p.priority[i0];
  const int* vp = a.vic_prio + (long long)n * V;
  const long long* vr = a.vic_req + (long long)n * V * R;

  // Phase 1: every lower-priority victim released.
  unsigned long long mask = 0;
  long long rel[kMaxR];
  for (int r = 0; r < R; ++r) rel[r] = 0;
  int cnt = 0;
  for (int v = 0; v < V; ++v) {
    if (vp[v] < prio) {
      mask |= 1ULL << v;
      ++cnt;
      for (int r = 0; r < R; ++r) rel[r] += vr[(long long)v * R + r];
    }
  }
  const bool feas_all = fits(a, n, demand, rel, cnt);

  // Phase 2: greedy reprieve, most important first = reverse slot order.
  if (feas_all) {
    long long t_rel[kMaxR];
    for (int s = V - 1; s >= 0; --s) {
      if (!((mask >> s) & 1ULL)) continue;
      for (int r = 0; r < R; ++r) t_rel[r] = rel[r] - vr[(long long)s * R + r];
      if (fits(a, n, demand, t_rel, cnt - 1)) {
        mask &= ~(1ULL << s);
        for (int r = 0; r < R; ++r) rel[r] = t_rel[r];
        --cnt;
      }
    }
  }
  const int nv = __popcll(mask);
  const bool poss = base && feas_all && nv >= 1 && mate_valid(p, i0);

  // Criteria over the final victim set.
  long long violations = 0;
  for (int q = 0; q < a.P; ++q) {
    long long c = 0;
    for (int v = 0; v < V; ++v) {
      if ((mask >> v) & 1ULL) c += a.vic_pdb[((long long)n * V + v) * a.P + q];
    }
    const long long over = c - a.pdb_allowed[q];
    violations += over > 0 ? over : 0;
  }
  int max_prio = -1;
  long long prio_sum = 0;
  long long nz0 = 0, nz1 = 0;
  for (int v = 0; v < V; ++v) {
    if ((mask >> v) & 1ULL) {
      max_prio = vp[v] > max_prio ? vp[v] : max_prio;
      prio_sum += vp[v];
      nz0 += a.vic_nonzero[((long long)n * V + v) * 2 + 0];
      nz1 += a.vic_nonzero[((long long)n * V + v) * 2 + 1];
    }
  }
  double min_start = INFINITY;
  for (int v = 0; v < V; ++v) {
    if (((mask >> v) & 1ULL) && vp[v] == max_prio) {
      const double st = a.vic_start[(long long)n * V + v];
      min_start = st < min_start ? st : min_start;
    }
  }
  const long long start_key = isfinite(min_start) ? (long long)(-min_start * 1e6) : kNoStart;

  a.possible[n] = poss;
  a.crit[0 * (long long)a.N + n] = violations;
  a.crit[1 * (long long)a.N + n] = max_prio;
  a.crit[2 * (long long)a.N + n] = prio_sum;
  a.crit[3 * (long long)a.N + n] = nv;
  a.crit[4 * (long long)a.N + n] = start_key;
  for (int v = 0; v < V; ++v) a.vic_mask[(long long)n * V + v] = (mask >> v) & 1ULL;
  a.n_vic[n] = nv;
  for (int r = 0; r < R; ++r) a.rel[(long long)n * R + r] = rel[r];
  a.relnz[(long long)n * 2 + 0] = nz0;
  a.relnz[(long long)n * 2 + 1] = nz1;
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
    if (chosen) vic_prio[(long long)row * V + v] = kI32Max;
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

PodView make_pod_view(const void* priority, const void* pod_req, const void* nodename_id,
                      const void* tol_unsched, const void* valid, const void* elig,
                      const void* spec_picks, const void* node_bits, int bits_mask, int C) {
  PodView p;
  p.priority = static_cast<const int*>(priority);
  p.req = static_cast<const long long*>(pod_req);
  p.nodename_id = static_cast<const int*>(nodename_id);
  p.tol_unsched = static_cast<const unsigned char*>(tol_unsched);
  p.valid = static_cast<const unsigned char*>(valid);
  p.elig = static_cast<const unsigned char*>(elig);
  p.spec_picks = static_cast<const int*>(spec_picks);
  p.node_bits = static_cast<const unsigned char*>(node_bits);
  p.bits_mask = bits_mask;
  p.C = C;
  return p;
}

}  // namespace

extern "C" int preempt_eval_launch(
    const void* node_valid, const void* name_id, const void* unsched, const void* num_pods,
    const void* allowed_pods, const void* alloc, const void* req, const void* vic_prio,
    const void* vic_req, const void* vic_nonzero, const void* vic_start, const void* vic_pdb,
    const void* pdb_allowed, const void* priority, const void* pod_req,
    const void* nodename_id, const void* tol_unsched, const void* valid, const void* elig,
    const void* spec_picks, const void* node_bits, int bits_mask, int C, int N, int V, int R,
    int P, void* possible, void* crit, void* vic_mask, void* n_vic, void* rel, void* relnz,
    void* stream) {
  if (R > kMaxR || V > kMaxV) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  EvalArgs a;
  a.node_valid = static_cast<const unsigned char*>(node_valid);
  a.name_id = static_cast<const int*>(name_id);
  a.unsched = static_cast<const unsigned char*>(unsched);
  a.num_pods = static_cast<const int*>(num_pods);
  a.allowed_pods = static_cast<const int*>(allowed_pods);
  a.alloc = static_cast<const long long*>(alloc);
  a.req = static_cast<const long long*>(req);
  a.vic_prio = static_cast<const int*>(vic_prio);
  a.vic_req = static_cast<const long long*>(vic_req);
  a.vic_nonzero = static_cast<const long long*>(vic_nonzero);
  a.vic_start = static_cast<const double*>(vic_start);
  a.vic_pdb = static_cast<const unsigned char*>(vic_pdb);
  a.pdb_allowed = static_cast<const long long*>(pdb_allowed);
  a.pod = make_pod_view(priority, pod_req, nodename_id, tol_unsched, valid, elig, spec_picks,
                        node_bits, bits_mask, C);
  a.N = N;
  a.V = V;
  a.R = R;
  a.P = P;
  a.possible = static_cast<unsigned char*>(possible);
  a.crit = static_cast<long long*>(crit);
  a.vic_mask = static_cast<unsigned char*>(vic_mask);
  a.n_vic = static_cast<int*>(n_vic);
  a.rel = static_cast<long long*>(rel);
  a.relnz = static_cast<long long*>(relnz);
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
  PodView p = make_pod_view(nullptr, nullptr, nullptr, nullptr, valid, elig, spec_picks,
                            nullptr, 0, C);
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
