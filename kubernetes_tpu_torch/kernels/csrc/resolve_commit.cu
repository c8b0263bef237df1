// resolve_commit: chunk conflict resolution plus the commit of placed pods.
//
// Replaces kubernetes_tpu/engine/pass_.py:570-617 (the chunk step's
// interaction deferral and exact cumulative fit) and _commit_chunk
// (:166-210): req, nonzero_req, num_pods, group_counts and the carried
// group_dom table, and the pod's own (anti-)affinity terms: et_counts[e,
// row] += 1 and et_dom[e, d] += 1 where d is the node's value at term e's
// own topology slot (values outside [0, DV), such as hostname values, are
// dropped, as the JAX scatter drops them), the host-port branch
// (:195-201): port_counts at each of the pod's (proto, ip, port) triples
// and portkey_counts at its (proto, port) keys, and the device and CSI
// branches (:211-236): dev_counts and dev_rw_counts at the pod's device
// ids, and csivol_counts at its CSI volume ids with csi_used[driver] += 1
// where the volume's count before the chunk was 0, and the DRA branch
// (:237-260): dra_claim_counts[kid, row] += 1 at each claim's first slot,
// and dra_alloc[pool, row] += the slot's devices at every slot whose
// claim's count before the chunk was 0.  The port branch applies to strict
// commits too (the pinned pass's, pass_.py:1040).
//
// One block a chunk (C <= 1024), by one of two schemes (see the
// launcher): one thread a pod for strict commits and chunks of at most 32
// pods, the staged scheme below for larger chunks.  With chunk > 1:
//   (a) a valid pod behind an attempting chunk-mate that conflicts with it
//       (pairs[i, j], i < j) defers;
//   (b) the remaining attempting pods check exact cumulative fit at their
//       picked node: the chunk-prefix demand of same-node mates (i <= j)
//       against the chunk-start free capacity, per requested resource, and
//       the pod count against allowed pods; a pod that overflows defers;
//   (c) so does an attach-limited pod (vol_csi_lim) whose node an earlier
//       attempting limited mate also picked (:605-613): distinct volumes
//       still share one per-driver budget there.
// Every state read of (a)-(c) happens before the barrier that precedes the
// commit, so it sees the chunk-start state; so does each committing pod's
// read of its CSI volumes' and its claims' counts (one bit per slot), so
// two mates attaching different volumes of one driver on one node each add
// 1, and every slot of one claim sees the count before its first slot
// moved it.  Committed pods then scatter-add their deltas with atomics:
// duplicate rows accumulate, and the f32 group_dom and et_dom adds are
// exact because the counts stay below 2^24.  Picks come out as -2
// (deferred), -1 (invalid or unschedulable) or the row.  Strict mode
// (chunk 1 and the pinned pass's commit) skips (a)-(c).
//
// Bound: operations on a handful of bytes (C*R int64 prefix sums plus
// C*(R+2+2+TK+2A+2SD+2SC+2SP+2SK) atomics), so its time is latency: the
// levels of dependent loads and the barriers of one block.  The staged
// scheme keeps both few:
//   - one phase, before the first barrier, issues every read of the
//     chunk-start state and of the chunk: the picks, validity, groups and
//     limits; the picked rows' free pods; for (a), each (attempting row i,
//     32-column word) of pairs, whose bits are ORed into bit words in
//     shared memory; for (b), the requests and the picked rows' free
//     capacity of the first kRC resource columns; and for every pod with
//     a pick, which CSI volumes and claims find a count of 0 (two levels:
//     the id, then its count at the row);
//   - (b) and (c) are segmented sums in chunk order by warp 0, one 32-pod
//     slice after another: __match_any_sync finds a slice's same-row mates,
//     a hashed row table in shared memory (row -> id) carries each row's
//     demand, count and limited pods from slice to slice, so a pod adds its
//     row's earlier slices and its slice mates at or before it (more than
//     kRC columns take another staged pass each);
//   - the committing pods are compacted in chunk order with one ballot a
//     warp; the commit is spread over threads, one per (committing pod, field
//     slot), fields in the order req, nonzero_req, pod and group counts,
//     domain slots, own terms, devices, CSI volumes, ports, claims.  The
//     row's own fields (req, nonzero_req, num_pods) of the committing
//     mates of one 32-pod slice on one row are summed by the first of
//     them, from the mate masks (b) found, into one atomic each; every
//     other delta is its own atomic (a __match_any_sync over the commit's
//     addresses cost more than the contention it saved).
// The chunk-order prefix is exact because one block holds the whole chunk
// and warp 0 walks its slices in order; integer sums do not depend on the
// order of their terms.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxChunk = 1024;
constexpr int kMaxThreads = 1024;
constexpr int kRC = 4;  // resource columns staged for (b) a pass
// Pod flags.
constexpr unsigned char kValid = 1;
constexpr unsigned char kAtt = 2;     // attempting: valid, picked, not deferred by (a)
constexpr unsigned char kDefer = 4;   // deferred by (a)
constexpr unsigned char kOver = 8;    // deferred by (b) or (c)
constexpr unsigned char kLim = 16;    // attach-limited (vol_csi_lim)
// Types of a commit delta.
constexpr int kNone = 0;
constexpr int kI64 = 1;
constexpr int kI32 = 2;
constexpr int kF32 = 3;
constexpr int kKinds = 9;

struct CommitArgs {
  const int* picks;            // (C,)
  const unsigned char* valid;  // (C,)
  const unsigned char* pairs;  // (C, C): pairs[i*C + j] — i's commit affects j
  int strict;                  // chunk == 1: no deferral, no cumulative fit
  const long long* pod_req;      // (C, R)
  const long long* pod_nonzero;  // (C, 2)
  const int* group;              // (C,)
  const long long* alloc;        // (N, R)
  long long* req;                // (N, R)
  long long* nonzero_req;        // (N, 2)
  int* num_pods;                 // (N,)
  const int* allowed_pods;       // (N,)
  int* group_counts;             // (G, N)
  float* group_dom;              // (G, TK, DV)
  const int* topo_vals;          // (N, TK)
  const int* own;                // (C, A) own term ids, -1 pad; null: none
  int* et_counts;                // (ET, N)
  float* et_dom;                 // (ET, DV)
  const int* et_slot;            // (ET,)
  // Volume features and state (the features null when the chunk carries none).
  const int* dev_ids;            // (C, SD), -1 pad
  const unsigned char* dev_rw;   // (C, SD)
  int* dev_counts;               // (VD, N)
  int* dev_rw_counts;            // (VD, N)
  const int* csi_ids;            // (C, SC), -1 pad
  const int* csi_drv;            // (C, SC)
  int* csivol_counts;            // (CV, N)
  int* csi_used;                 // (DR, N)
  const unsigned char* csi_lim;  // (C,)
  // Host ports (null when the chunk carries none).
  const int* port_triples;       // (C, SP), -1 pad
  const int* port_keys;          // (C, SP)
  int* port_counts;              // (P, N)
  int* portkey_counts;           // (PK, N)
  // DRA claim slots (null when the chunk carries none) and the columns.
  const int* dra_ids;            // (C, SK), -1 pad
  const int* dra_cls;            // (C, SK)
  const int* dra_cnt;            // (C, SK)
  const unsigned char* dra_first;  // (C, SK)
  int* dra_claim_counts;         // (CLM, N)
  int* dra_alloc;                // (DC, N)
  int C, N, R, TK, DV, A, SD, SC, DR, SP, SK, DC;
  int* out_picks;  // (C,)
};

// The shared memory of a launch, carved from one dynamic buffer: per pod
// of the chunk, per row id (at most C), the row table (H slots) and per
// warp.
struct Smem {
  unsigned long long* fresh_csi;  // (C,) CSI slots whose volume count was 0
  unsigned long long* fresh_dra;  // (C,) claim slots whose claim count was 0
  long long* room;       // (C,) allowed_pods - num_pods at the pick
  long long* need;       // (C, kRC) the staged requests
  long long* free_cap;   // (C, kRC) the pick's alloc - req
  long long* acc;        // (C,) per row id: demand of the slices so far
  long long* xchg;       // (32,) warp 0's exchange slots
  int* pick;             // (C,)
  int* group;            // (C,)
  unsigned int* mates;   // (C,) same-row attempting lanes of the pod's slice
  unsigned int* sums;    // (C,) for the first committing mate: the committing mates it adds for
  int* id;               // (C,) the pick's row id
  int* commit;           // (C,) committing pods in chunk order
  int* cnt;              // (C,) per row id: attempting pods so far
  int* lim;              // (C,) per row id: attach-limited attempting pods so far
  unsigned int* defer;   // (ceil(C/32),) bit j: an earlier attempting mate conflicts with j
  int* key;              // (H,) hashed rows, -1 empty
  int* slot;             // (H,) the key's row id
  int* warp_commits;     // (32,) committing pods per warp
  int* count;            // [0] row ids, [1] committing pods
  unsigned char* flag;   // (C,)
  size_t bytes;
};

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at += (bytes + 15) / 16 * 16;
  return here;
}

// The carved pointers from ``base`` (0 on the host, for .bytes: the
// dynamic shared memory the launch needs).
__host__ __device__ inline Smem carve(uintptr_t base, int C, int H) {
  Smem s;
  size_t at = 0;
  const size_t c = (size_t)C;
  s.fresh_csi = reinterpret_cast<unsigned long long*>(base + take(at, 8 * c));
  s.fresh_dra = reinterpret_cast<unsigned long long*>(base + take(at, 8 * c));
  s.room = reinterpret_cast<long long*>(base + take(at, 8 * c));
  s.need = reinterpret_cast<long long*>(base + take(at, 8 * c * kRC));
  s.free_cap = reinterpret_cast<long long*>(base + take(at, 8 * c * kRC));
  s.acc = reinterpret_cast<long long*>(base + take(at, 8 * c));
  s.xchg = reinterpret_cast<long long*>(base + take(at, 8 * 32));
  s.pick = reinterpret_cast<int*>(base + take(at, 4 * c));
  s.group = reinterpret_cast<int*>(base + take(at, 4 * c));
  s.mates = reinterpret_cast<unsigned int*>(base + take(at, 4 * c));
  s.sums = reinterpret_cast<unsigned int*>(base + take(at, 4 * c));
  s.id = reinterpret_cast<int*>(base + take(at, 4 * c));
  s.commit = reinterpret_cast<int*>(base + take(at, 4 * c));
  s.cnt = reinterpret_cast<int*>(base + take(at, 4 * c));
  s.lim = reinterpret_cast<int*>(base + take(at, 4 * c));
  s.defer = reinterpret_cast<unsigned int*>(base + take(at, 4 * ((c + 31) / 32)));
  s.key = reinterpret_cast<int*>(base + take(at, 4 * (size_t)H));
  s.slot = reinterpret_cast<int*>(base + take(at, 4 * (size_t)H));
  s.warp_commits = reinterpret_cast<int*>(base + take(at, 4 * 32));
  s.count = reinterpret_cast<int*>(base + take(at, 8));
  s.flag = reinterpret_cast<unsigned char*>(base + take(at, c));
  s.bytes = at;
  return s;
}

// The row id of ``row``, inserting it on first sight (H is a power of two
// above the number of distinct rows, so probing ends).
__device__ int row_id(const Smem& s, int H, int row) {
  unsigned int h = ((unsigned int)row * 2654435761u) & (unsigned int)(H - 1);
  while (true) {
    const int k = atomicCAS(&s.key[h], -1, row);
    if (k == -1) {
      const int id = atomicAdd(&s.count[0], 1);
      s.slot[h] = id;
      return id;
    }
    if (k == row) return s.slot[h];
    h = (h + 1) & (unsigned int)(H - 1);
  }
}

// Lanes <= this one.
__device__ __forceinline__ unsigned int lanes_upto(int lane) {
  return lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
}

// The field slots a committing pod fills, per kind (see the header).
__host__ __device__ inline void kind_widths(int R, int TK, int A, int SD, int SC, int SP, int SK, bool own,
                                            bool dev, bool csi, bool ports, bool dra, int* w) {
  w[0] = R;
  w[1] = 2;
  w[2] = 1;
  w[3] = TK;
  w[4] = own ? A : 0;
  w[5] = dev ? SD : 0;
  w[6] = csi ? SC : 0;
  w[7] = ports ? SP : 0;
  w[8] = dra ? SK : 0;
}

// The row's own field r of the committing mates that pod j adds for
// (``sums``: lanes of its slice), R columns of req then 2 of nonzero_req.
__device__ long long mates_sum(const long long* x, int width, int r, int j, unsigned int sums) {
  long long sum = 0;
  const int j0 = j & ~31;
  for (unsigned int rest = sums; rest != 0; rest &= rest - 1) sum += x[(size_t)(j0 + __ffs(rest) - 1) * width + r];
  return sum;
}

// Commit item k: kind-major, then the field slot, then the m-th
// committing pod.
__device__ void commit_item(const CommitArgs& a, const Smem& s, const int* w, int M, int k) {
  int kind = 0, rem = k;
  while (rem >= M * w[kind]) {
    rem -= M * w[kind];
    ++kind;
  }
  const int sl = rem / M;
  const int j = s.commit[rem - sl * M];
  const int row = s.pick[j];
  const size_t N = (size_t)a.N;
  switch (kind) {
    case 0:
      if (s.sums[j] != 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(a.req + (size_t)row * a.R + sl),
                  static_cast<unsigned long long>(mates_sum(a.pod_req, a.R, sl, j, s.sums[j])));
      }
      break;
    case 1:
      if (s.sums[j] != 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(a.nonzero_req + (size_t)row * 2 + sl),
                  static_cast<unsigned long long>(mates_sum(a.pod_nonzero, 2, sl, j, s.sums[j])));
      }
      break;
    case 2:
      if (s.sums[j] != 0) atomicAdd(a.num_pods + row, __popc(s.sums[j]));
      atomicAdd(a.group_counts + (size_t)s.group[j] * N + row, 1);
      break;
    case 3: {
      const int d = a.topo_vals[(size_t)row * a.TK + sl];
      if (d >= 0 && d < a.DV) atomicAdd(a.group_dom + ((size_t)s.group[j] * a.TK + sl) * a.DV + d, 1.0f);
      break;
    }
    case 4: {
      const int e = a.own[(size_t)j * a.A + sl];
      if (e < 0) break;
      atomicAdd(a.et_counts + (size_t)e * N + row, 1);
      const int d = a.topo_vals[(size_t)row * a.TK + a.et_slot[e]];
      if (d >= 0 && d < a.DV) atomicAdd(a.et_dom + (size_t)e * a.DV + d, 1.0f);
      break;
    }
    case 5: {
      const int id = a.dev_ids[(size_t)j * a.SD + sl];
      if (id < 0) break;
      atomicAdd(a.dev_counts + (size_t)id * N + row, 1);
      if (a.dev_rw[(size_t)j * a.SD + sl]) atomicAdd(a.dev_rw_counts + (size_t)id * N + row, 1);
      break;
    }
    case 6: {
      const int id = a.csi_ids[(size_t)j * a.SC + sl];
      if (id < 0) break;
      atomicAdd(a.csivol_counts + (size_t)id * N + row, 1);
      const int d = a.csi_drv[(size_t)j * a.SC + sl];
      if (((s.fresh_csi[j] >> sl) & 1) && d >= 0 && d < a.DR) atomicAdd(a.csi_used + (size_t)d * N + row, 1);
      break;
    }
    case 7: {
      const int triple = a.port_triples[(size_t)j * a.SP + sl];
      if (triple < 0) break;
      atomicAdd(a.port_counts + (size_t)triple * N + row, 1);
      const int key = a.port_keys[(size_t)j * a.SP + sl];
      atomicAdd(a.portkey_counts + (size_t)(key < 0 ? 0 : key) * N + row, 1);
      break;
    }
    default: {
      const size_t o = (size_t)j * a.SK + sl;
      const int id = a.dra_ids[o];
      if (id < 0) break;
      if (a.dra_first[o]) atomicAdd(a.dra_claim_counts + (size_t)id * N + row, 1);
      const int d = a.dra_cls[o];
      if (((s.fresh_dra[j] >> sl) & 1) && d >= 0 && d < a.DC) atomicAdd(a.dra_alloc + (size_t)d * N + row, a.dra_cnt[o]);
      break;
    }
  }
}

// Stage the requests and the picked rows' free capacity of columns
// [r0, r0 + nr) for every attempting pod (the chunk-start state).
__device__ void stage_columns(const CommitArgs& a, const Smem& s, int r0, int nr, bool from_smem) {
  for (int k = threadIdx.x; k < a.C * nr; k += blockDim.x) {
    const int j = k / nr, q = k - j * nr;
    const int p = from_smem ? s.pick[j] : a.picks[j];
    const bool att = from_smem ? (s.flag[j] & kAtt) != 0 : (p >= 0 && a.valid[j] != 0);
    if (!att) continue;
    const size_t at = (size_t)p * a.R + r0 + q;
    s.need[(size_t)j * kRC + q] = a.pod_req[(size_t)j * a.R + r0 + q];
    s.free_cap[(size_t)j * kRC + q] = a.alloc[at] - a.req[at];
  }
}

// (b) and (c) for the pods of the chunk, by warp 0 in chunk order; the
// flags of the pods that overflow get kOver.  The row ids, the pod count
// and the attach-limit clash.
__device__ void row_ids_and_counts(const Smem& s, int C, int H) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < C; j0 += 32) {
    const int j = j0 + lane;
    const unsigned char f = j < C ? s.flag[j] : 0;
    const bool att = (f & kAtt) != 0;
    const int p = att ? s.pick[j] : -1 - lane;  // a lane that does not attempt matches no one
    const unsigned int mates = __match_any_sync(0xffffffffu, p);
    const int leader = __ffs(mates) - 1;
    int id = 0;
    if (att && lane == leader) id = row_id(s, H, p);
    id = __shfl_sync(0xffffffffu, id, leader);
    const unsigned int lim = mates & __ballot_sync(0xffffffffu, att && (f & kLim));
    const unsigned int upto = lanes_upto(lane);
    if (att) {
      s.id[j] = id;
      s.mates[j] = mates;
      bool ok = s.cnt[id] + __popc(mates & upto) <= s.room[j];
      // (c): an earlier attempting limited mate on the row, in an earlier
      // slice or in this one.
      if ((f & kLim) && (s.lim[id] > 0 || (lim & upto & ~(1u << lane)) != 0)) ok = false;
      if (!ok) s.flag[j] = f | kOver;
    }
    __syncwarp();
    if (att && lane == leader) {
      s.cnt[id] += __popc(mates);
      s.lim[id] += __popc(lim);
    }
    __syncwarp();
  }
}

// (b) for the nr staged columns: pod j's demand is its row's earlier
// slices (acc) plus its slice mates at or before it.
__device__ void cumulative_fit(const Smem& s, int C, int nr) {
  const int lane = threadIdx.x & 31;
  const int ids = s.count[0];
  for (int q = 0; q < nr; ++q) {
    for (int i = lane; i < ids; i += 32) s.acc[i] = 0;
    __syncwarp();
    for (int j0 = 0; j0 < C; j0 += 32) {
      const int j = j0 + lane;
      const bool att = j < C && (s.flag[j] & kAtt) != 0;
      const long long v = att ? s.need[(size_t)j * kRC + q] : 0;
      s.xchg[lane] = v;
      __syncwarp();
      unsigned int mates = 0;
      int id = 0;
      if (att) {
        mates = s.mates[j];
        id = s.id[j];
        long long cum = s.acc[id];
        for (unsigned int rest = mates & lanes_upto(lane); rest != 0; rest &= rest - 1) {
          cum += s.xchg[__ffs(rest) - 1];
        }
        if (!(v == 0 || cum <= s.free_cap[(size_t)j * kRC + q])) s.flag[j] |= kOver;
      }
      __syncwarp();
      if (att && lane == __ffs(mates) - 1) {
        long long sum = 0;
        for (unsigned int rest = mates; rest != 0; rest &= rest - 1) sum += s.xchg[__ffs(rest) - 1];
        s.acc[id] += sum;
      }
      __syncwarp();
    }
  }
}

// One thread a pod (the first design of this kernel), for the shapes
// where the staged kernel below measured slower on the H100: strict
// commits (chunk-1 steps, the pinned pass: no (a)-(c), so nothing to
// stage) and chunks of one warp, whose few mates leave the staging's
// barriers and extra load level nothing to save.  Each thread walks its
// earlier mates for (a)-(c), reads its fresh bits before the barrier, then
// adds its own fields with atomics.
__global__ void resolve_commit_pods_kernel(CommitArgs a) {
  __shared__ int s_pick[kMaxChunk];
  __shared__ unsigned char s_att[kMaxChunk];
  const int j = threadIdx.x;
  const bool in = j < a.C;
  const bool v = in && a.valid[j] != 0;
  const int p = in ? a.picks[j] : -1;
  const bool att0 = v && p >= 0;
  if (in) {
    s_att[j] = att0;
    s_pick[j] = p;
  }
  __syncthreads();
  bool defer = false;
  if (!a.strict && in) {
    // (a) Interaction deferral behind an attempting earlier conflicting mate.
    bool d = false;
    for (int i = 0; i < j; ++i) {
      if (a.pairs[(size_t)i * a.C + j] && s_att[i]) d = true;
    }
    defer = d && v;
  }
  const bool att1 = att0 && !defer;
  __syncthreads();
  if (in) s_att[j] = att1;
  __syncthreads();
  bool overflow = false;
  if (!a.strict && att1) {
    // (b) Exact cumulative fit at the picked node, in chunk order.
    const int row = p;
    const long long* preq_j = a.pod_req + (size_t)j * a.R;
    bool ok = true;
    for (int r = 0; r < a.R; ++r) {
      long long cum = 0;
      for (int i = 0; i <= j; ++i) {
        if (s_att[i] && s_pick[i] == row) cum += a.pod_req[(size_t)i * a.R + r];
      }
      const long long free_r = a.alloc[(size_t)row * a.R + r] - a.req[(size_t)row * a.R + r];
      if (!(preq_j[r] == 0 || cum <= free_r)) ok = false;
    }
    int cnt = 0;
    for (int i = 0; i <= j; ++i) {
      if (s_att[i] && s_pick[i] == row) ++cnt;
    }
    ok = ok && (a.num_pods[row] + cnt <= a.allowed_pods[row]);
    if (a.csi_lim != nullptr && a.csi_lim[j]) {
      for (int i = 0; i < j; ++i) {
        if (s_att[i] && s_pick[i] == row && a.csi_lim[i]) ok = false;
      }
    }
    overflow = !ok;
  }
  defer = defer || overflow;
  const bool att2 = att1 && !overflow;
  // Which CSI volumes this pod newly attaches: counts before the chunk.
  unsigned long long fresh = 0;
  for (int s = 0; att2 && a.csi_ids != nullptr && s < a.SC; ++s) {
    const int id = a.csi_ids[(size_t)j * a.SC + s];
    if (id >= 0 && a.csivol_counts[(size_t)id * a.N + p] == 0) fresh |= 1ull << s;
  }
  // Which claim slots charge their pool: the claim's count before the chunk.
  unsigned long long dra_fresh = 0;
  for (int s = 0; att2 && a.dra_ids != nullptr && s < a.SK; ++s) {
    const int id = a.dra_ids[(size_t)j * a.SK + s];
    if (id >= 0 && a.dra_claim_counts[(size_t)id * a.N + p] == 0) dra_fresh |= 1ull << s;
  }
  __syncthreads();  // every read of the chunk-start state is done
  if (att2) {
    const int row = p;
    for (int r = 0; r < a.R; ++r) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.req + (size_t)row * a.R + r),
                static_cast<unsigned long long>(a.pod_req[(size_t)j * a.R + r]));
    }
    for (int r = 0; r < 2; ++r) {
      atomicAdd(reinterpret_cast<unsigned long long*>(a.nonzero_req + (size_t)row * 2 + r),
                static_cast<unsigned long long>(a.pod_nonzero[(size_t)j * 2 + r]));
    }
    atomicAdd(a.num_pods + row, 1);
    const int g = a.group[j];
    atomicAdd(a.group_counts + (size_t)g * a.N + row, 1);
    for (int k = 0; k < a.TK; ++k) {
      const int d = a.topo_vals[(size_t)row * a.TK + k];
      if (d >= 0 && d < a.DV) {
        atomicAdd(a.group_dom + ((size_t)g * a.TK + k) * a.DV + d, 1.0f);
      }
    }
    for (int q = 0; a.own != nullptr && q < a.A; ++q) {
      const int e = a.own[(size_t)j * a.A + q];
      if (e < 0) continue;
      atomicAdd(a.et_counts + (size_t)e * a.N + row, 1);
      const int d = a.topo_vals[(size_t)row * a.TK + a.et_slot[e]];
      if (d >= 0 && d < a.DV) atomicAdd(a.et_dom + (size_t)e * a.DV + d, 1.0f);
    }
    for (int s = 0; a.dev_ids != nullptr && s < a.SD; ++s) {
      const int id = a.dev_ids[(size_t)j * a.SD + s];
      if (id < 0) continue;
      atomicAdd(a.dev_counts + (size_t)id * a.N + row, 1);
      if (a.dev_rw[(size_t)j * a.SD + s]) atomicAdd(a.dev_rw_counts + (size_t)id * a.N + row, 1);
    }
    for (int s = 0; a.csi_ids != nullptr && s < a.SC; ++s) {
      const int id = a.csi_ids[(size_t)j * a.SC + s];
      if (id < 0) continue;
      atomicAdd(a.csivol_counts + (size_t)id * a.N + row, 1);
      const int d = a.csi_drv[(size_t)j * a.SC + s];
      if (((fresh >> s) & 1) && d >= 0 && d < a.DR) atomicAdd(a.csi_used + (size_t)d * a.N + row, 1);
    }
    for (int s = 0; a.port_triples != nullptr && s < a.SP; ++s) {
      const int triple = a.port_triples[(size_t)j * a.SP + s];
      if (triple < 0) continue;
      atomicAdd(a.port_counts + (size_t)triple * a.N + row, 1);
      const int key = a.port_keys[(size_t)j * a.SP + s];
      atomicAdd(a.portkey_counts + (size_t)(key < 0 ? 0 : key) * a.N + row, 1);
    }
    for (int s = 0; a.dra_ids != nullptr && s < a.SK; ++s) {
      const size_t o = (size_t)j * a.SK + s;
      const int id = a.dra_ids[o];
      if (id < 0) continue;
      if (a.dra_first[o]) atomicAdd(a.dra_claim_counts + (size_t)id * a.N + row, 1);
      const int d = a.dra_cls[o];
      if (((dra_fresh >> s) & 1) && d >= 0 && d < a.DC) atomicAdd(a.dra_alloc + (size_t)d * a.N + row, a.dra_cnt[o]);
    }
  }
  if (in) a.out_picks[j] = defer ? -2 : (v ? p : -1);
}


__global__ void __launch_bounds__(kMaxThreads) resolve_commit_kernel(CommitArgs a, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = a.C, words = (C + 31) / 32;
  const Smem s = carve(reinterpret_cast<uintptr_t>(smem), C, H);
  // The words that the first phase ORs into start at 0.
  for (int j = tid; j < C; j += T) {
    s.fresh_csi[j] = 0;
    s.fresh_dra[j] = 0;
  }
  for (int w = tid; w < words; w += T) s.defer[w] = 0;
  __syncthreads();
  // First phase: every read of the chunk and of the chunk-start state.
  for (int j = tid; j < C; j += T) {
    const bool v = a.valid[j] != 0;
    const int p = a.picks[j];
    const bool att = v && p >= 0;
    s.pick[j] = p;
    s.group[j] = a.group[j];
    s.flag[j] = (v ? kValid : 0) | (att ? kAtt : 0) | (a.csi_lim != nullptr && a.csi_lim[j] ? kLim : 0);
    s.sums[j] = 0;
    s.room[j] = att ? (long long)a.allowed_pods[p] - a.num_pods[p] : 0;
    s.cnt[j] = 0;
    s.lim[j] = 0;
  }
  for (int h = tid; h < H; h += T) s.key[h] = -1;
  if (tid == 0) s.count[0] = 0;
  // (a) Attempting pod i marks each later mate its commit affects: one
  // thread a (row i, 32-column word) of pairs.
  for (int k = tid; k < C * words; k += T) {
    const int i = k / words, w = k - i * words;
    const int j0 = w * 32;
    if (j0 + 31 <= i) continue;  // only mates after i
    const unsigned char* row = a.pairs + (size_t)i * C;
    unsigned int bits = 0;
#pragma unroll 8
    for (int b = 0; b < 32; ++b) {
      const int j = j0 + b;
      if (j > i && j < C && row[j]) bits |= 1u << b;
    }
    if (bits != 0 && a.valid[i] && a.picks[i] >= 0) atomicOr(&s.defer[w], bits);
  }
  stage_columns(a, s, 0, min(kRC, a.R), false);
  // Which CSI volumes and claims of each picked pod find a count of 0
  // before the chunk (read here, before any write).
  for (int k = tid; a.csi_ids != nullptr && k < C * a.SC; k += T) {
    const int j = k / a.SC, sl = k - j * a.SC;
    const int p = a.picks[j];
    const int id = a.csi_ids[k];
    if (p >= 0 && id >= 0 && a.csivol_counts[(size_t)id * a.N + p] == 0) atomicOr(&s.fresh_csi[j], 1ull << sl);
  }
  for (int k = tid; a.dra_ids != nullptr && k < C * a.SK; k += T) {
    const int j = k / a.SK, sl = k - j * a.SK;
    const int p = a.picks[j];
    const int id = a.dra_ids[k];
    if (p >= 0 && id >= 0 && a.dra_claim_counts[(size_t)id * a.N + p] == 0) atomicOr(&s.fresh_dra[j], 1ull << sl);
  }
  __syncthreads();
  if (warp == 0) {
    // (a)'s verdicts: a valid pod behind a conflicting attempting mate.
    for (int j = lane; j < C; j += 32) {
      if ((s.flag[j] & kValid) && ((s.defer[j >> 5] >> (j & 31)) & 1)) {
        s.flag[j] = (s.flag[j] & ~kAtt) | kDefer;
      }
    }
    __syncwarp();
    row_ids_and_counts(s, C, H);
    cumulative_fit(s, C, min(kRC, a.R));
  }
  // (b) for the columns past the first kRC, a staged pass each.
  for (int r0 = kRC; r0 < a.R; r0 += kRC) {
    const int nr = min(kRC, a.R - r0);
    __syncthreads();
    stage_columns(a, s, r0, nr, true);
    __syncthreads();
    if (warp == 0) cumulative_fit(s, C, nr);
  }
  __syncthreads();
  // The committing pods, in chunk order: one ballot a warp, then each
  // warp's offset (T >= C: one pod a thread); the first committing mate
  // of each row in a slice adds for the slice's committing mates.
  const bool go = tid < C && (s.flag[tid] & (kAtt | kOver)) == kAtt;
  const unsigned int ballot = __ballot_sync(0xffffffffu, go);
  if (lane == 0) s.warp_commits[warp] = __popc(ballot);
  if (go) {
    const unsigned int mates = s.mates[tid] & ballot;
    if (lane == __ffs(mates) - 1) s.sums[tid] = mates;
  }
  __syncthreads();
  int before = 0, M = 0;
  for (int w = 0; w < T / 32; ++w) {
    const int n = s.warp_commits[w];
    before += w < warp ? n : 0;
    M += n;
  }
  if (go) s.commit[before + __popc(ballot & (lanes_upto(lane) >> 1))] = tid;
  __syncthreads();  // every read of the chunk-start state is done
  int w[kKinds];
  kind_widths(a.R, a.TK, a.A, a.SD, a.SC, a.SP, a.SK, a.own != nullptr, a.dev_ids != nullptr,
              a.csi_ids != nullptr, a.port_triples != nullptr, a.dra_ids != nullptr, w);
  int per = 0;
  for (int k = 0; k < kKinds; ++k) per += w[k];
  const int items = M * per;
  for (int k = tid; k < items; k += T) commit_item(a, s, w, M, k);
  for (int j = tid; j < C; j += T) {
    const unsigned char f = s.flag[j];
    a.out_picks[j] = (f & (kDefer | kOver)) ? -2 : ((f & kValid) ? s.pick[j] : -1);
  }
}

}  // namespace

extern "C" int resolve_commit_launch(
    const void* picks, const void* valid, const void* pairs, int strict,
    const void* pod_req, const void* pod_nonzero, const void* group,
    const void* alloc, void* req, void* nonzero_req, void* num_pods,
    const void* allowed_pods, void* group_counts, void* group_dom,
    const void* topo_vals, const void* own, void* et_counts, void* et_dom,
    const void* et_slot, const void* dev_ids, const void* dev_rw, void* dev_counts,
    void* dev_rw_counts, const void* csi_ids, const void* csi_drv, void* csivol_counts,
    void* csi_used, const void* csi_lim, const void* port_triples, const void* port_keys,
    void* port_counts, void* portkey_counts, const void* dra_ids, const void* dra_cls,
    const void* dra_cnt, const void* dra_first, void* dra_claim_counts, void* dra_alloc, int C, int N,
    int R, int TK, int DV, int A, int SD, int SC, int DR, int SP, int SK, int DC, void* out_picks,
    void* stream) {
  if (C > kMaxChunk || C < 1 || SC > 64 || SK > 64) return (int)cudaErrorInvalidValue;
  CommitArgs a;
  a.picks = static_cast<const int*>(picks);
  a.valid = static_cast<const unsigned char*>(valid);
  a.pairs = static_cast<const unsigned char*>(pairs);
  a.strict = strict;
  a.pod_req = static_cast<const long long*>(pod_req);
  a.pod_nonzero = static_cast<const long long*>(pod_nonzero);
  a.group = static_cast<const int*>(group);
  a.alloc = static_cast<const long long*>(alloc);
  a.req = static_cast<long long*>(req);
  a.nonzero_req = static_cast<long long*>(nonzero_req);
  a.num_pods = static_cast<int*>(num_pods);
  a.allowed_pods = static_cast<const int*>(allowed_pods);
  a.group_counts = static_cast<int*>(group_counts);
  a.group_dom = static_cast<float*>(group_dom);
  a.topo_vals = static_cast<const int*>(topo_vals);
  a.own = static_cast<const int*>(own);
  a.et_counts = static_cast<int*>(et_counts);
  a.et_dom = static_cast<float*>(et_dom);
  a.et_slot = static_cast<const int*>(et_slot);
  a.dev_ids = static_cast<const int*>(dev_ids);
  a.dev_rw = static_cast<const unsigned char*>(dev_rw);
  a.dev_counts = static_cast<int*>(dev_counts);
  a.dev_rw_counts = static_cast<int*>(dev_rw_counts);
  a.csi_ids = static_cast<const int*>(csi_ids);
  a.csi_drv = static_cast<const int*>(csi_drv);
  a.csivol_counts = static_cast<int*>(csivol_counts);
  a.csi_used = static_cast<int*>(csi_used);
  a.csi_lim = static_cast<const unsigned char*>(csi_lim);
  a.port_triples = static_cast<const int*>(port_triples);
  a.port_keys = static_cast<const int*>(port_keys);
  a.port_counts = static_cast<int*>(port_counts);
  a.portkey_counts = static_cast<int*>(portkey_counts);
  a.dra_ids = static_cast<const int*>(dra_ids);
  a.dra_cls = static_cast<const int*>(dra_cls);
  a.dra_cnt = static_cast<const int*>(dra_cnt);
  a.dra_first = static_cast<const unsigned char*>(dra_first);
  a.dra_claim_counts = static_cast<int*>(dra_claim_counts);
  a.dra_alloc = static_cast<int*>(dra_alloc);
  a.SK = SK;
  a.DC = DC;
  a.SP = SP;
  a.SD = SD;
  a.SC = SC;
  a.DR = DR;
  a.A = A;
  a.C = C;
  a.N = N;
  a.R = R;
  a.TK = TK;
  a.DV = DV;
  a.out_picks = static_cast<int*>(out_picks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strict || C <= 32) {
    resolve_commit_pods_kernel<<<1, (C + 31) / 32 * 32, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  // Threads: one a commit item of every pod (the most the chunk can
  // commit), in whole warps, 64 to 1024 (at least one a pod).
  int w[kKinds];
  kind_widths(R, TK, A, SD, SC, SP, SK, own != nullptr, dev_ids != nullptr, csi_ids != nullptr,
              port_triples != nullptr, dra_ids != nullptr, w);
  long long per = 0;
  for (int k = 0; k < kKinds; ++k) per += w[k];
  const long long want = (C * per + 31) / 32 * 32;
  const int threads = (int)(want < 64 ? 64 : (want > kMaxThreads ? kMaxThreads : want));
  int H = 2;  // row table: a power of two, at least twice the chunk
  while (H < 2 * C) H *= 2;
  const size_t bytes = carve(0, C, H).bytes;
  if (bytes > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(resolve_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
    if (rc != 0) return rc;
  }
  resolve_commit_kernel<<<1, threads, bytes, st>>>(a, H);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(resolve_commit)
