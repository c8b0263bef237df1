// build_dom: the per-domain aggregate tables of the pass, from the state.
//
// Replaces kubernetes_tpu/engine/pass_.py:96-119 (_dom_aggregates, the
// products behind build_dom) and ops/helpers.py:25 (the topology one-hot
// they contract with):
//   group_dom[g, k, d] = sum over nodes n with topo_vals[n, k] == d of
//                        group_counts[g, n]
//   et_dom[e, d]       = sum over nodes n with topo_vals[n, et_slot[e]] == d
//                        of et_counts[e, n]
// for d in [0, DV); missing keys (-1) and values >= DV (hostname ids) match
// no column, as the one-hot's zero rows do, and hostname ids inside
// [0, DV) add as the one-hot does; an et_slot outside [0, TK) gives a zero
// row.  The JAX pass contracts the counts with the (N, TK, DV) one-hot on
// the MXU; here each non-zero count is added to its domain's cell.
//
// Numerics: the JAX product sums integer counts in f32 at full precision,
// exact below 2^24; the int32 sums here are bit-identical to it.
//
// Bound: bytes.  Both count tables (G x N and ET x N int32), topo_vals and
// et_slot read once, both tables written once.  At the chunk-1 paths' shape
// (G = ET = 8, N = 8192) that is 0.2 us on the H100, far below a launch:
// the kernel is latency-bound there, and bandwidth-bound only with many
// rows (G = ET = 2048).
//
// One launch a call, its geometry from the host (kernels.dom_split):
//   - The table rows are the G group rows (TK*DV cells) and then the ET term
//     rows (DV cells).  A CTA takes R consecutive rows and a slice of S node
//     rows; the K CTAs of a thread block cluster split the node axis (K = 1
//     is a plain launch).  Few rows: R = 1 and K up to 16, so the grid fills
//     the SMs; many rows: K = 1 and R rows a CTA, so that the grid is about
//     one wave of kWave CTAs an SM.
//   - The CTA walks its slice in steps of 4 * threads nodes, thread t taking
//     node group t (4 nodes).
//   - Counts: a row's 4 counts in one 16-byte load where every row and
//     topo_vals are aligned and N % 4 == 0 (an instantiation of its own),
//     else 4 scalar loads.  With R > 1 the rows go in passes of kPass, the
//     next pass's loads in flight while the current pass is added.
//   - The topology tile: with TK = 4 (the schema's, every path's shape) a
//     node's topology row is one 16-byte load.  A thread loads its 4 nodes'
//     rows once a step, at its first non-zero count, and keeps them in
//     registers for all R rows; a thread whose counts are all 0 loads none
//     (the paths' counts are sparse).  With another TK a value is read from
//     topo_vals when a count needs it.
//   - A thread skips its zero counts.  For each key it forms its 4 nodes'
//     columns k*DV + v (or -1), then adds each non-zero count to the CTA's
//     shared table with its own atomic.  On the H100 that beat both a
//     warp's __match_any_sync grouping and a warp's one add where all
//     lanes hit one cell.
//   - After one cluster barrier each CTA sums a disjoint 1/K share of the
//     cells over the K tables through distributed shared memory and writes
//     it as f32; no CTA leaves before its peers have read its table.
//     Integer sums: the result does not depend on the order and is exact.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kVec = 4;               // nodes of a group: one 16-byte load of counts
constexpr int kPass = 2;              // kernels.DOM_PASS: rows whose counts are loaded together (R > 1)
constexpr int kWave = 4;              // kernels.DOM_WAVE: CTAs an SM with R > 1 (their launch bound)
constexpr int kMaxThreads = 256;      // kernels.DOM_THREADS
constexpr int kMaxCluster = 16;       // kernels.CLUSTER_MAX
constexpr int kMaxSmem = 227 * 1024;  // kernels.DOM_SMEM_CAP: a block's shared memory on the H100

struct Args {
  const int* group_counts;  // (G, N)
  const int* et_counts;     // (ET, N)
  const int* topo_vals;     // (N, TK)
  const int* et_slot;       // (ET,)
  float* group_dom;         // (G, TK, DV)
  float* et_dom;            // (ET, DV)
  int G, ET, N, TK, DV;
  int R, K, S;
  int W;  // cells of a table row in shared memory: max(TK, 1) * DV
};

__device__ __forceinline__ int column(int v, int k, int DV) {
  return v >= 0 && v < DV ? k * DV + v : -1;
}

// Counts of a table row (from ``p``) at nodes n0 .. n0+3, 0 at and past
// the slice end n1: one 16-byte load with V (rows aligned and N % 4 == 0,
// so the 4 nodes are all inside the slice or all past it), else 4 scalar
// loads.  Branch-free, so the loads of a pass are all in flight together.
template <bool V>
__device__ __forceinline__ int4 load_counts(const int* p, int n0, int n1) {
  if (V) return n0 < n1 ? __ldg(reinterpret_cast<const int4*>(p + n0)) : make_int4(0, 0, 0, 0);
  int4 c;
  c.x = n0 < n1 ? __ldg(p + n0) : 0;
  c.y = n0 + 1 < n1 ? __ldg(p + n0 + 1) : 0;
  c.z = n0 + 2 < n1 ? __ldg(p + n0 + 2) : 0;
  c.w = n0 + 3 < n1 ? __ldg(p + n0 + 3) : 0;
  return c;
}

// The counts of table row ``row`` at nodes n0 .. n0+3, and the row's key:
// -2 for a group row (every key), its slot for a term row, -1 for a term
// row whose slot is outside [0, TK) (a zero row) and at or past r1 (no
// row, no loads).
template <bool V>
__device__ __forceinline__ int load_row(const Args& a, int4* c, int row, int r1, int n0, int n1) {
  const bool grp = row < a.G, on = row < r1;
  const int* p = grp ? a.group_counts + (size_t)row * a.N : a.et_counts + (size_t)(row - a.G) * a.N;
  *c = load_counts<V>(p, n0, on ? n1 : 0);
  const int s = on && !grp ? __ldg(a.et_slot + (row - a.G)) : -1;
  return !on ? -1 : grp ? -2 : (s >= 0 && s < a.TK ? s : -1);
}

// Adds the non-zero counts ``c`` of the thread's nodes n0 .. n0+3 to the
// CTA's table ``tbl``: a group row (key -2) at column k*DV + v of each key
// k, a term row at column v of its key, each node's value read from
// topo_vals as a count needs it.  Each key's 4 columns are read before its
// atomics.  Out of line: it runs only for a non-zero group of counts, and
// one copy keeps the kernel's code small.
__device__ __noinline__ void add_counts(const int* __restrict__ topo_vals, int TK, int DV, int n0, int n1, int4 c,
                                        int key, int* __restrict__ tbl) {
  const int k0 = key == -2 ? 0 : key, k1 = key == -2 ? TK : key + 1;
  const int off = key == -2 ? 0 : key * DV;
  const int cnt[kVec] = {c.x, c.y, c.z, c.w};
  for (int k = k0; k < k1; ++k) {
    int col[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      col[i] = cnt[i] != 0 && n0 + i < n1 ? column(__ldg(topo_vals + (size_t)(n0 + i) * TK + k), k, DV) : -1;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (col[i] >= 0) atomicAdd(tbl + col[i] - off, cnt[i]);
    }
  }
}

// add_counts with TK = 4: node i's topology row is one int4, held in
// registers for every row of the step.
__device__ __forceinline__ void add_counts4(int DV, int4 t0, int4 t1, int4 t2, int4 t3, int4 c, int key,
                                         int* __restrict__ tbl) {
  const int4 rows[kVec] = {t0, t1, t2, t3};
  const int k0 = key == -2 ? 0 : key, k1 = key == -2 ? 4 : key + 1;
  const int off = key == -2 ? 0 : key * DV;
  const int cnt[kVec] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < k0 || k >= k1) continue;
    int col[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int v = k == 0 ? rows[i].x : k == 1 ? rows[i].y : k == 2 ? rows[i].z : rows[i].w;
      col[i] = cnt[i] == 0 ? -1 : column(v, k, DV);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (col[i] >= 0) atomicAdd(tbl + col[i] - off, cnt[i]);
    }
  }
}

// The topology rows of nodes n0 .. n0+3 with TK = 4 (-1 at and past n1).
template <bool V>
__device__ __forceinline__ void load_rows4(const int* topo_vals, int n0, int n1, int4* t) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int* p = topo_vals + (size_t)(n0 + i) * 4;
    if (V) {
      t[i] = n0 < n1 ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(-1, -1, -1, -1);
    } else {
      const bool in = n0 + i < n1;
      t[i] = make_int4(in ? __ldg(p) : -1, in ? __ldg(p + 1) : -1, in ? __ldg(p + 2) : -1, in ? __ldg(p + 3) : -1);
    }
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The counts of rows rp .. rp+P-1 at the thread's nodes, and their keys.
template <bool V, int P>
__device__ __forceinline__ void load_pass(const Args& a, int4* c, int* key, int rp, int r1, int n0, int n1) {
#pragma unroll
  for (int j = 0; j < P; ++j) key[j] = load_row<V>(a, c + j, rp + j, r1, n0, n1);
}

// Adds a pass's non-zero counts to the rows' tables.  REG: the thread's 4
// topology rows ``t``, loaded here at its first non-zero count of the step
// (``have``) and kept for the rest of the step's rows.
template <bool V, int P, bool REG>
__device__ __forceinline__ void add_pass(const Args& a, const int4* c, const int* key, int4* t, bool& have, int rp,
                                         int r0, int n0, int n1, int* tbl) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < P; ++j) any |= key[j] != -1 && (c[j].x | c[j].y | c[j].z | c[j].w) != 0;
  if (!any) return;
  if (REG && !have) {
    load_rows4<V>(a.topo_vals, n0, n1, t);
    have = true;
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (key[j] != -1 && (c[j].x | c[j].y | c[j].z | c[j].w) != 0) {
      int* row_tbl = tbl + (rp + j - r0) * a.W;
      if (REG) {
        add_counts4(a.DV, t[0], t[1], t[2], t[3], c[j], key[j], row_tbl);
      } else {
        add_counts(a.topo_vals, a.TK, a.DV, n0, n1, c[j], key[j], row_tbl);
      }
    }
  }
}

// P: the rows whose counts a thread loads together, 1 with R = 1 and kPass
// with R > 1 (then at most 64 registers, so that kWave CTAs share an SM:
// the IPA shape's 512 CTAs in one wave).  REG (TK = 4): the thread's 4
// topology rows in registers.
template <bool V, int P, bool REG>
__global__ void __launch_bounds__(kMaxThreads, P == 1 ? 1 : kWave) build_dom_kernel(const Args a) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = a.K;
  const int rank = K > 1 ? (int)cluster.block_rank() : 0;
  const int r0 = (int)(blockIdx.x / K) * a.R;
  const int r1 = min(a.G + a.ET, r0 + a.R);
  const int W = a.W, T = blockDim.x;
  int* tbl = smem;  // (r1 - r0, W) partial tables
  const int s0 = min(a.N, rank * a.S), s1 = min(a.N, s0 + a.S);
  const int cells = (r1 - r0) * W;
  for (int i = threadIdx.x; i < cells; i += T) tbl[i] = 0;
  bool zeroed = false;
  for (int base = s0; base < s1; base += kVec * T) {
    const int n0 = base + kVec * (int)threadIdx.x;
    int4 t[kVec];  // REG: the topology rows of the thread's nodes, for every row of the step
    bool have = false;
    int4 cA[P], cB[P];
    int kA[P], kB[P];
    load_pass<V, P>(a, cA, kA, r0, r1, n0, s1);
    if (!zeroed) {  // the zeroed tables before the first add (once; uniform)
      __syncthreads();
      zeroed = true;
    }
    // Passes in pairs (A, B), each one's loads issued before the other's adds.
    for (int rp = r0; rp < r1; rp += 2 * P) {
      if (rp + P < r1) load_pass<V, P>(a, cB, kB, rp + P, r1, n0, s1);
      add_pass<V, P, REG>(a, cA, kA, t, have, rp, r0, n0, s1, tbl);
      if (rp + P >= r1) break;
      if (rp + 2 * P < r1) load_pass<V, P>(a, cA, kA, rp + 2 * P, r1, n0, s1);
      add_pass<V, P, REG>(a, cB, kB, t, have, rp + P, r0, n0, s1, tbl);
    }
  }
  if (K > 1) {  // every table done (with K = 1: a barrier of the block)
    cluster.sync();
  } else {
    __syncthreads();
  }
  // This CTA's share of the cells, summed over the cluster's K tables.
  const int share = (cells + K - 1) / K;
  const int lo = rank * share, hi = min(cells, lo + share);
  const int gcells = a.TK * a.DV;
  for (int i = lo + (int)threadIdx.x; i < hi; i += T) {
    const int row = r0 + i / W, c = i % W;
    const bool grp = row < a.G;
    if (c >= (grp ? gcells : a.DV)) continue;
    int acc = 0;
    if (K == 1) {
      acc = tbl[i];
    } else {
      int v[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) v[q] = q < K ? cluster.map_shared_rank(tbl, q)[i] : 0;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) acc += v[q];
    }
    float* out = grp ? a.group_dom + (size_t)row * gcells + c : a.et_dom + (size_t)(row - a.G) * a.DV + c;
    *out = (float)acc;
  }
  if (K > 1) {  // keep this CTA's table until every peer has read it
    cluster_arrive();
    cluster_wait();
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Sets the kernel's dynamic shared-memory limit and, for K > 8, the
// non-portable cluster size (each once an instantiation), then launches.
template <bool V, int P, bool REG>
int launch(const Args& a, int rows, int threads, int smem, void* stream) {
  static int smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  static bool nonportable = false;
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(build_dom_kernel<V, P, REG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (a.K > 8 && !nonportable) {
    const cudaError_t err =
        cudaFuncSetAttribute(build_dom_kernel<V, P, REG>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((rows + a.R - 1) / a.R) * a.K));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.K > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, build_dom_kernel<V, P, REG>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// R rows a CTA, K CTAs a cluster over slices of S node rows, ``threads`` a
// CTA (kernels.dom_split); refuses a geometry that does not cover the node
// axis or whose tables pass a block's shared memory.
extern "C" int build_dom_launch(const void* group_counts, const void* et_counts,
                                const void* topo_vals, const void* et_slot, int G, int ET,
                                int N, int TK, int DV, int R, int K, int S, int threads,
                                void* group_dom, void* et_dom, void* stream) {
  if (G < 0 || ET < 0 || N < 0 || TK < 0 || DV < 0 || R < 1 || K < 1 || K > kMaxCluster ||
      (K & (K - 1)) != 0 || S < 0 || S % kVec != 0 || (long long)K * S < N || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = G + ET;
  if (rows == 0) return 0;
  const int W = (TK > 0 ? TK : 1) * DV;
  const long long table = (long long)R * W * (long long)sizeof(int);
  if (table > kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a;
  a.group_counts = static_cast<const int*>(group_counts);
  a.et_counts = static_cast<const int*>(et_counts);
  a.topo_vals = static_cast<const int*>(topo_vals);
  a.et_slot = static_cast<const int*>(et_slot);
  a.group_dom = static_cast<float*>(group_dom);
  a.et_dom = static_cast<float*>(et_dom);
  a.G = G;
  a.ET = ET;
  a.N = N;
  a.TK = TK;
  a.DV = DV;
  a.R = R;
  a.K = K;
  a.S = S;
  a.W = W;
  // The columns' source (kernels.dom_columns): registers with TK = 4, else
  // topo_vals.
  const bool reg = TK == 4;
  const int smem = (int)table;
  // 16-byte loads where every row and the topology are aligned.
  const bool vec = aligned16(group_counts) && aligned16(et_counts) && aligned16(topo_vals) && N % kVec == 0;
  if (R > 1) {
    if (reg) {
      return vec ? launch<true, kPass, true>(a, rows, threads, smem, stream)
                 : launch<false, kPass, true>(a, rows, threads, smem, stream);
    }
    return vec ? launch<true, kPass, false>(a, rows, threads, smem, stream)
               : launch<false, kPass, false>(a, rows, threads, smem, stream);
  }
  if (reg) {
    return vec ? launch<true, 1, true>(a, rows, threads, smem, stream)
               : launch<false, 1, true>(a, rows, threads, smem, stream);
  }
  return vec ? launch<true, 1, false>(a, rows, threads, smem, stream)
             : launch<false, 1, false>(a, rows, threads, smem, stream);
}

KERNEL_ERROR_STRING(build_dom)
