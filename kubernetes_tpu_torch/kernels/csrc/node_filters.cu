// node_filters: the NodeAffinity, TaintToleration, VolumeBinding and
// VolumeZone filters of a batch's pods, once per batch: against every node
// (the tiled launch), or each pod on its own pinned row (the pinned
// launch).
//
// Replaces kubernetes_tpu/ops/nodeaffinity.py filter_fn (:285, with
// _eval_terms :162 and the profile's added affinity),
// kubernetes_tpu/ops/tainttoleration.py filter_fn (:52, with
// ops/helpers.py gather_mask :63) and kubernetes_tpu/ops/volumes.py
// _vb_filter (:146) and _vz_filter (:191) with _eval_grouped (:78), which
// the JAX pass evaluates inside every scan step, and the pinned pass's
// vmapped own-row evaluation of the first two
// (kubernetes_tpu/engine/pass_.py:941-993).  All four read only node state
// that no commit changes (labels, names, taints), so one launch per batch
// serves all of its chunks: the result is a (K, N) byte per (pod, node), or
// (K, 1) pinned, bit 0 the NodeAffinity filter, bit 1 TaintToleration's,
// bit 2 VolumeBinding's, bit 3 VolumeZone's (1 where the batch carries no
// features of that op).  eval_chunk reads the bits as those ops' filter
// results, and spread_eval's node-inclusion policies read bits 0 and 1.
//
// The volume programs are grouped: a pod's terms belong to AND-ed
// OR-groups (one per claim or bound PV), each group needs a valid matching
// term, a group without terms fails (the term axis is padded to at least
// the group count, group ids pad with -1), and the scalar vb_/vz_feasible
// false fails every node (node_program::grouped: each valid term evaluated
// once, its hit OR-ed into a mask of 64 groups a window).
//
// Tiled launch (kernels.nf_tile picks the shape from K and N): block b
// takes a tile of NT nodes (one thread each) and a group of P pods.  Each
// thread holds its node's label keys and pairs in registers (RegNode,
// loaded as int4 vectors; an instantiation a label slot count of 16 or
// 32, Schema.LS's first two sizes, as it starts at 16 and doubles; larger
// counts, and rows not 16-byte aligned, walk the row in global memory)
// and its taint ids as a mask; the block's first P threads write each
// pod's header to shared memory: its intolerable taints as a mask and
// which of its ops must be evaluated at all (a selector pair, required or
// added terms; a feasible volume program with groups), the block's one
// barrier.  Then each thread
// evaluates the P pods on its node, their programs read from global memory
// (the same address in every lane: cached broadcasts): a requirement
// compares its values with the slots in registers without a branch, a
// grouped program evaluates each valid term at most once, taints are one
// AND of masks.  Four pods' bytes of four adjacent nodes are transposed
// between lanes by shuffles, so a lane stores 4 bytes of one pod's row.
// The grid is one-dimensional (tile-major), so no batch size meets a grid
// limit.
//
// Pinned launch (pin non-null): one thread a pod, its node row and its
// programs read from global memory (no two pods share a row's reads); a
// pin outside [0, N) writes 0.
//
// Bound: bytes.  Tiled: it must write K x N bytes (33.5 MB at K=4096,
// N=8192) and read each evaluated pod's programs once, and of the nodes
// only what the valid terms' operators need: the pair slots (N x LS x 4)
// for In/NotIn or a selector pair, the key slots for Exists/DoesNotExist/
// Gt/Lt, one integer a node a Gt/Lt key, the name ids for the
// metadata.name operators, the taint slots (N x TS x 4) where a pod has
// an intolerable taint.  Pinned: K bytes written, and the same per pod on
// its own row (a pod pinned by matchFields alone reads 4 bytes of it).
#include <stdint.h>

#include "common.cuh"
#include "node_program.cuh"

namespace {

using node_program::Program;

struct NfArgs {
  // Node state.
  const int* label_key;        // (N, LS)
  const int* label_pair;       // (N, LS)
  const long long* label_int;  // (N, LS)
  const int* name_id;          // (N,)
  const int* taint_ids;        // (N, TS)
  const int* pin;              // (K,) pinned launch, else null
  // NodeAffinity features (null unless do_na).
  const int* sel;                      // (K, S) nodeSelector pair ids, -1 pad
  const unsigned char* has_req;        // (K,)
  const int* req_op;                   // (K, T, Q)
  const int* req_key;                  // (K, T, Q)
  const int* req_vals;                 // (K, T, Q, V)
  const long long* req_int;            // (K, T, Q)
  const unsigned char* req_valid;      // (K, T)
  const unsigned char* has_add;        // (K,)  (null unless do_add)
  const int* add_op;                   // (K, T2, Q2)
  const int* add_key;
  const int* add_vals;                 // (K, T2, Q2, V2)
  const long long* add_int;
  const unsigned char* add_valid;      // (K, T2)
  // TaintToleration features (null unless do_taint).
  const unsigned char* intol_hard;     // (K, TV)
  // VolumeBinding and VolumeZone grouped programs (null unless do_vb /
  // do_vz): op/key/int (K, T, Q), vals (K, T, Q, V), term_valid and group
  // (K, T), ngroups and feasible (K,).
  const int* vb_op;
  const int* vb_key;
  const int* vb_vals;
  const long long* vb_int;
  const unsigned char* vb_valid;
  const int* vb_group;
  const int* vb_ngroups;
  const unsigned char* vb_feasible;
  const int* vz_op;
  const int* vz_key;
  const int* vz_vals;
  const long long* vz_int;
  const unsigned char* vz_valid;
  const int* vz_group;
  const int* vz_ngroups;
  const unsigned char* vz_feasible;
  unsigned char* out;                  // (K, N), or (K, 1) pinned
  int N, LS, TS, K, S, T, Q, V, T2, Q2, V2, TV, Tb, Qb, Vb, Tz, Qz, Vz;
  int do_na, do_add, do_taint, do_vb, do_vz;
  int P, tiles;  // tiled launch: pods a block, tiles of the node axis
};

// Taint vocabularies up to this size are tested as 64-bit masks (the
// node's taint ids against the pod's intolerable ones).
constexpr int kTaintMask = 64;

// A pod's header bits (its node-independent answers): NodeAffinity must
// be evaluated (a selector pair, required or added terms); a volume
// program must be evaluated (feasible, with groups), or fails everywhere
// (not feasible).
constexpr unsigned int kNaEval = 1, kVbEval = 2, kVbFail = 4, kVzEval = 8, kVzFail = 16;

// A pod's header: its ops to evaluate, its intolerable taints as a mask.
struct Header {
  unsigned long long intol;
  unsigned int bits;
};

__device__ __forceinline__ Header pod_header(const NfArgs& a, int c) {
  Header h{0, 0};
  if (a.do_na) {
    const int* sel = a.sel + (size_t)c * a.S;
    bool eval = a.has_req[c] != 0 || (a.do_add && a.has_add[c] != 0);
    for (int s = 0; !eval && s < a.S; ++s) eval = sel[s] >= 0;
    h.bits |= eval ? kNaEval : 0u;
  }
  if (a.do_vb) h.bits |= a.vb_feasible[c] == 0 ? kVbFail : (min(a.vb_ngroups[c], a.Tb) > 0 ? kVbEval : 0u);
  if (a.do_vz) h.bits |= a.vz_feasible[c] == 0 ? kVzFail : (min(a.vz_ngroups[c], a.Tz) > 0 ? kVzEval : 0u);
  if (a.do_taint && a.TV <= kTaintMask) {
    const unsigned char* intol = a.intol_hard + (size_t)c * a.TV;
    for (int id = 0; id < a.TV; ++id) h.intol |= (unsigned long long)(intol[id] != 0) << id;
  }
  return h;
}

// How a pod's taint toleration is tested on a node: with a vocabulary of
// at most kTaintMask, the node's taint ids as a mask against the pod's;
// else the node's ids (its row of taint_ids) against the pod's bytes.
struct Taints {
  const int* ids;
  unsigned long long mask;
};

__device__ __forceinline__ Taints node_taints(const NfArgs& a, int n) {
  Taints tt{a.taint_ids + (size_t)n * a.TS, 0};
  if (a.do_taint && a.TV <= kTaintMask) {
    for (int s = 0; s < a.TS; ++s) {
      const int id = tt.ids[s];
      if (id >= 0 && id < a.TV) tt.mask |= 1ULL << id;
    }
  }
  return tt;
}

__device__ __forceinline__ Program program(const int* op, const int* key, const int* vals, const long long* num,
                                           int c, int T, int Q, int V) {
  const size_t tq = (size_t)c * T * Q;
  return Program{op + tq, key + tq, vals + tq * V, num + tq, T, Q, V};
}

// The four bits of pod c on one node, given the pod's header.
template <class Nd>
__device__ __forceinline__ unsigned int pod_bits(const NfArgs& a, int c, const Header& h, const Nd& nd,
                                                 const Taints& tt) {
  using namespace node_program;
  bool na = true;
  if (h.bits & kNaEval) {
    // nodeSelector: every (key, value) pair must be on the node.
    const int* sel = a.sel + (size_t)c * a.S;
    for (int s = 0; na && s < a.S; ++s) na = sel[s] < 0 || nd.has_pair(sel[s]);
    if (na && a.has_req[c]) {
      na = any_term(program(a.req_op, a.req_key, a.req_vals, a.req_int, c, a.T, a.Q, a.V),
                    a.req_valid + (size_t)c * a.T, nd);
    }
    if (na && a.do_add && a.has_add[c]) {
      na = any_term(program(a.add_op, a.add_key, a.add_vals, a.add_int, c, a.T2, a.Q2, a.V2),
                    a.add_valid + (size_t)c * a.T2, nd);
    }
  }
  bool tolerated = true;
  if (a.do_taint && a.TV <= kTaintMask) {
    tolerated = (tt.mask & h.intol) == 0;
  } else if (a.do_taint) {
    const unsigned char* intol = a.intol_hard + (size_t)c * a.TV;
    for (int s = 0; tolerated && s < a.TS; ++s) {
      const int id = tt.ids[s];
      tolerated = !(id >= 0 && id < a.TV && intol[id]);
    }
  }
  bool vb = (h.bits & kVbFail) == 0;
  if (h.bits & kVbEval) {
    vb = grouped(program(a.vb_op, a.vb_key, a.vb_vals, a.vb_int, c, a.Tb, a.Qb, a.Vb),
                 a.vb_valid + (size_t)c * a.Tb, a.vb_group + (size_t)c * a.Tb, a.vb_ngroups[c], nd);
  }
  bool vz = (h.bits & kVzFail) == 0;
  if (h.bits & kVzEval) {
    vz = grouped(program(a.vz_op, a.vz_key, a.vz_vals, a.vz_int, c, a.Tz, a.Qz, a.Vz),
                 a.vz_valid + (size_t)c * a.Tz, a.vz_group + (size_t)c * a.Tz, a.vz_ngroups[c], nd);
  }
  return (na ? 1u : 0u) | (tolerated ? 2u : 0u) | (vb ? 4u : 0u) | (vz ? 8u : 0u);
}

// This thread's node (row n) as the tile evaluates it: its slots in
// registers (kLS of them), or walked in global memory (kLS 0).
template <int kLS>
struct TileNode {
  using type = node_program::RegNode<kLS>;
  __device__ __forceinline__ static type make(const NfArgs& a, int n) {
    type nd;
    const size_t r = (size_t)n * kLS;
    nd.load(a.label_key + r, a.label_pair + r);
    nd.num_ = a.label_int + r;
    nd.name = a.name_id[n];
    return nd;
  }
};

template <>
struct TileNode<0> {
  using type = node_program::Node;
  __device__ __forceinline__ static type make(const NfArgs& a, int n) {
    const size_t r = (size_t)n * a.LS;
    return type{a.label_key + r, a.label_pair + r, a.label_int + r, a.name_id[n], a.LS};
  }
};

// One thread a node of a tile, P pods of a group; see the file comment.
template <int kLS>
__global__ void __launch_bounds__(256) node_tile_kernel(NfArgs a) {
  extern __shared__ Header s_head[];  // (P,)
  const int tile = blockIdx.x % a.tiles;
  const int c0 = (blockIdx.x / a.tiles) * a.P;
  const int n0 = tile * blockDim.x;
  const int pods = min(a.P, a.K - c0);
  const int t = threadIdx.x;
  const int n = n0 + t;
  const bool live = n < a.N;
  const bool labels = a.do_na || a.do_vb || a.do_vz;
  typename TileNode<kLS>::type nd{};
  if (live && labels) nd = TileNode<kLS>::make(a, n);
  const Taints tt = node_taints(a, live ? n : 0);
  if (t < pods) s_head[t] = pod_header(a, c0 + t);
  __syncthreads();

  const int lane = t & 31;
  const int q = lane & 3;       // the pod of four this lane stores
  const int src = lane & ~3;    // the first of the four nodes it stores
  const int nb = n0 + (t & ~31) + src;
  const bool words = (a.N & 3) == 0 && nb + 4 <= a.N;
  for (int p0 = 0; p0 < pods; p0 += 4) {
    unsigned int packed = 0;  // pods p0..p0+3 on this thread's node, a byte each
    if (live) {
      for (int j = 0; j < 4 && p0 + j < pods; ++j) {
        packed |= pod_bits(a, c0 + p0 + j, s_head[p0 + j], nd, tt) << (8 * j);
      }
    }
    // Lane src + i holds node nb + i: gather byte q of each.
    unsigned int w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned int from = __shfl_sync(0xffffffffu, packed, src + i);
      w |= ((from >> (8 * q)) & 0xffu) << (8 * i);
    }
    if (p0 + q >= pods) continue;
    unsigned char* row = a.out + (size_t)(c0 + p0 + q) * a.N;
    if (words) {
      *reinterpret_cast<unsigned int*>(row + nb) = w;
    } else {
      for (int i = 0; i < 4; ++i) {
        if (nb + i < a.N) row[nb + i] = (unsigned char)(w >> (8 * i));
      }
    }
  }
}

// One thread a pod, on its pinned row.
__global__ void node_pinned_kernel(NfArgs a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.K) return;
  const int n = a.pin[c];
  if (n < 0 || n >= a.N) {
    a.out[c] = 0;
    return;
  }
  const size_t r = (size_t)n * a.LS;
  const node_program::Node nd{a.label_key + r, a.label_pair + r, a.label_int + r, a.name_id[n], a.LS};
  a.out[c] = (unsigned char)pod_bits(a, c, pod_header(a, c), nd, node_taints(a, n));
}

}  // namespace

extern "C" int node_filters_launch(
    const void* label_key, const void* label_pair, const void* label_int, const void* name_id,
    const void* taint_ids, const void* sel, const void* has_req, const void* req_op,
    const void* req_key, const void* req_vals, const void* req_int, const void* req_valid,
    const void* has_add, const void* add_op, const void* add_key, const void* add_vals,
    const void* add_int, const void* add_valid, const void* intol_hard, const void* vb_op,
    const void* vb_key, const void* vb_vals, const void* vb_int, const void* vb_valid,
    const void* vb_group, const void* vb_ngroups, const void* vb_feasible, const void* vz_op,
    const void* vz_key, const void* vz_vals, const void* vz_int, const void* vz_valid,
    const void* vz_group, const void* vz_ngroups, const void* vz_feasible, const void* pin, void* out,
    int N, int LS, int TS, int K, int S, int T, int Q, int V, int T2, int Q2, int V2, int TV, int Tb,
    int Qb, int Vb, int Tz, int Qz, int Vz, int do_na, int do_add, int do_taint, int do_vb,
    int do_vz, int NT, int P, void* stream) {
  if (K == 0 || N == 0) return 0;
  NfArgs a{};
  a.label_key = static_cast<const int*>(label_key);
  a.label_pair = static_cast<const int*>(label_pair);
  a.label_int = static_cast<const long long*>(label_int);
  a.name_id = static_cast<const int*>(name_id);
  a.taint_ids = static_cast<const int*>(taint_ids);
  a.pin = static_cast<const int*>(pin);
  a.sel = static_cast<const int*>(sel);
  a.has_req = static_cast<const unsigned char*>(has_req);
  a.req_op = static_cast<const int*>(req_op);
  a.req_key = static_cast<const int*>(req_key);
  a.req_vals = static_cast<const int*>(req_vals);
  a.req_int = static_cast<const long long*>(req_int);
  a.req_valid = static_cast<const unsigned char*>(req_valid);
  a.has_add = static_cast<const unsigned char*>(has_add);
  a.add_op = static_cast<const int*>(add_op);
  a.add_key = static_cast<const int*>(add_key);
  a.add_vals = static_cast<const int*>(add_vals);
  a.add_int = static_cast<const long long*>(add_int);
  a.add_valid = static_cast<const unsigned char*>(add_valid);
  a.intol_hard = static_cast<const unsigned char*>(intol_hard);
  a.vb_op = static_cast<const int*>(vb_op);
  a.vb_key = static_cast<const int*>(vb_key);
  a.vb_vals = static_cast<const int*>(vb_vals);
  a.vb_int = static_cast<const long long*>(vb_int);
  a.vb_valid = static_cast<const unsigned char*>(vb_valid);
  a.vb_group = static_cast<const int*>(vb_group);
  a.vb_ngroups = static_cast<const int*>(vb_ngroups);
  a.vb_feasible = static_cast<const unsigned char*>(vb_feasible);
  a.vz_op = static_cast<const int*>(vz_op);
  a.vz_key = static_cast<const int*>(vz_key);
  a.vz_vals = static_cast<const int*>(vz_vals);
  a.vz_int = static_cast<const long long*>(vz_int);
  a.vz_valid = static_cast<const unsigned char*>(vz_valid);
  a.vz_group = static_cast<const int*>(vz_group);
  a.vz_ngroups = static_cast<const int*>(vz_ngroups);
  a.vz_feasible = static_cast<const unsigned char*>(vz_feasible);
  a.out = static_cast<unsigned char*>(out);
  a.N = N;
  a.LS = LS;
  a.TS = TS;
  a.K = K;
  a.S = S;
  a.T = T;
  a.Q = Q;
  a.V = V;
  a.T2 = T2;
  a.Q2 = Q2;
  a.V2 = V2;
  a.TV = TV;
  a.Tb = Tb;
  a.Qb = Qb;
  a.Vb = Vb;
  a.Tz = Tz;
  a.Qz = Qz;
  a.Vz = Vz;
  a.do_na = do_na;
  a.do_add = do_add;
  a.do_taint = do_taint;
  a.do_vb = do_vb;
  a.do_vz = do_vz;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.pin != nullptr) {
    node_pinned_kernel<<<(K + 127) / 128, 128, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (NT < 32 || NT > 256 || NT % 32 != 0 || P < 1 || P > NT) return (int)cudaErrorInvalidValue;
  a.P = P;
  a.tiles = (N + NT - 1) / NT;
  const long long blocks = (long long)a.tiles * ((K + P - 1) / P);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)blocks;
  const size_t smem = (size_t)P * sizeof(Header);
  // Label rows in registers where they are 16-byte aligned int4 runs.
  const bool vec = ((uintptr_t)label_key | (uintptr_t)label_pair) % 16 == 0;
  if (vec && LS == 16) {
    node_tile_kernel<16><<<grid, NT, smem, s>>>(a);
  } else if (vec && LS == 32) {
    node_tile_kernel<32><<<grid, NT, smem, s>>>(a);
  } else {
    node_tile_kernel<0><<<grid, NT, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(node_filters)
