// build_dom: the per-domain aggregate tables of the pass, from the state.
//
// Replaces kubernetes_tpu/engine/pass_.py:96-119 (_dom_aggregates, the
// products behind build_dom) and ops/helpers.py:25 (the topology one-hot
// they contract with):
//   group_dom[g, k, d] = sum over nodes n with topo_vals[n, k] == d of
//                        group_counts[g, n]
//   et_dom[e, d]       = sum over nodes n with topo_vals[n, et_slot[e]] == d
//                        of et_counts[e, n]
// for d in [0, DV); missing keys (-1) and hostname values (>= DV) match no
// column, as the one-hot's zero rows do.  The JAX pass contracts the counts
// with the (N, TK, DV) one-hot on the MXU; here each count is added to its
// domain's cell directly.
//
// One block per table row: G blocks for group_dom, then ET for et_dom.  A
// block walks its count row (coalesced), skips zero counts, and adds each
// non-zero count into a shared-memory table (TK x DV int32, or DV for a
// term row) at the node's domain; the table is then written as f32.
//
// Numerics: the JAX product sums integer counts in f32 at full precision,
// exact below 2^24; the int32 sums here are bit-identical to it.
//
// Bound: bytes.  It must read both count tables once (G x N and ET x N
// int32) and write both tables; it reads topo_vals only where a count is
// non-zero (an L2-resident N x TK row set).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void build_dom_kernel(const int* __restrict__ group_counts,  // (G, N)
                                 const int* __restrict__ et_counts,     // (ET, N)
                                 const int* __restrict__ topo_vals,     // (N, TK)
                                 const int* __restrict__ et_slot,       // (ET,)
                                 int G, int ET, int N, int TK, int DV,
                                 float* __restrict__ group_dom,  // (G, TK, DV)
                                 float* __restrict__ et_dom) {   // (ET, DV)
  extern __shared__ int tbl[];  // (TK, DV) for a group row, (DV,) for a term row
  const int row = blockIdx.x;
  const bool is_group = row < G;
  const int e = row - G;
  const int cells = is_group ? TK * DV : DV;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) tbl[i] = 0;
  __syncthreads();
  const int* counts = is_group ? group_counts + (size_t)row * N : et_counts + (size_t)e * N;
  const int slot = is_group ? 0 : et_slot[e];
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int cnt = counts[n];
    if (cnt == 0) continue;
    const int* tv = topo_vals + (size_t)n * TK;
    if (is_group) {
      for (int k = 0; k < TK; ++k) {
        const int v = tv[k];
        if (v >= 0 && v < DV) atomicAdd(tbl + k * DV + v, cnt);
      }
    } else if (slot >= 0 && slot < TK) {
      const int v = tv[slot];
      if (v >= 0 && v < DV) atomicAdd(tbl + v, cnt);
    }
  }
  __syncthreads();
  float* out = is_group ? group_dom + (size_t)row * TK * DV : et_dom + (size_t)e * DV;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) out[i] = (float)tbl[i];
}

}  // namespace

extern "C" int build_dom_launch(const void* group_counts, const void* et_counts,
                                const void* topo_vals, const void* et_slot, int G, int ET,
                                int N, int TK, int DV, void* group_dom, void* et_dom,
                                void* stream) {
  const int rows = G + ET;
  if (rows == 0) return 0;
  const int smem = TK * DV * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        build_dom_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  build_dom_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(group_counts), static_cast<const int*>(et_counts),
      static_cast<const int*>(topo_vals), static_cast<const int*>(et_slot), G, ET, N, TK, DV,
      static_cast<float*>(group_dom), static_cast<float*>(et_dom));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(build_dom)
