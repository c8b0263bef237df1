// rows: the data moves of the device mirror, row sets and row broadcasts.
//
// scatter_rows replaces kubernetes_tpu/snapshot.py:796 (_scatter_rows, the
// dirty-row flush of host staging into the device ClusterState) and
// kubernetes_tpu/preemption.py:137 (_scatter_buf_rows, the dirty rows of
// the staged victim buffer).  A destination is viewed as (outer, N, inner)
// bytes: a field indexed by node on axis 0 has outer = 1 and inner = its
// row's bytes; a field indexed by node on axis 1 has outer = its leading
// size and inner = its element size.  The source holds the same layout
// with nrows in place of N, and row i goes to node row rows[i].
//
// expand_rows replaces kubernetes_tpu/scheduler.py:44 (_expand_uniform):
// row 0 of a (1, inner) source written to each of K destination rows.
//
// Both are pure copies, one thread per 8-byte word where the row's bytes
// allow it and per byte otherwise.  Bound: bytes, the rows moved read once
// and written once; a flush of a few dirty rows is launch latency.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void scatter_rows_kernel(T* __restrict__ dst, const T* __restrict__ src,
                                    const long long* __restrict__ rows, long long nrows,
                                    long long outer, long long n, long long inner) {
  const long long total = outer * nrows * inner;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % inner;
    const long long i = (e / inner) % nrows;
    const long long o = e / (inner * nrows);
    dst[(o * n + rows[i]) * inner + b] = src[e];
  }
}

template <typename T>
__global__ void expand_rows_kernel(T* __restrict__ dst, const T* __restrict__ src, long long k,
                                   long long inner) {
  const long long total = k * inner;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    dst[e] = src[e % inner];
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  return (int)blocks;
}

}  // namespace

// dst viewed as (outer, n, inner_bytes), src as (outer, nrows, inner_bytes).
extern "C" int scatter_rows_launch(void* dst, const void* src, const void* rows,
                                   long long nrows, long long outer, long long n,
                                   long long inner_bytes, void* stream) {
  if (nrows == 0 || outer == 0 || inner_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* r = static_cast<const long long*>(rows);
  if (inner_bytes % 8 == 0) {
    const long long inner = inner_bytes / 8;
    scatter_rows_kernel<unsigned long long><<<grid_for(outer * nrows * inner), kThreads, 0, s>>>(
        static_cast<unsigned long long*>(dst), static_cast<const unsigned long long*>(src), r,
        nrows, outer, n, inner);
  } else {
    scatter_rows_kernel<unsigned char><<<grid_for(outer * nrows * inner_bytes), kThreads, 0, s>>>(
        static_cast<unsigned char*>(dst), static_cast<const unsigned char*>(src), r, nrows,
        outer, n, inner_bytes);
  }
  return (int)cudaGetLastError();
}

// dst (k, inner_bytes) ← src (1, inner_bytes) on every row.
extern "C" int expand_rows_launch(void* dst, const void* src, long long k,
                                  long long inner_bytes, void* stream) {
  if (k == 0 || inner_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inner_bytes % 8 == 0) {
    const long long inner = inner_bytes / 8;
    expand_rows_kernel<unsigned long long><<<grid_for(k * inner), kThreads, 0, s>>>(
        static_cast<unsigned long long*>(dst), static_cast<const unsigned long long*>(src), k,
        inner);
  } else {
    expand_rows_kernel<unsigned char><<<grid_for(k * inner_bytes), kThreads, 0, s>>>(
        static_cast<unsigned char*>(dst), static_cast<const unsigned char*>(src), k,
        inner_bytes);
  }
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(rows)
