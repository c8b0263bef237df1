// rows: the data moves of the device mirror, row sets and row broadcasts.
//
// scatter_rows replaces kubernetes_tpu/snapshot.py:796 (_scatter_rows, the
// dirty-row flush of host staging into the device ClusterState: one jitted
// program over every field) and kubernetes_tpu/preemption.py:137
// (_scatter_buf_rows, the dirty rows of the staged victim buffer).  One
// launch writes up to 32 fields, each a descriptor of a table passed by
// value as a __grid_constant__ kernel parameter: the destination viewed as
// (outer, n, inner) bytes (a field indexed by node on axis 0 has outer = 1
// and inner = its row's bytes; a field indexed by node on axis 1 has
// outer = its leading size and inner = its element size), its source
// holding the same layout with nrows in place of n, and the width a thread
// copies (8, 4, 2 or 1 bytes: the largest that divides inner and both
// bases).  Row i of every source goes to node row rows[i].  The flush packs
// the row index and every field's rows into one buffer (one host-to-device
// copy), so its sources and index point into it.  Block row blockIdx.y
// takes field blockIdx.y and walks its words grid-stride.
//
// expand_rows replaces kubernetes_tpu/scheduler.py:44 (_expand_uniform):
// row 0 of a (1, inner) source written to each of K destination rows.
//
// Both are pure copies.  Bound: bytes, the rows moved read once and written
// once; a flush of a few dirty rows is one launch's latency.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 32;
constexpr int kMaxBlocks = 1024;  // a field's blocks (grid-stride beyond)

// Mirrored by kernels/__init__.py _FieldDesc / _FieldTable (ctypes).
struct FieldDesc {
  unsigned long long dst;  // (outer, n, inner) bytes
  unsigned long long src;  // (outer, nrows, inner) bytes
  long long outer;
  long long n;
  int inner;  // bytes of one (outer, row) element
  int word;   // bytes a thread copies: 8, 4, 2 or 1
};

struct FieldTable {
  unsigned long long rows;  // (nrows,) i64
  long long nrows;
  int nfields;
  int pad;
  FieldDesc f[kMaxFields];
};

template <typename T>
__device__ void copy_field(const FieldDesc& d, const long long* __restrict__ rows, long long nrows) {
  T* __restrict__ dst = reinterpret_cast<T*>(d.dst);
  const T* __restrict__ src = reinterpret_cast<const T*>(d.src);
  const long long inner = d.inner / (int)sizeof(T);
  const long long total = d.outer * nrows * inner;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % inner;
    const long long i = (e / inner) % nrows;
    const long long o = e / (inner * nrows);
    dst[(o * d.n + rows[i]) * inner + b] = src[e];
  }
}

__global__ void __launch_bounds__(kThreads) scatter_rows_kernel(const __grid_constant__ FieldTable t) {
  const FieldDesc& d = t.f[blockIdx.y];
  const long long* rows = reinterpret_cast<const long long*>(t.rows);
  switch (d.word) {
    case 8: copy_field<unsigned long long>(d, rows, t.nrows); break;
    case 4: copy_field<unsigned int>(d, rows, t.nrows); break;
    case 2: copy_field<unsigned short>(d, rows, t.nrows); break;
    default: copy_field<unsigned char>(d, rows, t.nrows); break;
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

// One launch for every field of ``table`` (a host FieldTable, copied into
// the kernel's parameters).
extern "C" int scatter_rows_launch(const void* table, void* stream) {
  const FieldTable& t = *static_cast<const FieldTable*>(table);
  if (t.nfields < 1 || t.nfields > kMaxFields || t.nrows < 0) return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int i = 0; i < t.nfields; ++i) {
    const FieldDesc& d = t.f[i];
    if (d.word != 1 && d.word != 2 && d.word != 4 && d.word != 8) return (int)cudaErrorInvalidValue;
    if (d.inner < 0 || d.inner % d.word != 0 || d.outer < 0) return (int)cudaErrorInvalidValue;
    const long long words = d.outer * t.nrows * (d.inner / d.word);
    if (words > most) most = words;
  }
  if (most == 0) return 0;
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_rows_kernel<<<dim3((unsigned)blocks, t.nfields), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
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
