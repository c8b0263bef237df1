// unpack_victims: the staged victim buffer to the dry-run's per-field arrays.
//
// Replaces kubernetes_tpu/preemption.py:94-134 (_unpack_victims).  The host
// packs every node's pods into one int64 buffer (N, vu, cols) per slot:
//   col 0            priority (int32 value)
//   cols 1..R        requests
//   cols R+1..R+2    non-zero cpu and memory requests
//   col R+3          start time, the bits of an f64
//   cols R+4..       ceil(P/64) words of PDB-match bits
//   col cols-1       pdb_allowed[n] on slot 0 of row n < P (the final column)
// The outputs pad the vu occupied slots up to the pass's victim axis v with
// the empty-slot sentinels: priority INT32_MAX, requests 0, start +inf, no
// PDB bit.
//
// One thread per (node, slot < v).  Bound: bytes, the buffer read once and
// the fields written once.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kI32Max = 2147483647;

__global__ void unpack_victims_kernel(const long long* __restrict__ buf, int N, int vu,
                                      int cols, int R, int P, int pdb_words, int v,
                                      int inline_allowed, int* prio, long long* req,
                                      long long* nonzero, double* start, unsigned char* pdb,
                                      long long* allowed) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)N * v) return;
  const int n = (int)(e / v);
  const int j = (int)(e % v);
  const bool occupied = j < vu;
  const long long* src = buf + ((long long)n * vu + (occupied ? j : 0)) * cols;
  prio[e] = occupied ? (int)src[0] : kI32Max;
  for (int r = 0; r < R; ++r) req[e * R + r] = occupied ? src[1 + r] : 0;
  nonzero[e * 2 + 0] = occupied ? src[1 + R] : 0;
  nonzero[e * 2 + 1] = occupied ? src[2 + R] : 0;
  start[e] = occupied ? __longlong_as_double(src[3 + R]) : INFINITY;
  for (int p = 0; p < P; ++p) {
    const long long word = occupied ? src[4 + R + p / 64] : 0;
    pdb[e * P + p] = (unsigned char)((word >> (p % 64)) & 1);
  }
  if (inline_allowed && j == 0 && n < P) {
    allowed[n] = buf[(long long)n * vu * cols + (cols - 1)];
  }
}

}  // namespace

extern "C" int unpack_victims_launch(const void* buf, int N, int vu, int cols, int R, int P,
                                     int pdb_words, int v, int inline_allowed, void* prio,
                                     void* req, void* nonzero, void* start, void* pdb,
                                     void* allowed, void* stream) {
  const long long total = (long long)N * v;
  if (total == 0) return 0;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  unpack_victims_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(buf), N, vu, cols, R, P, pdb_words, v, inline_allowed,
      static_cast<int*>(prio), static_cast<long long*>(req), static_cast<long long*>(nonzero),
      static_cast<double*>(start), static_cast<unsigned char*>(pdb),
      static_cast<long long*>(allowed));
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(victims)
