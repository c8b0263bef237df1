// Shared helpers of the batch-pass kernels (plain C interface, loaded with
// ctypes; see kubernetes_tpu_torch/kernels/build.py).
#pragma once

#include <cuda_runtime.h>

// Floor division of int64, as jnp's `//` computes it.  The reference's
// operands are non-negative wherever the result is used, where floor and
// C's truncation agree; flooring here keeps the kernel equal to the plain
// version (torch.div(..., rounding_mode="floor")) on every input.
__device__ __forceinline__ long long floordiv_i64(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// floordiv_i64 without the 64-bit divide routine, for b != 0: the f64
// quotient floored, then corrected by one step against the exact int64
// remainder.  Below 2^53 in magnitude both operands convert exactly, the
// quotient is below 2^53, and rounding it moves its floor by at most one
// (up), so one step is exact; a remainder a - q*b stays below 2^54.  An
// operand at or above 2^53 takes floordiv_i64.
__device__ __forceinline__ long long floordiv_f64(long long a, long long b) {
  constexpr long long kLim = 1LL << 53;
  if (a >= kLim || a <= -kLim || b >= kLim || b <= -kLim) return floordiv_i64(a, b);
  long long q = __double2ll_rd((double)a / (double)b);
  const long long r = a - q * b;
  if (b > 0 ? r < 0 : r > 0) {
    --q;
  } else if (b > 0 ? r >= b : r <= b) {
    ++q;
  }
  return q;
}

// DynamicResources' pin and missing-claim check for one pod at a node
// whose name id is ``name`` (ops/dynamicresources.py _dra_hard): no
// missing claim, and every pin of the PIN slots (-1 pad) names the node.
__device__ __forceinline__ bool dra_pins_ok(bool missing, const int* pins, int PIN, int name) {
  if (missing) return false;
  for (int p = 0; p < PIN; ++p) {
    if (pins[p] >= 0 && pins[p] != name) return false;
  }
  return true;
}

// DynamicResources' device demand for one pod's S claim slots at node n
// (ops/dynamicresources.py _dra_filter): per pool d, the devices of the
// slots whose claim no pod of the node reserves (count(id) <= 0) sum to
// ``need``; the pod fits where every pool's need is 0 or
// alloc(d) + need <= cap[d, n].  ``count`` and ``alloc`` read the live
// state or, in the preemption search, the state the masked victims leave.
template <typename Count, typename Alloc>
__device__ bool dra_demand_fits(const int* ids, const int* cls, const int* cnt, int S, int DC,
                                const int* cap, long long N, int n, Count count, Alloc alloc) {
  for (int s = 0; s < S; ++s) {
    const int d = cls[s];
    if (ids[s] < 0 || d < 0 || d >= DC) continue;
    long long need = 0;
    for (int s2 = 0; s2 < S; ++s2) {
      if (ids[s2] >= 0 && cls[s2] == d && count(ids[s2]) <= 0) need += cnt[s2];
    }
    if (need != 0 && alloc(d) + need > (long long)cap[d * N + n]) return false;
  }
  return true;
}

#define KERNEL_ERROR_STRING(prefix)                                  \
  extern "C" const char* prefix##_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));       \
  }
