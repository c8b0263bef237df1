// pinned_fit: the same-row capacity rule of the pinned-batch pass.
//
// Replaces kubernetes_tpu/engine/pass_.py:1003-1032 (build_pinned_pass:
// the stable sort by pinned row, the segmented inclusive prefixes by cummax
// and cumsum, the fit against the row's free capacity before the batch,
// and the pick).  Pod i is feasible when it is valid, its pin names a live
// node (pin_row >= 0) and eval_chunk's own-node evaluation passed.  A
// feasible pod places on its pin when the requests of the feasible pods
// pinned to the same row up to and including itself, in batch order, fit
// the row's alloc - req in every column the pod requests, and their count
// fits allowed_pods - num_pods; otherwise it defers (-2) and retries next
// batch.  Picks: the row, -2, or -1 (infeasible or invalid).
//
// One thread per pod, looping over the pods before it: the prefix the JAX
// pass forms by sorting is the same sum taken in batch order over mates of
// the same row.  Bound: bytes (the batch's pins, flags and requests, one
// state row per pod); the K^2 / 2 mate comparisons are integer compares of
// data that stays in L1.
#include <stdint.h>

#include "common.cuh"

namespace {

struct PinnedArgs {
  const unsigned char* own_ok;  // (K,) eval_chunk's pinned feasibility
  const int* pin_row;           // (K,) -1: the pin names no live node
  const unsigned char* valid;   // (K,)
  const long long* pod_req;     // (K, R)
  const long long* alloc;       // (N, R)
  const long long* req;         // (N, R)
  const int* num_pods;          // (N,)
  const int* allowed_pods;      // (N,)
  int K, N, R;
  int* picks;     // (K,)
  int* feasible;  // (K,) 0/1
};

__device__ bool feasible_at(const PinnedArgs& a, int i) {
  return a.valid[i] && a.pin_row[i] >= 0 && a.own_ok[i];
}

__global__ void pinned_fit_kernel(PinnedArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.K) return;
  const bool feas = feasible_at(a, i);
  int pick = -1;
  if (feas) {
    const int row = a.pin_row[i];
    bool fits = true;
    for (int r = 0; r < a.R && fits; ++r) {
      const long long want = a.pod_req[(size_t)i * a.R + r];
      if (want == 0) continue;
      long long within = 0;
      for (int j = 0; j <= i; ++j) {
        if (a.pin_row[j] == row && feasible_at(a, j)) within += a.pod_req[(size_t)j * a.R + r];
      }
      fits = within <= a.alloc[(size_t)row * a.R + r] - a.req[(size_t)row * a.R + r];
    }
    int count = 0;
    for (int j = 0; j <= i; ++j) count += (a.pin_row[j] == row && feasible_at(a, j)) ? 1 : 0;
    fits = fits && a.num_pods[row] + count <= a.allowed_pods[row];
    pick = fits ? row : -2;
  }
  a.picks[i] = pick;
  a.feasible[i] = feas ? 1 : 0;
}

}  // namespace

extern "C" int pinned_fit_launch(
    const void* own_ok, const void* pin_row, const void* valid, const void* pod_req,
    const void* alloc, const void* req, const void* num_pods, const void* allowed_pods,
    int K, int N, int R, void* picks, void* feasible, void* stream) {
  if (K == 0) return 0;
  PinnedArgs a;
  a.own_ok = static_cast<const unsigned char*>(own_ok);
  a.pin_row = static_cast<const int*>(pin_row);
  a.valid = static_cast<const unsigned char*>(valid);
  a.pod_req = static_cast<const long long*>(pod_req);
  a.alloc = static_cast<const long long*>(alloc);
  a.req = static_cast<const long long*>(req);
  a.num_pods = static_cast<const int*>(num_pods);
  a.allowed_pods = static_cast<const int*>(allowed_pods);
  a.K = K;
  a.N = N;
  a.R = R;
  a.picks = static_cast<int*>(picks);
  a.feasible = static_cast<int*>(feasible);
  const int threads = 128;
  pinned_fit_kernel<<<(K + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

KERNEL_ERROR_STRING(pinned)
