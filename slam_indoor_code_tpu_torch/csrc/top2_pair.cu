// Fused squared-L2 distance + per-row top-2 of one query set against one
// candidate set — the CUDA counterpart of
// slam_indoor_code_tpu/ops/pallas_kernels.py:_l2_kernel (entry point
// top2_pallas(metric="l2" | "hamming"), with _merge_top2).  It computes what
// top2_batch computes at B = 1 (the tile loop is top2_l2.cuh), for the shape
// that one lane fills badly: a 2048-row pair is only 16 blocks of 128 rows
// on a card with 132 SMs.  Hamming rides it as in top2_batch (the wrapper
// unpacks the bits to 0/1 bf16 vectors).
//
// What bounds it at 2048 x 2048 x 128: 2*N*M*D = 1.07 GFLOP -> 1.1 us at
// 989 TFLOP/s bf16 on the tensor cores, against 2 MB of f32 operands
// (0.6 us at 3.35 TB/s): bound by operations, and at that size by the two
// launches' fixed cost in practice.  Like top2_batch it runs on the CUDA
// cores (>= 16 us at the f32 FMA peak).
//
// Design: pass 1 splits the column axis into S ranges of `cols_per_split`
// columns (a multiple of 32) and gives each (row tile, range) its own block,
// which writes a partial (d1, idx1, d2) per row to scratch [S, N].  Pass 2
// merges the S partials of a row in range order with _merge_top2's rule —
// the new minimum must be strictly smaller, so the lowest column still wins
// a tie; d2 = min(d2, e2, max(d1, e1)) keeps a duplicate minimum as d2.

#include "top2_l2.cuh"

namespace {

__global__ void top2_pair_merge(const float* __restrict__ pd1,   // [S, N]
                                const int* __restrict__ pi1,     // [S, N]
                                const float* __restrict__ pd2,   // [S, N]
                                float* __restrict__ d1_out,      // [N]
                                int* __restrict__ i1_out,        // [N]
                                float* __restrict__ d2_out,      // [N]
                                int N, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float d1 = pd1[n], d2 = pd2[n];
  int i1 = pi1[n];
  for (int s = 1; s < S; ++s) {
    const size_t o = (size_t)s * N + n;
    const float e1 = pd1[o], e2 = pd2[o];
    const float nd2 = fminf(fminf(d2, e2), fmaxf(d1, e1));
    if (e1 < d1) {
      d1 = e1;
      i1 = pi1[o];
    }
    d2 = nd2;
  }
  d1_out[n] = d1;
  i1_out[n] = i1;
  d2_out[n] = d2;
}

}  // namespace

// C entry point, bound from Python with ctypes.  Pointers are device
// pointers; `stream` is a cudaStream_t.  pd1/pi1/pd2 are scratch of S*N
// elements each; cols_per_split * S >= M.  Launches both passes on that
// stream without synchronising and returns the first CUDA error (0 = ok).
extern "C" int top2_pair_launch(const void* a, const void* b,
                                const void* mask, void* d1, void* i1,
                                void* d2, void* pd1, void* pi1, void* pd2,
                                int N, int M, int D, int S,
                                int cols_per_split, void* stream) {
  if (N <= 0) return 0;
  if (S < 1 || cols_per_split < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = l2_launch(a, b, mask, pd1, pi1, pd2, N, M, D, 1, 1, S,
                              cols_per_split, st);
  if (err != cudaSuccess) return (int)err;
  top2_pair_merge<<<(N + 255) / 256, 256, 0, st>>>(
      (const float*)pd1, (const int*)pi1, (const float*)pd2, (float*)d1,
      (int*)i1, (float*)d2, N, S);
  return (int)cudaGetLastError();
}
