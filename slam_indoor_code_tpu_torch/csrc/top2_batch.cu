// Fused squared-L2 distance + running per-row top-2 of ONE query set against
// B candidate sets, in one launch — the CUDA counterpart of
// slam_indoor_code_tpu/ops/pallas_kernels.py:_l2_kernel_b (entry point
// top2_pallas_batch, with _merge_top2) and, with lanes_per_block > 1, of
// _l2_kernel_b_multi.  The tile loop and its function are in top2_l2.cuh.
// Hamming distance rides the same kernel: the wrapper unpacks the bits to
// 0/1 bf16 vectors (D = 256), whose squared L2 distance is exact.
//
// What bounds it at the main path's shapes (N = M = 2048, D = 128, B = 16):
// 2*B*N*M*D = 17.2 GFLOP -> 17 us at 989 TFLOP/s bf16 dense on the tensor
// cores, against 8.4 MB of bf16 B (+0.5 MB A) -> 2.6 us at 3.35 TB/s, so it is
// bound by operations.  This design does nothing about that yet: it runs on
// the CUDA cores in f32 FMA (67 TFLOP/s peak, so >= 0.26 ms), with operands
// staged through shared memory.  mma.sync / wgmma tiles, TMA and a
// persistent schedule are later work.
//
// Grid (ceil(N / 128), ceil(B / lpb)): a block stages its 128 query rows
// once and scans lanes y*lpb .. y*lpb+lpb-1 against them, so the query tile
// is loaded once per lpb lanes (the result does not depend on lpb).

#include "top2_l2.cuh"

// C entry point, bound from Python with ctypes.  Pointers are device
// pointers; `stream` is a cudaStream_t.  Launches on that stream without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int top2_batch_launch(const void* a, const void* b,
                                 const void* mask, void* d1, void* i1,
                                 void* d2, int N, int M, int D, int B,
                                 int lpb, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  if (lpb < 1) return (int)cudaErrorInvalidValue;
  return (int)l2_launch(a, b, mask, d1, i1, d2, N, M, D, B, lpb, 1, M,
                        (cudaStream_t)stream);
}
