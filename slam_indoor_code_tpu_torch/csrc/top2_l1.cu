// Fused L1 distance + running per-row top-2 of ONE query set against Bt
// candidate sets, in one launch — the CUDA counterpart of
// slam_indoor_code_tpu/ops/pallas_kernels.py:_l1_kernel (entry point
// top2_pallas(metric="l1"), with _merge_top2).  On the TPU, match_batch
// vmaps the per-pair kernel, which lifts the Bt pairs into one grid; here
// the lane is a grid axis of the same launch.
//
// Function: for every lane b and query row n,
//   d(n, m) = sum_{k=0..D-1} |a[n,k] - b[b,m,k]|   (f32, added in k order)
//   d(n, m) = 3e38 where mask[b, m] == 0
//   d1[b, n] = min_m d, idx1[b, n] = lowest m attaining it,
//   d2[b, n] = min over m != idx1 (a duplicate minimum gives d2 == d1).
// A lane whose columns are all masked gives d1 = d2 = 3e38, idx1 = 0.
// Each term is __fsub_rn, fabsf, __fadd_rn in k order: no contraction and
// no reassociation, so d equals the TPU kernel's accumulation bit for bit.
//
// What bounds it: L1 has no matmul identity, so it runs on the CUDA cores.
// At the main path's shapes (Bt = 16, N = M = 2048, D = 128) it is
// 8.6e9 terms x 2 FP32 instructions (subtract; add with the |.| operand
// modifier) over 132 SMs x 128 lanes x 1.98 GHz = 0.51 ms, against 17 MB of
// f32 operands (5 us at 3.35 TB/s): bound by operations.
//
// Design: grid (ceil(N / 128), Bt), 256 threads.  A block owns 128 query
// rows and walks the lane's columns in tiles of 128.  For each column tile
// it stages the query and candidate tiles in shared memory in chunks of 32
// dimensions, k-major (so a thread reads its 4+4 rows and 4+4 columns as
// float4s), and every thread accumulates an 8x8 register tile: 8 rows
// (ty*4 + i, 64 + ty*4 + i) by 8 columns (tx*4 + j, 64 + tx*4 + j).  After
// the last chunk each thread folds its 8 columns, in increasing order, into
// a running top-2 per row with a strict '<' (the lowest column wins a
// tie).  At the end the 16 threads that share a row merge their partial
// top-2s by (distance, column) through warp shuffles (top2_merge.cuh), which
// gives the same answer as one scan of all columns in order.  The [N, M] distance matrix
// never reaches device memory.  Ragged N, M and D are handled here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "top2_merge.cuh"

namespace {

constexpr int TR = 128;        // query rows per block
constexpr int TCOL = 128;      // candidate columns per tile
constexpr int DK = 32;         // dimensions per shared-memory chunk
constexpr int LD = TR + 4;     // padded k-major row (keeps float4 alignment)
constexpr int THREADS = 256;   // 16 x 16, each an 8x8 register tile
constexpr float BIG = 3.0e38f;

__global__ void __launch_bounds__(THREADS, 2)
top2_l1_kernel(const float* __restrict__ a,        // [N, D]
               const float* __restrict__ b,        // [Bt, M, D]
               const uint8_t* __restrict__ mask,   // [Bt, M]
               float* __restrict__ d1_out,         // [Bt, N]
               int* __restrict__ i1_out,           // [Bt, N]
               float* __restrict__ d2_out,         // [Bt, N]
               int N, int M, int D) {
  __shared__ __align__(16) float qs[DK * LD];   // [k][row]
  __shared__ __align__(16) float cs[DK * LD];   // [k][col]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = blockIdx.y;
  const int row0 = blockIdx.x * TR;
  const float* bl = b + (size_t)lane * M * D;
  const uint8_t* ml = mask + (size_t)lane * M;

  float d1[8], d2[8];
  int i1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d1[i] = BIG;
    d2[i] = BIG;
    i1[i] = 0;
  }

  for (int c0 = 0; c0 < M; c0 += TCOL) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += DK) {
      const int kn = min(DK, D - k0);
      __syncthreads();   // the previous chunk is fully consumed
      // a warp reads 32 consecutive dimensions of one row (coalesced)
      for (int e = tid; e < TR * DK; e += THREADS) {
        const int r = e / DK, k = e - r * DK;
        const int gr = row0 + r, gc = c0 + r;
        float q = 0.f, c = 0.f;
        if (k < kn) {
          if (gr < N) q = a[(size_t)gr * D + k0 + k];
          if (gc < M) c = bl[(size_t)gc * D + k0 + k];
        }
        qs[k * LD + r] = q;
        cs[k * LD + r] = c;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        const float4 qa = *reinterpret_cast<const float4*>(&qs[k * LD + ty * 4]);
        const float4 qb = *reinterpret_cast<const float4*>(&qs[k * LD + 64 + ty * 4]);
        const float4 ca = *reinterpret_cast<const float4*>(&cs[k * LD + tx * 4]);
        const float4 cb = *reinterpret_cast<const float4*>(&cs[k * LD + 64 + tx * 4]);
        const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float c[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], fabsf(__fsub_rn(q[i], c[j])));
      }
    }

    // fold this tile's columns, lowest first, into the running top-2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      const bool ok = col < M && ml[col] != 0;
      if (col < M) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          top2_fold(ok ? acc[i][j] : BIG, col, d1[i], i1[i], d2[i]);
      }
    }
  }

  // merge the 16 partial top-2s of each row (lanes tx = 0..15 of a warp half)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float e1 = __shfl_xor_sync(0xffffffffu, d1[i], off);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float e2 = __shfl_xor_sync(0xffffffffu, d2[i], off);
      top2_merge(d1[i], i1[i], d2[i], e1, j1, e2);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
      if (row < N) {
        const size_t o = (size_t)lane * N + row;
        d1_out[o] = d1[i];
        i1_out[o] = i1[i];
        d2_out[o] = d2[i];
      }
    }
  }
}

}  // namespace

// C entry point, bound from Python with ctypes.  Pointers are device
// pointers; `stream` is a cudaStream_t.  Launches on that stream without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int top2_l1_launch(const void* a, const void* b, const void* mask,
                              void* d1, void* i1, void* d2, int N, int M,
                              int D, int B, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const dim3 grid((N + TR - 1) / TR, B);
  top2_l1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const uint8_t*)mask, (float*)d1,
      (int*)i1, (float*)d2, N, M, D);
  return (int)cudaGetLastError();
}
