// Fused squared-L2 distance + running per-row top-2 of ONE query set against
// B candidate sets, in one launch — the CUDA counterpart of
// slam_indoor_code_tpu/ops/pallas_kernels.py:_l2_kernel_b (entry point
// top2_pallas_batch, with _merge_top2).
//
// Function: for every lane b and query row n,
//   d(n, m) = max(|a_n|^2 + |b_m|^2 - 2 a_n . b_m, 0)   (bf16 operands, f32 sums)
//   d(n, m) = 3e38 where mask[b, m] == 0
//   d1[b, n] = min_m d, idx1[b, n] = lowest m attaining it,
//   d2[b, n] = min over m != idx1 (a duplicate minimum gives d2 == d1).
// A lane whose columns are all masked gives d1 = d2 = 3e38, idx1 = 0.
// Hamming distance rides the same kernel: the wrapper unpacks the bits to
// 0/1 bf16 vectors (D = 256), whose squared L2 distance is exact.
//
// What bounds it at the main path's shapes (N = M = 2048, D = 128, B = 16):
// 2*B*N*M*D = 17.2 GFLOP -> 17 us at 989 TFLOP/s bf16 dense on the tensor
// cores, against 8.4 MB of bf16 B (+0.5 MB A) -> 2.6 us at 3.35 TB/s, so it is
// bound by operations.  This first design does nothing about that yet: it
// runs on the CUDA cores in f32 FMA (67 TFLOP/s peak, so >= 0.26 ms), with
// operands staged through shared memory.  mma.sync / wgmma tiles, TMA and a
// persistent schedule are later work.
//
// Design: grid (ceil(N / TQ), B).  A block holds TQ query rows (one per
// thread) transposed in shared memory, streams candidate tiles of TC columns
// through shared memory in increasing column order, and folds each distance
// into the thread's register top-2 with a strict '<', so the lowest column
// wins a tie exactly as the TPU kernel's first-index argmin + strict merge.
// The [N, M] distance matrix never reaches device memory.  Ragged N and M are
// masked here; the wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 128;   // query rows per block == threads per block
constexpr int TC = 32;    // candidate columns per shared-memory tile
constexpr int CPB = 8;    // candidate columns accumulated per register pass
constexpr float BIG = 3.0e38f;

__global__ void __launch_bounds__(TQ)
top2_batch_kernel(const __nv_bfloat16* __restrict__ a,     // [N, D]
                  const __nv_bfloat16* __restrict__ b,     // [B, M, D]
                  const uint8_t* __restrict__ mask,        // [B, M]
                  float* __restrict__ d1_out,              // [B, N]
                  int* __restrict__ i1_out,                // [B, N]
                  float* __restrict__ d2_out,              // [B, N]
                  int N, int M, int D) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [D][TQ]  query tile, transposed
  float* cs = qs + D * TQ;          // [TC][D]  candidate tile
  float* b2s = cs + TC * D;         // [TC]     candidate squared norms
  float* oks = b2s + TC;            // [TC]     1 = real unmasked column

  const int tid = threadIdx.x;
  const int lane = blockIdx.y;
  const int row0 = blockIdx.x * TQ;
  const int row = row0 + tid;
  const __nv_bfloat16* bl = b + (size_t)lane * M * D;
  const uint8_t* ml = mask + (size_t)lane * M;

  for (int e = tid; e < TQ * D; e += TQ) {
    const int r = e / D, k = e - r * D;
    const int gr = row0 + r;
    qs[k * TQ + r] = gr < N ? __bfloat162float(a[(size_t)gr * D + k]) : 0.f;
  }
  __syncthreads();
  float a2 = 0.f;
  for (int k = 0; k < D; ++k) {
    const float v = qs[k * TQ + tid];
    a2 += v * v;
  }

  float d1 = BIG, d2 = BIG;
  int i1 = 0;
  const int warp = tid >> 5, wl = tid & 31;
  for (int c0 = 0; c0 < M; c0 += TC) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < TC * D; e += TQ) {
      const int c = e / D, k = e - c * D;
      const int col = c0 + c;
      cs[e] = col < M ? __bfloat162float(bl[(size_t)col * D + k]) : 0.f;
    }
    __syncthreads();
    for (int c = warp; c < TC; c += TQ / 32) {
      float s = 0.f;
      for (int k = wl; k < D; k += 32) {
        const float v = cs[c * D + k];
        s += v * v;
      }
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (wl == 0) {
        const int col = c0 + c;
        b2s[c] = s;
        oks[c] = (col < M && ml[col] != 0) ? 1.f : 0.f;
      }
    }
    __syncthreads();
    if (row < N) {
      const int ncols = min(TC, M - c0);
      for (int cc = 0; cc < ncols; cc += CPB) {
        float acc[CPB];
#pragma unroll
        for (int u = 0; u < CPB; ++u) acc[u] = 0.f;
        for (int k = 0; k < D; ++k) {
          const float q = qs[k * TQ + tid];
#pragma unroll
          for (int u = 0; u < CPB; ++u) acc[u] += q * cs[(cc + u) * D + k];
        }
#pragma unroll
        for (int u = 0; u < CPB; ++u) {
          const int c = cc + u;
          if (c < ncols) {
            float d = fmaxf(a2 + b2s[c] - 2.f * acc[u], 0.f);
            if (oks[c] == 0.f) d = BIG;
            if (d < d1) {
              d2 = d1;
              d1 = d;
              i1 = c0 + c;
            } else if (d < d2) {
              d2 = d;
            }
          }
        }
      }
    }
  }
  if (row < N) {
    const size_t o = (size_t)lane * N + row;
    d1_out[o] = d1;
    i1_out[o] = i1;
    d2_out[o] = d2;
  }
}

}  // namespace

// C entry point, bound from Python with ctypes.  Pointers are device
// pointers; `stream` is a cudaStream_t.  Launches on that stream without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int top2_batch_launch(const void* a, const void* b,
                                 const void* mask, void* d1, void* i1,
                                 void* d2, int N, int M, int D, int B,
                                 void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)D * TQ + (size_t)TC * D + 2 * TC);
  cudaError_t err = cudaFuncSetAttribute(
      top2_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  top2_batch_kernel<<<grid, TQ, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (const uint8_t*)mask,
      (float*)d1, (int*)i1, (float*)d2, N, M, D);
  return (int)cudaGetLastError();
}
