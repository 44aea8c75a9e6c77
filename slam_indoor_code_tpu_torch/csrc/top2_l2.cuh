// Fused squared-L2 distance + running per-row top-2 on the CUDA cores: the
// tile loop shared by top2_batch.cu (one query set against B candidate sets,
// optionally several lanes per block) and top2_pair.cu (one pair, the
// column axis split across blocks).  Both are counterparts of the squared-L2
// bodies of slam_indoor_code_tpu/ops/pallas_kernels.py (_l2_kernel,
// _l2_kernel_b, _l2_kernel_b_multi).
//
// Function: for every lane b and query row n, over the block's columns m,
//   d(n, m) = max(|a_n|^2 + |b_m|^2 - 2 a_n . b_m, 0)   (bf16 operands, f32 sums)
//   d(n, m) = 3e38 where mask[b, m] == 0
//   d1 = min_m d, idx1 = lowest m attaining it,
//   d2 = min over m != idx1 (a duplicate minimum gives d2 == d1).
// Columns that are all masked give d1 = d2 = 3e38, idx1 = 0.
//
// Design: a block holds TQ query rows, one per thread, k-major in shared
// memory as bf16 (so D up to 604 stays resident: 2*TQ*D + 4*TC*D bytes),
// and streams candidate tiles of TC columns in increasing column order.
// For each tile a thread accumulates TC dot products over k = 0..D-1 in
// order (one f32 FMA chain each) and folds the distances into its register
// top-2 with a strict '<', so the lowest column wins a tie exactly as the
// TPU kernel's first-index argmin + strict merge.  A wider D is staged in
// chunks of `dq` dimensions, the query chunks again for every tile.  The
// [N, M] distance matrix never reaches device memory; ragged N, M and D are
// masked here.
//
// Grid (ceil(N / TQ), ceil(B / lpb), S).  blockIdx.y takes lanes
// y*lpb .. y*lpb+lpb-1 against the one staged query tile; blockIdx.z takes
// columns [z*cols_per_split, (z+1)*cols_per_split).  Output index
// (z*B + lane)*N + row: with S == 1 that is the [B, N] result, otherwise
// per-split partials that the caller merges in split order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L2_TQ = 128;   // query rows per block == threads per block
constexpr int L2_TC = 32;    // candidate columns per tile (register accumulators)
constexpr int L2_SMEM_MAX = 232448;   // bytes of shared memory a block may take
constexpr float L2_BIG = 3.0e38f;

// Dimensions per staged chunk: all of D when the tiles fit, else 256.
inline int l2_chunk(int D) {
  const long whole = 2L * L2_TQ * D + 4L * L2_TC * D + 8L * L2_TC;
  return whole <= L2_SMEM_MAX ? D : 256;
}

inline size_t l2_smem_bytes(int dq) {
  return 2 * (size_t)L2_TQ * dq + 4 * (size_t)L2_TC * dq + 8 * (size_t)L2_TC;
}

__global__ void __launch_bounds__(L2_TQ)
top2_l2_kernel(const __nv_bfloat16* __restrict__ a,   // [N, D]
               const __nv_bfloat16* __restrict__ b,   // [B, M, D]
               const uint8_t* __restrict__ mask,      // [B, M]
               float* __restrict__ d1_out,            // [S, B, N]
               int* __restrict__ i1_out,              // [S, B, N]
               float* __restrict__ d2_out,            // [S, B, N]
               int N, int M, int D, int B, int lpb, int cols_per_split,
               int dq) {
  extern __shared__ __align__(16) unsigned char l2_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(l2_smem);  // [dq][TQ]
  float* cs = reinterpret_cast<float*>(qs + (size_t)dq * L2_TQ);    // [TC][dq]
  float* b2s = cs + (size_t)L2_TC * dq;                             // [TC]
  float* oks = b2s + L2_TC;                                         // [TC]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const int row0 = blockIdx.x * L2_TQ;
  const int row = row0 + tid;
  const int cbeg = blockIdx.z * cols_per_split;
  const int cend = min(M, cbeg + cols_per_split);
  const int nchunks = (D + dq - 1) / dq;
  const bool resident = nchunks == 1;

  float a2 = 0.f;
  if (resident) {
    for (int e = tid; e < L2_TQ * D; e += L2_TQ) {
      const int r = e / D, k = e - r * D;
      const int gr = row0 + r;
      qs[k * L2_TQ + r] = gr < N ? a[(size_t)gr * D + k] : __float2bfloat16(0.f);
    }
    __syncthreads();
    for (int k = 0; k < D; ++k) {
      const float v = __bfloat162float(qs[k * L2_TQ + tid]);
      a2 += v * v;
    }
  }

  for (int l = 0; l < lpb; ++l) {
    const int lane = blockIdx.y * lpb + l;
    if (lane >= B) break;   // uniform across the block
    const __nv_bfloat16* bl = b + (size_t)lane * M * D;
    const uint8_t* ml = mask + (size_t)lane * M;
    float d1 = L2_BIG, d2 = L2_BIG;
    int i1 = 0;
    for (int c0 = cbeg; c0 < cend; c0 += L2_TC) {
      float acc[L2_TC];
#pragma unroll
      for (int u = 0; u < L2_TC; ++u) acc[u] = 0.f;
      for (int kc = 0; kc < nchunks; ++kc) {
        const int k0 = kc * dq;
        const int kn = min(dq, D - k0);
        __syncthreads();   // the previous chunk (and fold) fully consumed
        if (!resident) {
          for (int e = tid; e < L2_TQ * kn; e += L2_TQ) {
            const int r = e / kn, k = e - r * kn;
            const int gr = row0 + r;
            qs[k * L2_TQ + r] = gr < N ? a[(size_t)gr * D + k0 + k]
                                       : __float2bfloat16(0.f);
          }
        }
        for (int e = tid; e < L2_TC * kn; e += L2_TQ) {
          const int c = e / kn, k = e - c * kn;
          const int col = c0 + c;
          cs[c * dq + k] = col < cend
              ? __bfloat162float(bl[(size_t)col * D + k0 + k]) : 0.f;
        }
        __syncthreads();
        for (int c = warp; c < L2_TC; c += L2_TQ / 32) {
          float s = 0.f;
          for (int k = wl; k < kn; k += 32) {
            const float v = cs[c * dq + k];
            s += v * v;
          }
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (wl == 0) {
            const int col = c0 + c;
            b2s[c] = kc == 0 ? s : b2s[c] + s;
            if (kc == 0) oks[c] = (col < cend && ml[col] != 0) ? 1.f : 0.f;
          }
        }
        if (row < N) {
          if (!resident && l == 0 && c0 == cbeg) {
            for (int k = 0; k < kn; ++k) {
              const float v = __bfloat162float(qs[k * L2_TQ + tid]);
              a2 += v * v;
            }
          }
          for (int k = 0; k < kn; ++k) {
            const float q = __bfloat162float(qs[k * L2_TQ + tid]);
#pragma unroll
            for (int u = 0; u < L2_TC; ++u) acc[u] += q * cs[u * dq + k];
          }
        }
      }
      __syncthreads();   // b2s and oks of the last chunk are written
      if (row < N) {
        const int ncols = min(L2_TC, cend - c0);
#pragma unroll
        for (int u = 0; u < L2_TC; ++u) {
          if (u < ncols) {
            float d = fmaxf(a2 + b2s[u] - 2.f * acc[u], 0.f);
            if (oks[u] == 0.f) d = L2_BIG;
            if (d < d1) {
              d2 = d1;
              d1 = d;
              i1 = c0 + u;
            } else if (d < d2) {
              d2 = d;
            }
          }
        }
      }
    }
    if (row < N) {
      const size_t o = ((size_t)blockIdx.z * B + lane) * N + row;
      d1_out[o] = d1;
      i1_out[o] = i1;
      d2_out[o] = d2;
    }
  }
}

// Launch top2_l2_kernel over grid (ceil(N/TQ), ceil(B/lpb), S) on `stream`;
// returns the CUDA error of the setup or the launch (0 = launched).
inline cudaError_t l2_launch(const void* a, const void* b, const void* mask,
                             void* d1, void* i1, void* d2, int N, int M, int D,
                             int B, int lpb, int S, int cols_per_split,
                             cudaStream_t stream) {
  const int dq = l2_chunk(D);
  const size_t smem = l2_smem_bytes(dq);
  cudaError_t err = cudaFuncSetAttribute(
      top2_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + L2_TQ - 1) / L2_TQ, (B + lpb - 1) / lpb, S);
  top2_l2_kernel<<<grid, L2_TQ, smem, stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (const uint8_t*)mask,
      (float*)d1, (int*)i1, (float*)d2, N, M, D, B, lpb, cols_per_split, dq);
  return cudaGetLastError();
}

}  // namespace
