// Fused squared-L2 distance + running per-row top-2 on the tensor cores: the
// tile loop shared by top2_batch.cu (one query set against B candidate sets,
// optionally several lanes per block) and top2_pair.cu (one pair, the
// column axis split across blocks).  Both are counterparts of the squared-L2
// bodies of slam_indoor_code_tpu/ops/pallas_kernels.py (_l2_kernel,
// _l2_kernel_b, _l2_kernel_b_multi), whose product runs on the TPU's matrix
// unit (jax.lax.dot_general on bf16 operands, f32 sums).
//
// Function: for every lane b and query row n, over the block's columns m,
//   d(n, m) = max(|a_n|^2 + |b_m|^2 - 2 a_n . b_m, 0)   (bf16 operands, f32 sums)
//   d(n, m) = 3e38 where mask[b, m] == 0
//   d1 = min_m d, idx1 = lowest m attaining it,
//   d2 = min over m != idx1 (a duplicate minimum gives d2 == d1).
// Columns that are all masked give d1 = d2 = 3e38, idx1 = 0.
//
// Design.  A block of 8 warps owns TQ = 128 query rows and sweeps the
// lane's columns in tiles of TC = 128, in increasing column order.  The
// warps split the tile 4 (rows) x 2 (columns): each holds a 32 x 64 f32
// accumulator, 2 x 8 tiles of mma.sync.m16n8k16 (bf16 x bf16 -> f32, exact
// products, so only the order of the sum differs from the plain version).
// Operands reach the tensor cores from shared memory through ldmatrix;
// every row of a tile is KC = 128 dimensions plus 8 bf16 of padding
// (272 B), so the 8 rows an ldmatrix phase reads fall on 8 disjoint 4-bank
// groups.
//   - The query tile is staged once per block in chunks of KC dimensions
//     and stays resident for the whole sweep (and for every lane of the
//     block) when it fits (D <= 512); a wider D streams the query chunk
//     beside each candidate chunk instead.
//   - Candidate chunks [TC x KC] stream through a STAGES-deep cp.async ring
//     (commit_group / wait_group), one chunk per pipeline step, so the
//     loads of the next chunk overlap the products of this one.  Ragged N,
//     M and D are zero-filled there; rows whose global address is not
//     16-byte aligned (D % 8 != 0) are staged with plain loads instead.
//   - |a|^2 is summed once per block (over the first tile's chunks) and
//     |b|^2 once per candidate tile, in f32 from the same bf16 values in
//     shared memory, as the TPU kernel does.  A masked or ragged column
//     gets |b|^2 = inf: its distance is inf, which the strict '<' against
//     the initial 3e38 never admits.
//   - Epilogue: each thread folds its accumulator fragments (4 rows x 16
//     columns per tile) into a running (d1, idx1, d2) per row, in increasing
//     column order with a strict '<'.  After the last tile the 4 lanes that
//     share a row merge by (distance, column) through quad shuffles, then
//     the two column warps through shared memory (top2_merge.cuh), which
//     gives the answer of one in-order scan.
// The [N, M] distance matrix never reaches device memory.
//
// What bounds it: the product (2*N*M*D operations) on the tensor cores, and
// at D = 128 nearly as much again in the epilogue, which costs 8 CUDA-core
// instructions per distance (add, FMA, max; then compare, select and three
// min/max in the fold).
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

#include "top2_merge.cuh"

namespace {

constexpr int L2_TQ = 128;                // query rows per block
constexpr int L2_TC = 128;                // candidate columns per tile
constexpr int L2_KC = 128;                // dimensions per staged chunk
constexpr int L2_LD = L2_KC + 8;          // padded row, in bf16 (272 B)
constexpr int L2_THREADS = 256;           // 8 warps: 4 along rows, 2 along columns
constexpr int L2_STAGES = 2;              // depth of the candidate ring
constexpr int L2_CHUNK = L2_TQ * L2_LD;   // bf16 per staged chunk (TQ == TC)
constexpr int L2_SMEM_MAX = 232448;       // bytes of shared memory a block may take
constexpr float L2_BIG = 3.0e38f;

// Bytes of the block's small tables: |b|^2 of two tiles, the cross-warp
// merge buffer, |a|^2.
constexpr int L2_TABLES = 2 * L2_TC * 4 + L2_TQ * 12 + L2_TQ * 4;

inline int l2_nchunks(int D) { return (D + L2_KC - 1) / L2_KC; }

// The query tile stays resident when all its chunks fit beside the ring.
inline bool l2_resident(int D) {
  const long bytes = 2L * L2_CHUNK * (l2_nchunks(D) + L2_STAGES) + L2_TABLES;
  return bytes <= L2_SMEM_MAX;
}

inline size_t l2_smem_bytes(int D) {
  const int chunks = l2_resident(D) ? l2_nchunks(D) + L2_STAGES
                                    : 2 * L2_STAGES;
  return 2 * (size_t)L2_CHUNK * chunks + L2_TABLES;
}

// Half of the squared norm of row threadIdx.x >> 1 of a staged chunk: the
// thread's half of the chunk's dimensions, in f32 from the bf16 values.
// Half 1 starts 4 units (64 B) into its range, so the 8 threads of an LDS.128
// phase (rows r..r+3, both halves) read 8 disjoint 4-bank groups.
__device__ __forceinline__ float l2_half_norm2(const __nv_bfloat16* chunk) {
  constexpr int U = L2_KC / 16;   // 16-byte units per half row
  static_assert(U == 8, "the bank rotation assumes 128-dimension chunks");
  const int h = threadIdx.x & 1;
  const __nv_bfloat16* p = chunk + (threadIdx.x >> 1) * L2_LD + h * (L2_KC / 2);
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < U; ++v) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + ((v + 4 * h) % U) * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      s += f.x * f.x;
      s += f.y * f.y;
    }
  }
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + 128) of a row-major [rows, D] bf16 matrix, dimensions
// [k0, k0 + KC), into a padded chunk; rows >= rend and dimensions >= D read
// as zeros.  With vec, 16-byte cp.async copies (the caller commits them);
// otherwise plain loads, visible after the next __syncthreads.
__device__ __forceinline__ void l2_stage(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, int r0,
                                         int rend, int k0, int D, bool vec) {
  constexpr int UNITS = L2_TQ * (L2_KC / 8);   // 16-byte units per chunk
  for (int u = threadIdx.x; u < UNITS; u += L2_THREADS) {
    const int r = u / (L2_KC / 8), k = (u % (L2_KC / 8)) * 8;
    const int gr = r0 + r, gk = k0 + k;
    __nv_bfloat16* d = dst + r * L2_LD + k;
    if (vec) {
      const bool in = gr < rend && gk < D;   // D % 8 == 0: whole unit or none
      cp_async16(d, in ? src + (size_t)gr * D + gk : src, in ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (gr < rend && gk + e < D) ? src[(size_t)gr * D + gk + e]
                                         : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

__global__ void __launch_bounds__(L2_THREADS, 2)
top2_l2_kernel(const __nv_bfloat16* __restrict__ a,   // [N, D]
               const __nv_bfloat16* __restrict__ b,   // [B, M, D]
               const uint8_t* __restrict__ mask,      // [B, M]
               float* __restrict__ d1_out,            // [S, B, N]
               int* __restrict__ i1_out,              // [S, B, N]
               float* __restrict__ d2_out,            // [S, B, N]
               int N, int M, int D, int B, int lpb, int cols_per_split,
               bool resident, bool vec) {
  extern __shared__ __align__(16) unsigned char l2_smem[];
  const int nch = (D + L2_KC - 1) / L2_KC;
  __nv_bfloat16* qres = reinterpret_cast<__nv_bfloat16*>(l2_smem);
  __nv_bfloat16* ring = qres + (resident ? (size_t)nch * L2_CHUNK : 0);
  // a ring stage: one candidate chunk, plus its query chunk when the query
  // tile is not resident
  const int stage_elems = (resident ? 1 : 2) * L2_CHUNK;
  float* b2s = reinterpret_cast<float*>(ring + (size_t)L2_STAGES * stage_elems);
  float* xd1 = b2s + 2 * L2_TC;                              // [TQ]
  int* xi1 = reinterpret_cast<int*>(xd1 + L2_TQ);            // [TQ]
  float* xd2 = reinterpret_cast<float*>(xi1 + L2_TQ);        // [TQ]
  float* a2s = xd2 + L2_TQ;                                  // [TQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane_id = tid & 31;
  const int g = lane_id >> 2, t4 = lane_id & 3;   // mma fragment coordinates
  const int wr = (warp & 3) * 32;                 // the warp's first row
  const int wc = (warp >> 2) * 64;                // the warp's first column
  const int row0 = blockIdx.x * L2_TQ;
  const int cbeg = blockIdx.z * cols_per_split;
  const int cend = min(M, cbeg + cols_per_split);
  const int ntiles = cend > cbeg ? (cend - cbeg + L2_TC - 1) / L2_TC : 0;
  const int lane0 = blockIdx.y * lpb;
  const int nl = min(lpb, B - lane0);
  const int per_lane = ntiles * nch;
  const int nitems = nl * per_lane;

  if (resident) {
    for (int c = 0; c < nch; ++c)
      l2_stage(qres + (size_t)c * L2_CHUNK, a, row0, N, c * L2_KC, D, vec);
    cp_async_commit();
  }

  auto load_item = [&](int item) {
    if (item < nitems) {
      const int l = item / per_lane, rem = item - l * per_lane;
      const int tile = rem / nch, c = rem - tile * nch;
      __nv_bfloat16* st = ring + (size_t)(item % L2_STAGES) * stage_elems;
      l2_stage(st, b + (size_t)(lane0 + l) * M * D, cbeg + tile * L2_TC, cend,
               c * L2_KC, D, vec);
      if (!resident) l2_stage(st + L2_CHUNK, a, row0, N, c * L2_KC, D, vec);
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

#pragma unroll
  for (int s = 0; s < L2_STAGES - 1; ++s) load_item(s);

  float acc[2][8][4];
  float d1[4], d2[4], a2[4];
  int i1[4];
  // this thread's half of |a|^2 of row tid >> 1 (summed over the first
  // tile's chunks) and of |b|^2 of the tile's column tid >> 1
  float a2p = 0.f, b2p = 0.f;
  bool okc = false;   // column tid >> 1 is real and unmasked
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    d1[r] = L2_BIG;
    d2[r] = L2_BIG;
    i1[r] = 0;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int item = 0; item < nitems; ++item) {
    cp_async_wait<L2_STAGES - 2>();
    __syncthreads();   // this item's chunks have landed; the stage refilled
                       // below has been consumed by every warp
    load_item(item + L2_STAGES - 1);

    const int l = item / per_lane, rem = item - l * per_lane;
    const int tile = rem / nch, c = rem - tile * nch;
    const int c0 = cbeg + tile * L2_TC;
    if (c == 0 && (tid & 1) == 0) {   // read early, used after the products
      const int col = c0 + (tid >> 1);
      okc = col < cend && mask[(size_t)(lane0 + l) * M + col] != 0;
    }
    const __nv_bfloat16* cs = ring + (size_t)(item % L2_STAGES) * stage_elems;
    const __nv_bfloat16* qs = resident ? qres + (size_t)c * L2_CHUNK
                                       : cs + L2_CHUNK;

    // |b|^2 (and in the first tile |a|^2): two threads per column (row),
    // half the chunk's dimensions each
    b2p += l2_half_norm2(cs);
    if (item < nch) a2p += l2_half_norm2(qs);

    // the chunk's products: 4 k-steps of 16
#pragma unroll
    for (int ks = 0; ks < L2_KC / 16; ++ks) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], qs + (wr + mi * 16 + (lane_id & 15)) * L2_LD +
                                ks * 16 + (lane_id >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        unsigned bf[4];
        ldmatrix_x4(bf, cs + (wc + nb * 16 + (lane_id >> 4) * 8 +
                              (lane_id & 7)) * L2_LD +
                            ks * 16 + ((lane_id >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nb], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * nb + 1], af[mi], bf[2], bf[3]);
        }
      }
    }

    if (c != nch - 1) continue;

    // the tile is complete: publish |b|^2 (inf for a masked or ragged
    // column, whose distance then never enters the top-2), then fold the
    // tile into the running top-2 of each row
    float* b2t = b2s + (tile & 1) * L2_TC;
    b2p += __shfl_xor_sync(0xffffffffu, b2p, 1);
    if ((tid & 1) == 0) b2t[tid >> 1] = okc ? b2p : __int_as_float(0x7f800000);
    b2p = 0.f;
    const bool first = item == nch - 1;
    if (first) {
      a2p += __shfl_xor_sync(0xffffffffu, a2p, 1);
      if ((tid & 1) == 0) a2s[tid >> 1] = a2p;
    }
    __syncthreads();
    if (first) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a2[r] = a2s[wr + (r >> 1) * 16 + (r & 1) * 8 + g];
    }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wc + nj * 8 + 2 * t4 + e;
        const float bb = b2t[cl];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = acc[r >> 1][nj][(r & 1) * 2 + e];
          const float d = fmaxf(fmaf(-2.f, v, a2[r] + bb), 0.f);
          top2_fold(d, c0 + cl, d1[r], i1[r], d2[r]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

    if (tile != ntiles - 1) continue;

    // the lane is complete: merge the 4 lanes of each quad, then the two
    // column warps, and write the row's result
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float e1 = __shfl_xor_sync(0xffffffffu, d1[r], off);
        const int j1 = __shfl_xor_sync(0xffffffffu, i1[r], off);
        const float e2 = __shfl_xor_sync(0xffffffffu, d2[r], off);
        top2_merge(d1[r], i1[r], d2[r], e1, j1, e2);
      }
    if (wc != 0 && t4 == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = wr + (r >> 1) * 16 + (r & 1) * 8 + g;
        xd1[rl] = d1[r];
        xi1[rl] = i1[r];
        xd2[rl] = d2[r];
      }
    }
    __syncthreads();
    if (wc == 0 && t4 == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int rl = wr + (r >> 1) * 16 + (r & 1) * 8 + g;
        top2_merge(d1[r], i1[r], d2[r], xd1[rl], xi1[rl], xd2[rl]);
        if (row0 + rl < N) {
          const size_t o = ((size_t)blockIdx.z * B + lane0 + l) * N + row0 + rl;
          d1_out[o] = d1[r];
          i1_out[o] = i1[r];
          d2_out[o] = d2[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      d1[r] = L2_BIG;
      d2[r] = L2_BIG;
      i1[r] = 0;
    }
  }
  cp_async_wait<0>();

  // a block with no columns still owes its rows the empty result
  if (ntiles == 0 && tid < L2_TQ && row0 + tid < N)
    for (int l = 0; l < nl; ++l) {
      const size_t o = ((size_t)blockIdx.z * B + lane0 + l) * N + row0 + tid;
      d1_out[o] = L2_BIG;
      i1_out[o] = 0;
      d2_out[o] = L2_BIG;
    }
}

// Launch top2_l2_kernel over grid (ceil(N/TQ), ceil(B/lpb), S) on `stream`;
// returns the CUDA error of the setup or the launch (0 = launched).
inline cudaError_t l2_launch(const void* a, const void* b, const void* mask,
                             void* d1, void* i1, void* d2, int N, int M, int D,
                             int B, int lpb, int S, int cols_per_split,
                             cudaStream_t stream) {
  const size_t smem = l2_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      top2_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies need every row to start on a 16-byte boundary
  const bool vec = D % 8 == 0 && ((uintptr_t)a % 16) == 0 &&
                   ((uintptr_t)b % 16) == 0;
  const dim3 grid((N + L2_TQ - 1) / L2_TQ, (B + lpb - 1) / lpb, S);
  top2_l2_kernel<<<grid, L2_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (const uint8_t*)mask,
      (float*)d1, (int*)i1, (float*)d2, N, M, D, B, lpb, cols_per_split,
      l2_resident(D), vec);
  return cudaGetLastError();
}

}  // namespace
