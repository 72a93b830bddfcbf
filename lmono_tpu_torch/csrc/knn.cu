// Exact brute-force KNN over a masked point bank, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmono_tpu/ops/pallas/knn.py:knn_pallas
// (_knn_acc_kernel) and, on this card, also the XLA approx_min_k path of
// lmono_tpu/ops/knn.py: the result is exact.  Python side:
// lmono_tpu_torch/ops/cuda/knn.py (build, checks, launch count); plain
// PyTorch version: lmono_tpu_torch/ops/knn.py:knn_plain.
//
// Semantics: for each query, the k smallest d² = |q - t|² over bank rows
// whose mask is set, ascending, with int32 indices; ties go to the earliest
// bank index; missing entries (fewer than k valid rows) are d² = 1e12 with
// index 0.
//
// What bounds it: about 8 f32 operations per query-bank pair (3 subtracts,
// 3 multiply-adds, a compare) plus a rare sorted insert, so it is bound by
// f32 issue rate, not memory: Q=4096 x M=65536 is about 2 GFLOP per call,
// and each bank tile is re-read from L2 by every query block.  K = 3 gives
// tensor cores nothing to do.
//
// Design:
//   * One thread per query; a block of kBlock queries streams its slice of
//     the bank through shared memory in tiles of kTile points, stored as
//     float4 with the mask folded into .w (every thread reads the same
//     shared word, a broadcast).  The TPU kernel moved masked rows to a far
//     sentinel because an in-kernel mask select hung Mosaic; here the mask
//     test is a free predicate.
//   * Each thread keeps its k <= 8 best (d², index) pairs in registers with
//     a sorted insert under strict <.  Points are scanned in ascending index
//     order, so strict < keeps the earlier index first among equal d².
//   * d² is the difference form dx²+dy²+dz² (on coordinates the caller has
//     recentred): exact, and free of the q²-2q·t+t² expansion's
//     cancellation at world magnitudes.
//   * With one thread per query, a grid over queries alone has only
//     ceil(Q/kBlock) blocks (12-32 at the odometry's shapes) for 132 SMs, so
//     the bank is also split over gridDim.y: each split writes its own
//     best-k, and a second kernel merges the splits per query.  Splits are
//     merged in ascending index order and each split's list is sorted by
//     (d², index), so the same strict-< insert keeps the earliest index on
//     ties.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // queries per block (one per thread)
constexpr int kTile = 1024;      // bank points per shared-memory tile (16 KB)
constexpr int kMergeBlock = 128;
constexpr float kInf = 1e12f;

// Insert (d, j) into the ascending list (bd, bi) of length K, dropping the
// last entry.  Equal distances stay behind the entries already present.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K],
                                       float d, int j) {
  if (!(d < bd[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s >= 1; --s) {
    if (d < bd[s - 1]) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (d < bd[s]) {
      bd[s] = d;
      bi[s] = j;
    }
  }
  if (d < bd[0]) {
    bd[0] = d;
    bi[0] = j;
  }
}

// grid = (ceil(Q / kBlock), S); split y covers bank rows
// [y * span, min(M, (y + 1) * span)).  Writes part_d/part_i as (S, K, Q),
// query fastest, so that both this store and the merge's loads coalesce.
template <int K>
__global__ void __launch_bounds__(kBlock)
knn_partial_kernel(const float* __restrict__ query, int Q,
                   const float* __restrict__ bank,
                   const uint8_t* __restrict__ mask, int M, int span,
                   float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  const int split = blockIdx.y;
  const int lo = split * span;
  const int hi = min(M, lo + span);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    qx = query[3 * (size_t)qi];
    qy = query[3 * (size_t)qi + 1];
    qz = query[3 * (size_t)qi + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kInf;
    bi[s] = 0;
  }

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    __syncthreads();  // every thread is done with the previous tile
    for (int r = threadIdx.x; r < n; r += kBlock) {
      const size_t j = (size_t)base + r;
      tile[r] = make_float4(bank[3 * j], bank[3 * j + 1], bank[3 * j + 2],
                            mask[j] ? 1.f : 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float4 p = tile[r];
      const float dx = p.x - qx;
      const float dy = p.y - qy;
      const float dz = p.z - qz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (p.w != 0.f) insert<K>(bd, bi, d, base + r);
    }
  }

  if (qi < Q) {
    const size_t o = (size_t)split * K * Q + qi;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[o + (size_t)s * Q] = bd[s];
      part_i[o + (size_t)s * Q] = bi[s];
    }
  }
}

// One thread per query: merge its S partial lists (in split order) into
// the final ascending best-K.
template <int K>
__global__ void __launch_bounds__(kMergeBlock)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, int Q, int S,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  const int qi = blockIdx.x * kMergeBlock + threadIdx.x;
  if (qi >= Q) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kInf;
    bi[s] = 0;
  }
#pragma unroll 4
  for (int c = 0; c < S * K; ++c) {
    const size_t o = (size_t)c * Q + qi;
    insert<K>(bd, bi, part_d[o], part_i[o]);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out_d[(size_t)qi * K + s] = bd[s];
    out_i[(size_t)qi * K + s] = bi[s];
  }
}

template <int K>
cudaError_t launch(const float* query, const float* bank, const uint8_t* mask,
                   float* part_d, int* part_i, float* out_d, int* out_i,
                   int Q, int M, int S, int span, cudaStream_t stream) {
  const dim3 grid((Q + kBlock - 1) / kBlock, S);
  knn_partial_kernel<K><<<grid, kBlock, 0, stream>>>(
      query, Q, bank, mask, M, span, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_kernel<K><<<(Q + kMergeBlock - 1) / kMergeBlock, kMergeBlock, 0,
                        stream>>>(part_d, part_i, Q, S, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

// query (Q,3) f32, bank (M,3) f32, mask (M,) bool as bytes; scratch
// part_d/part_i (S,k,Q); outputs out_d (Q,k) f32, out_i (Q,k) int32.  All
// contiguous on the current device.  Enqueues on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int lmono_knn(const void* query, const void* bank, const void* mask,
                         void* part_d, void* part_i, void* out_d, void* out_i,
                         int Q, int M, int k, int S, int span, void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* t = static_cast<const float*>(bank);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* pd = static_cast<float*>(part_d);
  int* pi = static_cast<int*>(part_i);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 0 || M <= 0 || S <= 0 || span <= 0) return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: return (int)launch<1>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    case 2: return (int)launch<2>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    case 3: return (int)launch<3>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    case 4: return (int)launch<4>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    case 5: return (int)launch<5>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    case 6: return (int)launch<6>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    case 7: return (int)launch<7>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    case 8: return (int)launch<8>(q, t, m, pd, pi, od, oi, Q, M, S, span, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
