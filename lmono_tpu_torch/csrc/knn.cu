// Exact brute-force KNN over a masked point bank, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmono_tpu/ops/pallas/knn.py:knn_pallas
// (_knn_acc_kernel) and, on this card, also the XLA approx_min_k path of
// lmono_tpu/ops/knn.py: the result is exact.  Python side:
// lmono_tpu_torch/ops/cuda/knn.py (plan, checks, launch count); plain
// PyTorch version: lmono_tpu_torch/ops/knn.py:knn_plain.
//
// Semantics: for each query, the k smallest d² = |q - t|² over bank rows
// whose mask is set, ascending, with int32 indices; ties go to the earliest
// bank index; missing entries (fewer than k valid rows) are d² = 1e12 with
// index 0.  With a centre c, q - c and t - c are formed in f32 first, as
// two torch subtractions would.
//
// What bounds it: 8 f32 operations per query-bank pair (3 subtracts,
// 3 multiplies, 2 adds; 6 instructions with the fused multiply-adds) and a
// compare; the bank is ~1 MB, so it is bound by f32 issue rate, not memory.
// K = 3 gives tensor cores nothing to do.
//
// Design, one launch per call:
//   * A thread holds R queries in registers (R = 1 or 2), each with its
//     k best (d², index) pairs, so one shared-memory read of a bank point
//     feeds R independent distance chains.  A CTA's 32·R queries are the
//     same for all its warps.
//   * The bank is cut into C·W ascending slices: the C CTAs of a thread-
//     block cluster (C <= 8) take consecutive ranges, and the W warps of
//     each CTA consecutive sub-ranges.  Each warp streams its own slice
//     through shared memory in tiles of kTileRows rows, double-buffered with
//     cp.async, so the next tile loads while the current one is scanned;
//     only __syncwarp orders a warp's tiles.
//   * When a tile has landed, each lane re-packs four of its rows into
//     float4, subtracting the centre; masked rows and rows past the slice
//     become +inf.  Their d² is inf (NaN for a non-finite query), which
//     never passes the strict < against the 1e12 start, so the scan has no
//     mask test.
//   * Inserts are what costs: a lane's sorted insert runs while the rest of
//     its warp waits, and a list restarted on every short slice inserts
//     ~k·ln(rows/k) times.  So every lane first takes, for each of its
//     queries, the least d² over the first kSampleRows rows of its warp's
//     slice (a min, no insert).  These minima come from disjoint
//     groups of rows, so the k-th smallest of them over the cluster's
//     C·W warps is an upper bound tau on each query's final k-th d²:
//     k distinct rows lie at or below it.  The warps' minima meet in shared
//     memory, the CTAs' k smallest in distributed shared memory.  The scan
//     then inserts only rows with d² <= tau (and below the lane's own
//     k-th); rows above tau cannot be among the k best, so the result is
//     unchanged.
//   * The scan takes four rows at a time: their distances, one compare
//     each against the lane's limit, and one warp vote, behind which the
//     rare inserts run in row order.  Four rows' loads and arithmetic
//     overlap, and the branch is taken by the whole warp or by none.
//   * Each lane scans its slice in ascending index order with a strict-<
//     sorted insert, so among equal d² the earlier index stays first.  The
//     warps' lists then meet in shared memory (one thread per query inserts
//     warp 1..W-1 into warp 0's list, in slice order), and rank 0 of the
//     cluster inserts ranks 1..C-1 read through distributed shared memory,
//     in rank order.  Lists are sorted by (d², index) and merged in
//     ascending range order, so the same strict < keeps the earliest index
//     on ties.  Nothing partial goes to device memory.
//
// Reduced-precision selection (select 1 "bf16x3", 2 "bf16"; the JAX
// package's LidarConfig.knn_select on its TPU route, lmono_tpu/ops/knn.py):
// the same scan, bound and merges run on the key (q² − 2·dot) + t² in
// place of d², so the result is the exact top-k of the key with ties to the
// earliest index.  q² and t² are f32 sums of the recentred coordinates
// ((x·x + y·y) + z·z); dot = (qx·tx + qy·ty) + qz·tz with every product and
// sum rounded once (no fused multiply-add), over the recentred coordinates
// for "bf16x3" and over their round-to-nearest-even bf16 values for
// "bf16": the arithmetic of ops/knn.py:select_key_topk, so the keys equal
// the plain version's bit for bit.  The packed tile holds (x, y, z, t²);
// masked rows and rows past the slice are (0, 0, 0, +inf).  After the
// cluster merge, rank 0 recomputes each pick's difference-form d² from the
// bank in device memory, in selection order.  The key modes are the
// kernel's Key instantiation, so the exact mode's scan is untouched; the
// rounding to bf16 is a flag read outside the scan.
//
// Build: the source is compiled twice (ops/cuda/knn.py), with
// LMONO_KNN_KEY=0 into a library of the exact instantiations and with
// LMONO_KNN_KEY=1 into one of the Key instantiations, so that the two
// nvcc runs proceed side by side and the first call's build takes no
// longer than one instantiation set.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef LMONO_KNN_KEY
#define LMONO_KNN_KEY 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 128;    // bank rows per warp stage
constexpr int kSampleRows = 64;   // rows per warp that bound tau
constexpr int kGroup = 4;         // rows per vote
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFar = 1e12f;

// Dynamic shared memory: per warp two raw tiles (xyz as stored), the packed
// float4 tile and its lists; then the CTA's k smallest sample minima and
// tau.
template <int K, int R>
struct Layout {
  static constexpr int kRaw = 2 * kTileRows * 3 * 4;
  static constexpr int kPacked = kTileRows * 16;
  static constexpr int kList = 32 * R * K * 8;  // d then index, query-major
  static constexpr int kWarp = kRaw + kPacked + kList;
  static constexpr int kSample = 32 * R * K * 4;
  static constexpr int kTau = 32 * R * 4;
  static constexpr size_t bytes(int warps) {
    return static_cast<size_t>(warps) * kWarp + kSample + kTau;
  }
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// Start the copy of tile `t` of the slice [lo, hi) into raw buffer t & 1,
// and return the mask bits of the lane's four rows (lane + 32·i).
__device__ __forceinline__ unsigned stage(float* raw, const float* bank,
                                          const uint8_t* mask, int lo, int hi,
                                          int t, int lane) {
  const int base = lo + t * kTileRows;
  const int n = min(kTileRows, hi - base);
  float* dst = raw + (t & 1) * (kTileRows * 3);
  const float* src = bank + 3 * static_cast<size_t>(base);
  for (int f = lane; f < 3 * n; f += 32) cp_async4(dst + f, src + f);
  cp_async_commit();
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = lane + 32 * i;
    if (r < n && mask[base + r]) bits |= 1u << i;
  }
  return bits;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (x·x + y·y) + z·z, each operation rounded once.
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Wait for tile t, then re-pack its rows minus the centre.  Exact mode:
// (x, y, z, 0), +inf for masked rows and rows past the slice.  Key mode:
// (x, y, z, t²) with x, y, z rounded to bf16 when `bf16` is set, and
// (0, 0, 0, +inf) for masked rows and rows past the slice.
template <bool Key>
__device__ __forceinline__ void land(const float* raw, float4* packed, int n,
                                     int t, unsigned bits, int lane, float cx,
                                     float cy, float cz, bool bf16) {
  cp_async_wait<1>();
  __syncwarp();
  const float* src = raw + (t & 1) * (kTileRows * 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = lane + 32 * i;
    float4 v = Key ? make_float4(0.f, 0.f, 0.f, INFINITY)
                   : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    if (r < n && ((bits >> i) & 1u)) {
      v = make_float4(__fsub_rn(src[3 * r], cx), __fsub_rn(src[3 * r + 1], cy),
                      __fsub_rn(src[3 * r + 2], cz), 0.f);
      if (Key) {
        v.w = sq_norm(v.x, v.y, v.z);
        if (bf16) {
          v.x = round_bf16(v.x);
          v.y = round_bf16(v.y);
          v.z = round_bf16(v.z);
        }
      }
    }
    packed[r] = v;
  }
  __syncwarp();
}

// d² of packed row p and the query (qx, qy, qz): the difference form.
__device__ __forceinline__ float dist2(const float4& p, float qx, float qy,
                                       float qz) {
  const float dx = __fsub_rn(p.x, qx);
  const float dy = __fsub_rn(p.y, qy);
  const float dz = __fsub_rn(p.z, qz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// The selection score of packed row p: d² in exact mode, else the key
// (q² − 2·dot) + t² with q2 = q².
template <bool Key>
__device__ __forceinline__ float score(const float4& p, float qx, float qy,
                                       float qz, float q2) {
  if (!Key) return dist2(p, qx, qy, qz);
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                              __fmul_rn(qz, p.z));
  return __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, dot)), p.w);
}

// The least score of packed rows [0, r1) for each of the lane's R queries.
template <int R, bool Key>
__device__ __forceinline__ void sample_min(const float4* packed, int r1,
                                           const float (&qx)[R],
                                           const float (&qy)[R],
                                           const float (&qz)[R],
                                           const float (&q2)[R],
                                           float (&gmin)[R]) {
#pragma unroll 4
  for (int r = 0; r < r1; ++r) {
    const float4 p = packed[r];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      gmin[j] = fminf(gmin[j], score<Key>(p, qx[j], qy[j], qz[j], q2[j]));
    }
  }
}

// Scan packed rows [r0, r1) (bank index base + r; r1 - r0 a multiple of
// kGroup, rows past the tile are +inf) for the lane's R queries.
// lim[j] = min(own k-th, tau⁺): only d < lim can change the result.
template <int K, int R, bool Key>
__device__ __forceinline__ void scan(const float4* packed, int base, int r0,
                                     int r1, const float (&qx)[R],
                                     const float (&qy)[R], const float (&qz)[R],
                                     const float (&q2)[R],
                                     float (&bd)[R][K], int (&bi)[R][K],
                                     float (&lim)[R], const float (&tau)[R]) {
  for (int r = r0; r < r1; r += kGroup) {
    float d[kGroup][R];
    bool any = false;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float4 p = packed[r + g];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        d[g][j] = score<Key>(p, qx[j], qy[j], qz[j], q2[j]);
        any |= d[g][j] < lim[j];
      }
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        bool cj = false;
#pragma unroll
        for (int g = 0; g < kGroup; ++g) cj |= d[g][j] < lim[j];
        if (cj) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            if (d[g][j] < lim[j]) {
              insert<K>(bd[j], bi[j], d[g][j], base + r + g);
              lim[j] = fminf(bd[j][K - 1], tau[j]);
            }
          }
        }
      }
    }
  }
}

// Thread q < 32R: merge the W warps' lists of query q (slice order) into
// (md, mi) and store them in warp 0's list area.
template <int K, int R>
__device__ __forceinline__ void merge_warps(unsigned char* smem, int W, int q,
                                            float (&md)[K], int (&mi)[K]) {
  using L = Layout<K, R>;
  constexpr int kOff = L::kRaw + L::kPacked;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    md[s] = reinterpret_cast<const float*>(smem + kOff)[q * K + s];
    mi[s] = reinterpret_cast<const int*>(smem + kOff + L::kList / 2)[q * K + s];
  }
  for (int w = 1; w < W; ++w) {
    const unsigned char* a = smem + w * L::kWarp + kOff;
    const float* wd = reinterpret_cast<const float*>(a);
    const int* wi = reinterpret_cast<const int*>(a + 32 * R * K * 4);
#pragma unroll
    for (int s = 0; s < K; ++s) insert<K>(md, mi, wd[q * K + s], wi[q * K + s]);
  }
}

// Store the lane's lists in its warp's list area.
template <int K, int R>
__device__ __forceinline__ void store_lists(float* ld, int* li, int lane,
                                            const float (&bd)[R][K],
                                            const int (&bi)[R][K]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int q = lane + 32 * j;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      ld[q * K + s] = bd[j][s];
      li[q * K + s] = bi[j][s];
    }
  }
}

// grid = (q_tiles · C), cluster (C, 1, 1), block 32·W threads.  CTA
// blockIdx.x has query tile blockIdx.x / C and cluster rank c; its warp w
// scans bank slice c·W + w, rows [slice·span, min(M, (slice+1)·span)).
// Key: select on the reduced key (bf16 rounds the cross term's inputs).
template <int K, int R, bool Key>
__global__ void __launch_bounds__(32 * kMaxWarps)
knn_kernel(const float* __restrict__ query, int Q,
           const float* __restrict__ bank, const uint8_t* __restrict__ mask,
           int M, const float* __restrict__ center, int span, int bf16,
           float* __restrict__ out_d, int* __restrict__ out_i) {
  using L = Layout<K, R>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int q = threadIdx.x;
  const int q0 = (blockIdx.x / C) * 32 * R;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (center != nullptr) {
    cx = center[0];
    cy = center[1];
    cz = center[2];
  }
  float qx[R], qy[R], qz[R], q2[R], lim[R], tau[R];
  float bd[R][K];
  int bi[R][K];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int qi = q0 + lane + 32 * j;
    qx[j] = qy[j] = qz[j] = 0.f;
    if (qi < Q) {
      qx[j] = __fsub_rn(query[3 * static_cast<size_t>(qi)], cx);
      qy[j] = __fsub_rn(query[3 * static_cast<size_t>(qi) + 1], cy);
      qz[j] = __fsub_rn(query[3 * static_cast<size_t>(qi) + 2], cz);
    }
    q2[j] = 0.f;
    if (Key) {
      q2[j] = sq_norm(qx[j], qy[j], qz[j]);
      if (bf16) {
        qx[j] = round_bf16(qx[j]);
        qy[j] = round_bf16(qy[j]);
        qz[j] = round_bf16(qz[j]);
      }
    }
    lim[j] = kFar;
    tau[j] = INFINITY;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[j][s] = kFar;
      bi[j][s] = 0;
    }
  }

  unsigned char* region = smem + warp * L::kWarp;
  float* raw = reinterpret_cast<float*>(region);
  float4* packed = reinterpret_cast<float4*>(region + L::kRaw);
  float* my_d = reinterpret_cast<float*>(region + L::kRaw + L::kPacked);
  int* my_i = reinterpret_cast<int*>(region + L::kRaw + L::kPacked +
                                     L::kList / 2);
  float* sample_d = reinterpret_cast<float*>(smem + W * L::kWarp);
  float* tau_s = reinterpret_cast<float*>(smem + W * L::kWarp + L::kSample);

  const long long slice = static_cast<long long>(rank) * W + warp;
  const int lo = static_cast<int>(min(static_cast<long long>(M), slice * span));
  const int hi = min(M, lo + span);
  const int tiles = (hi - lo + kTileRows - 1) / kTileRows;

  // tile 0
  unsigned next_bits = 0;
  const int n0 = tiles > 0 ? min(kTileRows, hi - lo) : 0;
  if (tiles > 0) {
    const unsigned bits = stage(raw, bank, mask, lo, hi, 0, lane);
    if (tiles > 1) {
      next_bits = stage(raw, bank, mask, lo, hi, 1, lane);
    } else {
      cp_async_commit();  // an empty group keeps the waits uniform
    }
    land<Key>(raw, packed, n0, 0, bits, lane, cx, cy, cz, bf16 != 0);
  }

  // tau: the k-th smallest of the cluster's per-warp sample minima
  float gmin[R];
#pragma unroll
  for (int j = 0; j < R; ++j) gmin[j] = INFINITY;
  sample_min<R, Key>(packed, min(n0, kSampleRows), qx, qy, qz, q2, gmin);
#pragma unroll
  for (int j = 0; j < R; ++j) my_d[lane + 32 * j] = gmin[j];
  __syncthreads();
  if (q < 32 * R) {
    float td[K];
    int ti[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      td[s] = kFar;
      ti[s] = 0;
    }
    for (int w = 0; w < W; ++w) {
      const float* wd = reinterpret_cast<const float*>(
          smem + w * L::kWarp + L::kRaw + L::kPacked);
      insert<K>(td, ti, wd[q], 0);
    }
#pragma unroll
    for (int s = 0; s < K; ++s) sample_d[q * K + s] = td[s];
  }
  cluster.sync();  // every CTA's k smallest minima are in its shared memory
  if (q < 32 * R) {
    float td[K];
    int ti[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      td[s] = kFar;
      ti[s] = 0;
    }
    for (int c = 0; c < C; ++c) {
      const float* pd = cluster.map_shared_rank(sample_d, c);
      float cd[K];
#pragma unroll
      for (int s = 0; s < K; ++s) cd[s] = pd[q * K + s];
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K>(td, ti, cd[s], 0);
    }
    // d <= tau  <=>  d < tau⁺
    tau_s[q] = nextafterf(td[K - 1], INFINITY);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    tau[j] = tau_s[lane + 32 * j];
    lim[j] = fminf(kFar, tau[j]);
  }
  scan<K, R, Key>(packed, lo, 0, (n0 + kGroup - 1) & ~(kGroup - 1), qx, qy,
                  qz, q2, bd, bi, lim, tau);
  __syncwarp();

  for (int t = 1; t < tiles; ++t) {
    const unsigned bits = next_bits;
    if (t + 1 < tiles) {
      next_bits = stage(raw, bank, mask, lo, hi, t + 1, lane);
    } else {
      cp_async_commit();
    }
    const int base = lo + t * kTileRows;
    const int n = min(kTileRows, hi - base);
    land<Key>(raw, packed, n, t, bits, lane, cx, cy, cz, bf16 != 0);
    scan<K, R, Key>(packed, base, 0, (n + kGroup - 1) & ~(kGroup - 1), qx, qy,
                    qz, q2, bd, bi, lim, tau);
    __syncwarp();
  }
  cp_async_wait<0>();

  // the warps' lists, then one thread per query merges them in slice order
  store_lists<K, R>(my_d, my_i, lane, bd, bi);
  __syncthreads();
  float md[K];
  int mi[K];
  float* list_d = reinterpret_cast<float*>(smem + L::kRaw + L::kPacked);
  int* list_i = reinterpret_cast<int*>(smem + L::kRaw + L::kPacked +
                                       L::kList / 2);
  if (q < 32 * R) {
    merge_warps<K, R>(smem, W, q, md, mi);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      list_d[q * K + s] = md[s];
      list_i[q * K + s] = mi[s];
    }
  }
  cluster.sync();  // every CTA's list is in its shared memory

  // rank 0: ranks 1..C-1 through distributed shared memory, in rank order
  if (rank == 0 && q < 32 * R) {
    for (int c = 1; c < C; ++c) {
      const float* pd = cluster.map_shared_rank(list_d, c);
      const int* pi = cluster.map_shared_rank(list_i, c);
      float cd[K];
      int ci[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        cd[s] = pd[q * K + s];
        ci[s] = pi[q * K + s];
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K>(md, mi, cd[s], ci[s]);
    }
    const int qi = q0 + q;
    if (Key && qi < Q) {
      // the picks' exact d², in selection order; missing ones stay (1e12, 0)
      const float* qp = query + 3 * static_cast<size_t>(qi);
      const float ux = __fsub_rn(qp[0], cx), uy = __fsub_rn(qp[1], cy),
                  uz = __fsub_rn(qp[2], cz);
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (md[s] < kFar) {
          const float* tp = bank + 3 * static_cast<size_t>(mi[s]);
          const float4 p = make_float4(__fsub_rn(tp[0], cx),
                                       __fsub_rn(tp[1], cy),
                                       __fsub_rn(tp[2], cz), 0.f);
          md[s] = dist2(p, ux, uy, uz);
        } else {
          md[s] = kFar;
          mi[s] = 0;
        }
      }
    }
    if (qi < Q) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_d[static_cast<size_t>(qi) * K + s] = md[s];
        out_i[static_cast<size_t>(qi) * K + s] = mi[s];
      }
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 still reads its lists
}

template <int K, int R, bool Key>
cudaError_t launch(const float* query, const float* bank, const uint8_t* mask,
                   const float* center, float* out_d, int* out_i, int Q,
                   int M, int warps, int C, int span, int bf16,
                   cudaStream_t stream) {
  const int tiles = (Q + 32 * R - 1) / (32 * R);
  const size_t smem = Layout<K, R>::bytes(warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel<K, R, Key>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, knn_kernel<K, R, Key>,
                                             query, Q, bank, mask, M, center,
                                             span, bf16, out_d, out_i);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Args {
  const float *q, *t, *c;
  const uint8_t* m;
  float* od;
  int* oi;
  int Q, M, warps, C, span, bf16;
  cudaStream_t st;
};

template <int R, bool Key>
cudaError_t dispatch_k(int k, const Args& a) {
#define LMONO_KNN_CASE(K)                                                     \
  case K:                                                                     \
    return launch<K, R, Key>(a.q, a.t, a.m, a.c, a.od, a.oi, a.Q, a.M,        \
                             a.warps, a.C, a.span, a.bf16, a.st);
  switch (k) {
    LMONO_KNN_CASE(1)
    LMONO_KNN_CASE(2)
    LMONO_KNN_CASE(3)
    LMONO_KNN_CASE(4)
    LMONO_KNN_CASE(5)
    LMONO_KNN_CASE(6)
    LMONO_KNN_CASE(7)
    LMONO_KNN_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef LMONO_KNN_CASE
}

}  // namespace

// query (Q,3) f32, bank (M,3) f32, mask (M,) bool as bytes, center (3,) f32
// or null; outputs out_d (Q,k) f32 and out_i (Q,k) int32.  All contiguous
// on the current device.  The plan (ops/cuda/knn.py:knn_plan): R queries
// per thread, `warps` warps per CTA, clusters of C CTAs, `span` bank rows
// per warp slice, with C · warps · span >= M.  select: 0 exact, 1 bf16x3,
// 2 bf16; a library built with LMONO_KNN_KEY=0 takes 0 only, one built
// with 1 takes 1 and 2.  Enqueues on `stream` without synchronising and
// returns the launch's CUDA error (0 on success).
extern "C" int lmono_knn(const void* query, const void* bank, const void* mask,
                         const void* center, void* out_d, void* out_i, int Q,
                         int M, int k, int R, int warps, int cluster, int span,
                         int select, void* stream) {
  if (Q <= 0 || M <= 0 || span <= 0 || warps < 1 || warps > kMaxWarps ||
      cluster < 1 || cluster > 8 || select < 0 || select > 2 ||
      (select != 0) != (LMONO_KNN_KEY != 0) ||
      static_cast<long long>(cluster) * warps * span < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {static_cast<const float*>(query),
                  static_cast<const float*>(bank),
                  static_cast<const float*>(center),
                  static_cast<const uint8_t*>(mask),
                  static_cast<float*>(out_d),
                  static_cast<int*>(out_i),
                  Q, M, warps, cluster, span, select == 2 ? 1 : 0,
                  static_cast<cudaStream_t>(stream)};
  constexpr bool kKey = LMONO_KNN_KEY != 0;
  switch (R) {
    case 1: return static_cast<int>(dispatch_k<1, kKey>(k, a));
    case 2: return static_cast<int>(dispatch_k<2, kKey>(k, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
