// Pyramidal translational Lucas–Kanade with the forward-backward pass, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lmono_tpu/ops/pallas/lk.py:lk_level_pallas
// (_lk_kernel), called once per pyramid level and direction by
// lmono_tpu/ops/lk.py:track_fb, and on this card also the vmapped
// lmono_tpu/ops/lk.py:lk_level that the reference runs on levels narrower
// than 128 px.  Python side: lmono_tpu_torch/ops/cuda/lk.py (level table,
// checks, launch count); plain PyTorch version: lmono_tpu_torch/ops/lk.py:
// track_fb_plain, a chain of lk_level_plain.
//
// Semantics, per feature slot and level: sample a P×P template and its
// Scharr gradients bilinearly at pt0 in the template frame, form the 2×2
// normal matrix, then run `iters` Gauss–Newton updates of the position,
// starting at the guess and sampling the other frame.  Two variants, picked
// per level (the level table's `pallas` flag):
//   * the TPU kernel's: the patch is read from a (P+1)² slab whose integer
//     base is clamped into [0, W-P-1] × [0, H-P-1]; at a border the
//     fractional offset leaves [0, 1) and the bilinear weights extrapolate.
//     inv_det = 1 / (|det| < 1e-12 ? 1e-12 : det); ok = det > 1e-6, last
//     step < its gate and 1 < x < W-2, 1 < y < H-2;
//   * the reference's vmapped one: each sample coordinate is clipped on its
//     own to [0, W-1.001] × [0, H-1.001]; the inverse is zero unless
//     det > 1e-6; ok = det > 1e-6 and last step < its gate.
// Levels run coarse to fine: the level-l point is pt0 · 2^-l, the first
// guess pt0 · 2^-(L-1), and a level's result times 2 is the next guess;
// scaling by powers of two is exact, so the chain rounds as a chain of
// single-level calls does.  ok carries the mask, every level's ok and the
// final in-bounds test on level 0.  The backward pass runs the same chain
// from pt1 with ok1 as its mask, the frames swapped.  Float → int
// conversions follow XLA's rule (NaN → 0, saturation), which diverged slots
// reach.
//
// What bounds it: latency.  A slot's chain is 2 · L · iters dependent
// rounds (80 at the KITTI pyramid), each a slab read and a block-wide sum;
// the bytes (per slot and level at most 6 distinct (P+1)² slabs: the three
// template arrays of each frame, whose slabs the other direction samples)
// and flops (~50 M at the KITTI pyramid) of a call are a microsecond's
// worth.
//
// Design: one block of 128 threads per slot runs the whole forward and
// backward chain, all levels, in one launch.  Each thread owns ≤ kPer patch
// pixels, whose row and column are computed once per launch, and keeps
// their template and gradients in registers for a level.  On a TPU-
// semantics level each iteration stages the clamped (P+1)² slab of the
// sampled frame in shared memory (a few coalesced loads per thread) and
// blends from there; a vmapped level reads through L1.  The sums go through
// an xor butterfly in each warp and then the warp sums are added in one
// fixed order by every thread, so every thread carries the same bits and
// the per-slot scalar math (_rn intrinsics, not contracted into FMAs) needs
// no broadcast.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxPatch = 32;
constexpr int kMaxSlab = (kMaxPatch + 1) * (kMaxPatch + 1);
constexpr unsigned kFull = 0xffffffffu;

struct Level {
  const float* img[2];  // frame 0 and frame 1 at this level
  const float* gx[2];   // their Scharr gradients (the template frame's only)
  const float* gy[2];
  int H, W, pallas;
};

// Passed by value: no device allocation and no copy per call.
struct Params {
  Level lev[kMaxLevels];
  int L, N, P, iters;
  float pallas_thresh, xla_thresh;  // last-step gates of the two semantics
  const float* pts0;    // (N,2) in level-0 pixels
  const float* guess;   // (N,2) guess at level L-1, or null: pts0·2^-(L-1)
  const uint8_t* mask;  // (N,) or null (every slot set)
  int backward;         // also track pt1 from frame 1 back to frame 0
  int inb;              // apply the in-bounds test on level 0 at the end
  float* pt1;
  uint8_t* ok1;
  float* back;
  uint8_t* ok2;
};

// f32 -> int32 as XLA converts: NaN -> 0, saturation, else toward zero.
__device__ __forceinline__ int xla_f2i(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.f) return 2147483647;
  if (x < -2147483648.f) return -2147483647 - 1;
  return (int)x;
}

// jnp.clip: NaN passes through (fminf/fmaxf would drop it).
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Block-wide sums of NV values; every thread gets the same bits.  `buf`
// alternates between two halves (call parity), so that one barrier per
// call suffices.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV],
                                          float (*buf)[kWarps][3],
                                          int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  float (*b)[3] = buf[parity];
  parity ^= 1;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) b[warp][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = b[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, b[w][i]);
    v[i] = s;
  }
}

// Bilinear blend of the 2×2 block whose top-left pixel is p (row stride W).
__device__ __forceinline__ float blend(const float* __restrict__ p, int W,
                                       float fx, float fy) {
  const float tl = __ldg(p), tr = __ldg(p + 1);
  const float bl = __ldg(p + W), br = __ldg(p + W + 1);
  const float top = tl + fx * (tr - tl);
  const float bot = bl + fx * (br - bl);
  return top + fy * (bot - top);
}

// The same blend from the shared slab (row stride S).
__device__ __forceinline__ float blend_smem(const float* p, int S, float fx,
                                            float fy) {
  const float tl = p[0], tr = p[1], bl = p[S], br = p[S + 1];
  const float top = tl + fx * (tr - tl);
  const float bot = bl + fx * (br - bl);
  return top + fy * (bot - top);
}

// The TPU kernel's clamped slab base and fractional offset at (x, y).
struct Slab {
  int bx, by;
  float fx, fy;
};

__device__ __forceinline__ Slab slab_at(float x, float y, int H, int W,
                                        int P) {
  const float r = (P - 1) * 0.5f;
  const float xr = x - r, yr = y - r;
  Slab s;
  s.bx = min(max(xla_f2i(floorf(xr)), 0), W - P - 1);
  s.by = min(max(xla_f2i(floorf(yr)), 0), H - P - 1);
  s.fx = xr - (float)s.bx;
  s.fy = yr - (float)s.by;
  return s;
}

// The vmapped reference's sample at (x, y), each coordinate clipped on
// its own.
__device__ __forceinline__ float sample_clip(const float* __restrict__ img,
                                             int W, float x, float y,
                                             float xmax, float ymax) {
  x = clip_nan(x, 0.f, xmax);
  y = clip_nan(y, 0.f, ymax);
  const int x0 = xla_f2i(floorf(x));
  const int y0 = xla_f2i(floorf(y));
  return blend(img + y0 * W + x0, W, x - (float)x0, y - (float)y0);
}

// This thread's share of the patch and of the slab, fixed for the launch.
template <int kPer>
struct Share {
  int row[kPer], col[kPer];       // patch pixel k*kThreads + tid
  bool pix[kPer];
  int srow[kPer + 1], scol[kPer + 1];  // slab element k*kThreads + tid
  bool stg[kPer + 1];
};

struct Shared {
  float slab[kMaxSlab];
  float red[2][kWarps][3];
};

// One LK level of this block's slot: the template at (x0, y0) in frame
// `tf`, Gauss–Newton from (xf, yf) in frame 1 - tf.  Every thread returns
// the same (xf, yf) and conv.
template <int kPer>
__device__ __forceinline__ void lk_level(const Params& p, const Level& lv,
                                         int tf, float x0, float y0, float& xf,
                                         float& yf, bool& conv,
                                         const Share<kPer>& sh, Shared& smem,
                                         int& parity) {
  const int H = lv.H, W = lv.W, P = p.P, S = P + 1;
  const bool pallas = lv.pallas != 0;
  const float* img0 = lv.img[tf];
  const float* ix0 = lv.gx[tf];
  const float* iy0 = lv.gy[tf];
  const float* img1 = lv.img[1 - tf];
  const int r = P / 2;
  // W - 1.001 in double, then rounded to f32, as the reference's clip
  const float xmax = __double2float_rn((double)W - 1.001);
  const float ymax = __double2float_rn((double)H - 1.001);

  float t[kPer], gx[kPer], gy[kPer];
  float sums[3] = {0.f, 0.f, 0.f};
  const Slab a0 = slab_at(x0, y0, H, W, P);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    t[k] = gx[k] = gy[k] = 0.f;
    if (sh.pix[k]) {
      if (pallas) {
        const int o = (a0.by + sh.row[k]) * W + a0.bx + sh.col[k];
        t[k] = blend(img0 + o, W, a0.fx, a0.fy);
        gx[k] = blend(ix0 + o, W, a0.fx, a0.fy);
        gy[k] = blend(iy0 + o, W, a0.fx, a0.fy);
      } else {
        const float x = x0 + (float)(sh.col[k] - r);
        const float y = y0 + (float)(sh.row[k] - r);
        t[k] = sample_clip(img0, W, x, y, xmax, ymax);
        gx[k] = sample_clip(ix0, W, x, y, xmax, ymax);
        gy[k] = sample_clip(iy0, W, x, y, xmax, ymax);
      }
      sums[0] += gx[k] * gx[k];
      sums[1] += gx[k] * gy[k];
      sums[2] += gy[k] * gy[k];
    }
  }
  block_sum<3>(sums, smem.red, parity);
  const float gxx = sums[0], gxy = sums[1], gyy = sums[2];
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const bool ok_g = det > 1e-6f;
  float i00, i01, i11;
  if (pallas) {
    const float inv_det = __fdiv_rn(1.f, fabsf(det) < 1e-12f ? 1e-12f : det);
    i00 = __fmul_rn(gyy, inv_det);
    i01 = __fmul_rn(-gxy, inv_det);
    i11 = __fmul_rn(gxx, inv_det);
  } else {
    // where(det > 1e-6, · / max(det, 1e-12), 0): the max is det itself
    i00 = ok_g ? __fdiv_rn(gyy, det) : 0.f;
    i01 = ok_g ? __fdiv_rn(-gxy, det) : 0.f;
    i11 = ok_g ? __fdiv_rn(gxx, det) : 0.f;
  }

  // slab element offsets in this level's rows
  int goff[kPer + 1];
#pragma unroll
  for (int k = 0; k < kPer + 1; ++k) goff[k] = sh.srow[k] * W + sh.scol[k];

  float step = 0.f;
  for (int it = 0; it < p.iters; ++it) {
    float b[2] = {0.f, 0.f};
    if (pallas) {
      const Slab a = slab_at(xf, yf, H, W, P);
      const float* src = img1 + a.by * W + a.bx;
#pragma unroll
      for (int k = 0; k < kPer + 1; ++k) {
        if (sh.stg[k]) {
          smem.slab[sh.srow[k] * S + sh.scol[k]] = __ldg(src + goff[k]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (sh.pix[k]) {
          const float v = blend_smem(smem.slab + sh.row[k] * S + sh.col[k], S,
                                     a.fx, a.fy);
          const float e = v - t[k];
          b[0] += e * gx[k];
          b[1] += e * gy[k];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (sh.pix[k]) {
          const float v = sample_clip(img1, W, xf + (float)(sh.col[k] - r),
                                      yf + (float)(sh.row[k] - r), xmax, ymax);
          const float e = v - t[k];
          b[0] += e * gx[k];
          b[1] += e * gy[k];
        }
      }
    }
    // the slab is read before this barrier and next written after it
    block_sum<2>(b, smem.red, parity);
    const float dx = __fadd_rn(__fmul_rn(i00, b[0]), __fmul_rn(i01, b[1]));
    const float dy = __fadd_rn(__fmul_rn(i01, b[0]), __fmul_rn(i11, b[1]));
    xf = __fsub_rn(xf, dx);
    yf = __fsub_rn(yf, dy);
    step = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  }

  conv = ok_g;
  if (pallas) {
    conv = conv && step < p.pallas_thresh && xf > 1.f &&
           xf < (float)(W - 2) && yf > 1.f && yf < (float)(H - 2);
  } else {
    conv = conv && step < p.xla_thresh;
  }
}

// Coarse to fine from pt0 (level-0 pixels) with the template in frame tf.
template <int kPer>
__device__ __forceinline__ void chain(const Params& p, int tf, float x0,
                                      float y0, float gx, float gy, bool& ok,
                                      float& xo, float& yo,
                                      const Share<kPer>& sh, Shared& smem,
                                      int& parity) {
  for (int lvl = p.L - 1; lvl >= 0; --lvl) {
    const float s = ldexpf(1.f, -lvl);
    bool conv;
    lk_level<kPer>(p, p.lev[lvl], tf, x0 * s, y0 * s, gx, gy, conv, sh,
                   smem, parity);
    ok = ok && conv;
    if (lvl > 0) {
      gx = gx * 2.f;
      gy = gy * 2.f;
    }
  }
  if (p.inb) {
    const int H = p.lev[0].H, W = p.lev[0].W;
    ok = ok && gx > 1.f && gx < (float)(W - 2) && gy > 1.f &&
         gy < (float)(H - 2);
  }
  xo = gx;
  yo = gy;
}

template <int kPer>
__global__ void __launch_bounds__(kThreads)
lk_kernel(const __grid_constant__ Params p) {
  __shared__ Shared smem;
  const int slot = blockIdx.x;
  const int P = p.P, S = P + 1;
  Share<kPer> sh;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = k * kThreads + threadIdx.x;
    sh.pix[k] = e < P * P;
    sh.row[k] = e / P;
    sh.col[k] = e - sh.row[k] * P;
  }
#pragma unroll
  for (int k = 0; k < kPer + 1; ++k) {
    const int e = k * kThreads + threadIdx.x;
    sh.stg[k] = e < S * S;
    sh.srow[k] = e / S;
    sh.scol[k] = e - sh.srow[k] * S;
  }
  int parity = 0;

  const float x0 = p.pts0[2 * slot], y0 = p.pts0[2 * slot + 1];
  const float s = ldexpf(1.f, -(p.L - 1));
  float gx = x0 * s, gy = y0 * s;
  if (p.guess != nullptr) {
    gx = p.guess[2 * slot];
    gy = p.guess[2 * slot + 1];
  }
  bool ok = p.mask == nullptr || p.mask[slot] != 0;
  float x1, y1;
  chain<kPer>(p, 0, x0, y0, gx, gy, ok, x1, y1, sh, smem, parity);
  if (threadIdx.x == 0) {
    p.pt1[2 * slot] = x1;
    p.pt1[2 * slot + 1] = y1;
    p.ok1[slot] = ok ? 1 : 0;
  }
  if (p.backward) {
    float xb, yb;
    chain<kPer>(p, 1, x1, y1, x1 * s, y1 * s, ok, xb, yb, sh, smem, parity);
    if (threadIdx.x == 0) {
      p.back[2 * slot] = xb;
      p.back[2 * slot + 1] = yb;
      p.ok2[slot] = ok ? 1 : 0;
    }
  }
}

}  // namespace

// images: L × 6 pointers per level l (level 0 the finest): frame 0's
// image, x and y gradients, then frame 1's (frame 1's gradients may be null
// unless backward); shapes: L × 3 ints per level: H, W and 1 for the TPU
// kernel's semantics (needs H, W >= P + 1) or 0 for the vmapped one.
// pts0 (N,2) f32 in level-0 pixels; guess (N,2) f32 at level L-1 or null;
// mask (N,) bool as bytes or null.  Outputs pt1 (N,2) f32 and ok1 (N,),
// and with backward != 0 also back (N,2) and ok2 (N,).  All contiguous on
// the current device.  Enqueues one launch on `stream` without
// synchronising and returns the launch's CUDA error (0 on success).
extern "C" int lmono_lk(const void* const* images, const int* shapes, int L,
                        const void* pts0, const void* guess, const void* mask,
                        int N, int P, int iters, float pallas_thresh,
                        float xla_thresh, int backward, int inb, void* pt1,
                        void* ok1, void* back, void* ok2, void* stream) {
  if (L < 1 || L > kMaxLevels || N <= 0 || P < 1 || P > kMaxPatch ||
      iters < 0)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  for (int l = 0; l < L; ++l) {
    Level& lv = p.lev[l];
    for (int f = 0; f < 2; ++f) {
      lv.img[f] = static_cast<const float*>(images[6 * l + 3 * f]);
      lv.gx[f] = static_cast<const float*>(images[6 * l + 3 * f + 1]);
      lv.gy[f] = static_cast<const float*>(images[6 * l + 3 * f + 2]);
    }
    lv.H = shapes[3 * l];
    lv.W = shapes[3 * l + 1];
    lv.pallas = shapes[3 * l + 2];
    if (lv.H < 2 || lv.W < 2) return (int)cudaErrorInvalidValue;
    if (lv.pallas && (lv.H < P + 1 || lv.W < P + 1))
      return (int)cudaErrorInvalidValue;
    if (backward && (lv.gx[1] == nullptr || lv.gy[1] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  p.L = L;
  p.N = N;
  p.P = P;
  p.iters = iters;
  p.pallas_thresh = pallas_thresh;
  p.xla_thresh = xla_thresh;
  p.pts0 = static_cast<const float*>(pts0);
  p.guess = static_cast<const float*>(guess);
  p.mask = static_cast<const uint8_t*>(mask);
  p.backward = backward;
  p.inb = inb;
  p.pt1 = static_cast<float*>(pt1);
  p.ok1 = static_cast<uint8_t*>(ok1);
  p.back = static_cast<float*>(back);
  p.ok2 = static_cast<uint8_t*>(ok2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (P * P + kThreads - 1) / kThreads;
  if (per <= 2) {
    lk_kernel<2><<<N, kThreads, 0, st>>>(p);
  } else if (per <= 4) {
    lk_kernel<4><<<N, kThreads, 0, st>>>(p);
  } else {
    lk_kernel<8><<<N, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
