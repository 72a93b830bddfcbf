// Translational Lucas–Kanade on one pyramid level, for Hopper (sm_90a).
//
// Replaces the TPU kernel lmono_tpu/ops/pallas/lk.py:lk_level_pallas
// (_lk_kernel), and on this card also the vmapped
// lmono_tpu/ops/lk.py:lk_level that the reference runs on levels narrower
// than 128 px.  Python side: lmono_tpu_torch/ops/cuda/lk.py (build, checks,
// launch count); plain PyTorch version: lmono_tpu_torch/ops/lk.py:
// lk_level_plain.
//
// Semantics, per feature slot: sample a P×P template and its Scharr
// gradients bilinearly at pt0 in img0/ix0/iy0, form the 2×2 normal matrix,
// then run `iters` Gauss–Newton updates of the position, starting at the
// guess and sampling img1.  Two variants, chosen by a template parameter:
//   * kPallas (the TPU kernel): the patch is read from a (P+1)² slab whose
//     integer base is clamped into [0, W-P-1] × [0, H-P-1]; at a border the
//     fractional offset leaves [0, 1) and the bilinear weights extrapolate,
//     as in the TPU kernel.  inv_det = 1 / (|det| < 1e-12 ? 1e-12 : det);
//     ok = det > 1e-6, last step < 0.1 and 1 < x < W-2, 1 < y < H-2.
//   * !kPallas (the reference's vmapped path): each sample coordinate is
//     clipped on its own to [0, W-1.001] × [0, H-1.001]; the inverse is
//     zero unless det > 1e-6; ok = det > 1e-6 and last step < step_thresh.
// Float → int conversions follow XLA's rule (NaN → 0, saturation), which
// diverged slots reach.  The row/lane padding and the roll-based slab loads
// of the TPU kernel exist only for Mosaic and have no counterpart here.
//
// What bounds it: latency, not throughput.  A frame has 150 slots, so a
// launch is 150 warps; each runs iters dependent rounds of P² bilinear
// samples (4 loads each, mostly L1/L2 hits: a 1241×376 level is 1.9 MB) and
// two warp reductions.  The work is ~2 MFLOP per launch.
//
// Design: one warp per slot, kWarps slots per block.  Each lane keeps its
// ceil(P²/32) template and gradient pixels in registers for all
// iterations; the three normal-matrix sums and the two residual sums are
// reduced with an xor butterfly, which leaves the same bits in every lane,
// so every lane carries the same position and no broadcast is needed.  The
// per-slot scalar math (det, inverse, update) uses the _rn intrinsics, so
// that it is not contracted into FMAs and rounds as the plain version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

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

// Bilinear blend of the 2×2 block whose top-left pixel is p.
__device__ __forceinline__ float blend(const float* __restrict__ p, int W,
                                       float fx, float fy) {
  const float tl = __ldg(p), tr = __ldg(p + 1);
  const float bl = __ldg(p + W), br = __ldg(p + W + 1);
  const float top = tl + fx * (tr - tl);
  const float bot = bl + fx * (br - bl);
  return top + fy * (bot - top);
}

// Where one patch is sampled: for kPallas the clamped slab base and its
// fractional offset; otherwise the patch centre and the clip bounds.
struct Anchor {
  int bx, by;
  float fx, fy, x, y, xmax, ymax;
};

template <bool kPallas>
__device__ __forceinline__ Anchor anchor(float x, float y, int H, int W,
                                         int P) {
  Anchor a = {0, 0, 0.f, 0.f, x, y, 0.f, 0.f};
  if (!kPallas) {
    // W - 1.001 in double, then rounded to f32, as the reference's clip
    a.xmax = __double2float_rn((double)W - 1.001);
    a.ymax = __double2float_rn((double)H - 1.001);
  } else {
    const float r = (P - 1) * 0.5f;
    const float xr = x - r, yr = y - r;
    a.bx = min(max(xla_f2i(floorf(xr)), 0), W - P - 1);
    a.by = min(max(xla_f2i(floorf(yr)), 0), H - P - 1);
    a.fx = xr - (float)a.bx;
    a.fy = yr - (float)a.by;
  }
  return a;
}

// Patch pixel (row, col) of img at anchor a.
template <bool kPallas>
__device__ __forceinline__ float sample(const float* __restrict__ img, int H,
                                        int W, int P, const Anchor& a,
                                        int row, int col) {
  if (kPallas) {
    return blend(img + (a.by + row) * W + a.bx + col, W, a.fx, a.fy);
  }
  const int r = P / 2;
  const float x = clip_nan(a.x + (float)(col - r), 0.f, a.xmax);
  const float y = clip_nan(a.y + (float)(row - r), 0.f, a.ymax);
  const int x0 = xla_f2i(floorf(x));
  const int y0 = xla_f2i(floorf(y));
  return blend(img + y0 * W + x0, W, x - (float)x0, y - (float)y0);
}

template <bool kPallas, int kPer>
__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ img0, const float* __restrict__ ix0,
                const float* __restrict__ iy0, const float* __restrict__ img1,
                int H, int W, const float* __restrict__ pts0,
                const float* __restrict__ guess, int N, int P, int iters,
                float step_thresh, float* __restrict__ pt1,
                uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= N) return;  // the whole warp leaves together
  const int PP = P * P;

  // template and gradients at pt0, kept in registers
  const Anchor a0 = anchor<kPallas>(pts0[2 * slot], pts0[2 * slot + 1], H, W, P);
  float t[kPer], gx[kPer], gy[kPer];
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = k * 32 + lane;
    t[k] = gx[k] = gy[k] = 0.f;
    if (p < PP) {
      const int row = p / P, col = p - row * P;
      t[k] = sample<kPallas>(img0, H, W, P, a0, row, col);
      gx[k] = sample<kPallas>(ix0, H, W, P, a0, row, col);
      gy[k] = sample<kPallas>(iy0, H, W, P, a0, row, col);
      sxx += gx[k] * gx[k];
      sxy += gx[k] * gy[k];
      syy += gy[k] * gy[k];
    }
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const bool ok_g = det > 1e-6f;
  float i00, i01, i11;
  if (kPallas) {
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

  float xf = guess[2 * slot], yf = guess[2 * slot + 1], step = 0.f;
  for (int it = 0; it < iters; ++it) {
    const Anchor a = anchor<kPallas>(xf, yf, H, W, P);
    float bx = 0.f, by = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = k * 32 + lane;
      if (p < PP) {
        const int row = p / P, col = p - row * P;
        const float e = sample<kPallas>(img1, H, W, P, a, row, col) - t[k];
        bx += e * gx[k];
        by += e * gy[k];
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float dx = __fadd_rn(__fmul_rn(i00, bx), __fmul_rn(i01, by));
    const float dy = __fadd_rn(__fmul_rn(i01, bx), __fmul_rn(i11, by));
    xf = __fsub_rn(xf, dx);
    yf = __fsub_rn(yf, dy);
    step = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  }

  if (lane == 0) {
    bool good = ok_g && step < step_thresh;
    if (kPallas) {
      good = good && xf > 1.f && xf < (float)(W - 2) && yf > 1.f &&
             yf < (float)(H - 2);
    }
    pt1[2 * slot] = xf;
    pt1[2 * slot + 1] = yf;
    ok[slot] = good ? 1 : 0;
  }
}

template <bool kPallas, int kPer>
cudaError_t launch(const float* img0, const float* ix0, const float* iy0,
                   const float* img1, int H, int W, const float* pts0,
                   const float* guess, int N, int P, int iters,
                   float step_thresh, float* pt1, uint8_t* ok,
                   cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  lk_level_kernel<kPallas, kPer><<<blocks, kThreads, 0, stream>>>(
      img0, ix0, iy0, img1, H, W, pts0, guess, N, P, iters, step_thresh, pt1,
      ok);
  return cudaGetLastError();
}

template <bool kPallas>
cudaError_t dispatch(const float* img0, const float* ix0, const float* iy0,
                     const float* img1, int H, int W, const float* pts0,
                     const float* guess, int N, int P, int iters,
                     float step_thresh, float* pt1, uint8_t* ok,
                     cudaStream_t stream) {
  const int per = (P * P + 31) / 32;
#define LMONO_LK_CASE(K)                                                     \
  if (per <= K)                                                              \
    return launch<kPallas, K>(img0, ix0, iy0, img1, H, W, pts0, guess, N, P, \
                              iters, step_thresh, pt1, ok, stream);
  LMONO_LK_CASE(2)
  LMONO_LK_CASE(4)
  LMONO_LK_CASE(8)
  LMONO_LK_CASE(16)
  LMONO_LK_CASE(32)
#undef LMONO_LK_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// img0, ix0, iy0, img1 (H,W) f32; pts0, guess (N,2) f32 in this level's
// pixels; outputs pt1 (N,2) f32 and ok (N,) bool as bytes.  All contiguous
// on the current device.  pallas != 0 picks the TPU kernel's semantics,
// which need H, W >= P + 1.  Enqueues on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int lmono_lk_level(const void* img0, const void* ix0,
                              const void* iy0, const void* img1, int H, int W,
                              const void* pts0, const void* guess, int N,
                              int P, int iters, float step_thresh, int pallas,
                              void* pt1, void* ok, void* stream) {
  if (N <= 0 || P < 1 || P > 32 || iters < 0 || H < 2 || W < 2)
    return (int)cudaErrorInvalidValue;
  if (pallas && (H < P + 1 || W < P + 1)) return (int)cudaErrorInvalidValue;
  const float* i0 = static_cast<const float*>(img0);
  const float* gx = static_cast<const float*>(ix0);
  const float* gy = static_cast<const float*>(iy0);
  const float* i1 = static_cast<const float*>(img1);
  const float* p0 = static_cast<const float*>(pts0);
  const float* g = static_cast<const float*>(guess);
  float* out = static_cast<float*>(pt1);
  uint8_t* o = static_cast<uint8_t*>(ok);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pallas)
    return (int)dispatch<true>(i0, gx, gy, i1, H, W, p0, g, N, P, iters,
                               step_thresh, out, o, st);
  return (int)dispatch<false>(i0, gx, gy, i1, H, W, p0, g, N, P, iters,
                              step_thresh, out, o, st);
}
