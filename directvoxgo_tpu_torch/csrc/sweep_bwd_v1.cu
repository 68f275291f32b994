// FIRST VERSION of kernel K-C, kept unchanged beside its redesign
// (sweep_bwd.cu) as the yardstick that chip_smoke.py times it against. The
// port never loads it.
//
// Station-sweep backward: the grid cotangent of the bilinear station taps.
//
// Replaces: directvoxgo_tpu/ops/pallas_sweep_train.py::sweep_bwd_pallas +
// fold_bwd_partials, and the XLA streamed transposes of
// directvoxgo_tpu/ops/sweep.py::_sweep_bwd (full, segment and per-tile
// windowed forms) that the Pallas kernel stands in for.
//
// For ray n at station s = z*k + j (axis coordinate p = s/k, f = j/k), with
// (u, v) exactly as the forward kernel computes them:
//   x[iu, iv, c] = wu(u, iu) * rnd(wv(v, iv) * g[s, c, n])
//   acc[z,   iu, iv, c] += (1 - f) * x
//   acc[z+1, iu, iv, c] += f * x          (j > 0 only)
// wu is rounded to the interp dtype and rnd() rounds the product to it (bf16
// sweeps; nothing is rounded in f32 sweeps), the products and the sum over
// rays are f32: the rounding points of the JAX backward. Taps off the slab,
// or outside the ray tile's v-window [vb, vb + wv) when windowed, add
// nothing; neither do zero cotangents or zero weights, so a voxel no ray
// touches stays exactly 0 in the zero-filled accumulator.
//
// Bound on the H100: the TPU version contracts dense [N, Gu] x [N, Gv*C]
// hat rows per station because scatters are slow there; here each (ray,
// station) has four nonzero taps, so the natural form is a scatter-add of C
// values per tap. The bytes it must move are the cotangent [S, C, N] f32
// once plus the touched voxels once; its operations are far below the FMA
// rate. Most cotangents are exactly zero (masked weights, top-K selection),
// so a thread reads its C values (coalesced over rays) and leaves before
// any atomic when they all vanish. What remains is bound by the rate of f32
// atomics into L2, not by bytes. The order of those atomics varies from run
// to run, so the sums differ in their last bits between runs.
// Design: one thread per ray looping over a block of S_BLK stations
// (blockIdx.y), like the forward kernel; red.global.add.f32 per tap value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid_scatter.cuh"

namespace {

using dvgo::hat;
using dvgo::round_bf16;

constexpr int C_MAX = 16;
constexpr int THREADS = 128;
constexpr int S_BLK = 8;

// window_mode: 0 = no window, 1 = v_base[ray / tile_n], 2 = v_base[seg_idx]
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
sweep_bwd_kernel(const float* __restrict__ g, const float* __restrict__ rays,
                 const int* __restrict__ v_base, float* __restrict__ acc,
                 int n, int s_total, int gu, int gv, int c, int k, int wv,
                 int window_mode, int tile_n, int seg_idx) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n) return;
  const float op = rays[r], ou = rays[n + r], ov = rays[2 * n + r];
  const float dp = rays[3 * n + r], du = rays[4 * n + r],
              dv = rays[5 * n + r];
  int v_lo = 0, v_hi = gv;
  if (window_mode == 1) v_lo = v_base[r / tile_n];
  if (window_mode == 2) v_lo = v_base[seg_idx];
  if (window_mode != 0) v_hi = min(v_lo + wv, gv);
  const float inv_k = 1.f / (float)k;
  const int s0 = blockIdx.y * S_BLK;
  const int s1 = min(s0 + S_BLK, s_total);
  const size_t slab_elems = (size_t)gu * gv * c;
  for (int s = s0; s < s1; ++s) {
    // Coordinates exactly as sweep_fwd.cu computes them.
    const float t = __fdiv_rn(__fsub_rn(__fmul_rn((float)s, inv_k), op), dp);
    const float u = __fmaf_rn(t, du, ou);
    const float v = __fmaf_rn(t, dv, ov);
    if (!(u > -1.f && u < (float)gu && v > -1.f && v < (float)gv)) continue;
    float gs[C_MAX];
    bool any = false;
    const float* gp_ = g + (size_t)s * c * n + r;
#pragma unroll
    for (int ch = 0; ch < C_MAX; ++ch) {
      gs[ch] = ch < c ? gp_[(size_t)ch * n] : 0.f;
      any = any || gs[ch] != 0.f;
    }
    if (!any) continue;
    const dvgo::SlabSplit sp = dvgo::slab_split(s, k);
    const int iu0 = (int)floorf(u), iv0 = (int)floorf(v);
    float* slab_lo = acc + (size_t)sp.z * slab_elems;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int iu = iu0 + a;
      if (iu < 0 || iu >= gu) continue;
      float wu = hat(u, iu);
      if (BF16) wu = round_bf16(wu);
      if (wu == 0.f) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int iv = iv0 + b;
        if (iv < v_lo || iv >= v_hi) continue;
        const float wvv = hat(v, iv);
        if (wvv == 0.f) continue;
        float* px = slab_lo + ((size_t)iu * gv + iv) * c;
#pragma unroll
        for (int ch = 0; ch < C_MAX; ++ch) {
          if (ch >= c || gs[ch] == 0.f) continue;
          dvgo::scatter_tap<BF16>(px + ch, slab_elems, sp, wu, wvv, gs[ch]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dvgo_sweep_bwd_max_channels() { return C_MAX; }

// g [S, C, N] f32 station cotangents, rays [6, N] f32 rows (op, ou, ov, dp,
// du, dv) with dp != 0, acc [Gp, Gu, Gv, C] f32 ZERO-FILLED by the caller,
// S = k*(Gp-1)+1. window_mode 0: full transpose (v_base unused); 1: ray r
// counts only v-taps in [v_base[r / tile_n], +wv); 2: every ray counts only
// v-taps in [v_base[seg_idx], +wv).
int dvgo_sweep_bwd(const float* g, const float* rays, const int* v_base,
                   float* acc, int n, int s_total, int gu, int gv, int c,
                   int k, int interp_is_bf16, int wv, int window_mode,
                   int tile_n, int seg_idx, void* stream) {
  if (c < 1 || c > C_MAX || n < 1 || s_total < 1 || k < 1 ||
      (s_total - 1) % k != 0 || window_mode < 0 || window_mode > 2 ||
      (window_mode != 0 && (v_base == nullptr || wv < 1 || tile_n < 1)))
    return cudaErrorInvalidValue;
  dim3 grid((n + THREADS - 1) / THREADS, (s_total + S_BLK - 1) / S_BLK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (interp_is_bf16)
    sweep_bwd_kernel<true><<<grid, THREADS, 0, st>>>(
        g, rays, v_base, acc, n, s_total, gu, gv, c, k, wv, window_mode,
        tile_n, seg_idx);
  else
    sweep_bwd_kernel<false><<<grid, THREADS, 0, st>>>(
        g, rays, v_base, acc, n, s_total, gu, gv, c, k, wv, window_mode,
        tile_n, seg_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
