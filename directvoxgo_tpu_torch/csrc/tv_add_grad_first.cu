// Total-variation stencil plus gradient add (kernel K-F).
//
// Replaces: directvoxgo_tpu/ops/tv.py::_tv_rows_pallas (and the jnp
// total_variation_add_grad / boxed tv_term path of the JAX engine).
//
// For each element of a box of an f32 grid p [X, Y, Z, C] (channels
// independent; C = 1 for a [X, Y, Z] grid) whose gradient is g [bx, by, bz,
// C] (any strides: autograd hands over channel slices of a stacked grid's
// gradient):
//   tv  = wx*(cl(p - p[x+1]) + cl(p - p[x-1]))
//       + wy*(cl(p - p[y+1]) + cl(p - p[y-1]))
//       + wz*(cl(p - p[z+1]) + cl(p - p[z-1])),   cl = clamp to [-1, 1]
//   out = g + (dense || g != 0 ? tv : 0)
// Neighbours come from the whole grid, edge-replicated at the grid border
// only (self - self = 0 there), so the box's border voxels see their true
// neighbours. The weights arrive already divided by 6, with the x-axis
// weight chosen by the caller (wz under bug_compat). Every product and sum
// is rounded as the plain PyTorch version rounds it (no fused
// multiply-add), term by term in the same order, so the two agree bit for
// bit and a gated element comes out as g + 0 exactly, the zero that
// MaskedAdam's skip_zero_grad keys on.
//
// Bound on the H100: about 25 flops per element against 12 bytes (p, g,
// out), so it is bound by memory traffic. The bytes it must move are g and
// out once and p once over the box and its 1-voxel halo (in sparse mode only
// where g != 0 and their neighbours). Design: one thread per element, the
// flat index over the box in memory order, so out and p's own row are
// coalesced and g's reads follow its strides through the same lines; the
// z and y neighbours lie within a few KB of it and come from L1/L2, the x
// neighbours one x-row (Y*Z*C floats) away, which the blocks of the
// neighbouring rows have just read or are about to read through L2.
// A gated element (g == 0 in sparse mode) reads no neighbour. out is a new
// buffer, never p or g.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float cl(float x) {
  return fminf(fmaxf(x, -1.f), 1.f);
}

__device__ __forceinline__ float pair(float p, float up, float dn, float w) {
  return __fmul_rn(w, __fadd_rn(cl(__fsub_rn(p, up)), cl(__fsub_rn(p, dn))));
}

__global__ void __launch_bounds__(THREADS)
tv_add_grad_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ out, int gx, int gy, int gz, int c,
                   int ox, int oy, int oz, int bx, int by, int bz,
                   long long g_sx, long long g_sy, long long g_sz,
                   long long g_sc, long long n, float wx, float wy,
                   float wz, int dense) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  long long r = i;
  const int ch = (int)(r % c);
  r /= c;
  const int bzi = (int)(r % bz);
  r /= bz;
  const int byi = (int)(r % by);
  const int bxi = (int)(r / by);
  const float gi = g[bxi * g_sx + byi * g_sy + bzi * g_sz + ch * g_sc];
  if (!dense && gi == 0.f) {
    out[i] = __fadd_rn(gi, 0.f);
    return;
  }
  const int x = bxi + ox, y = byi + oy, z = bzi + oz;
  const long long sz = c, sy = (long long)gz * c, sx = (long long)gy * gz * c;
  const long long at = x * sx + y * sy + z * sz + ch;
  const float pc = __ldg(p + at);
  const float xp = __ldg(p + at + (x + 1 < gx ? sx : 0));
  const float xm = __ldg(p + at - (x > 0 ? sx : 0));
  const float yp = __ldg(p + at + (y + 1 < gy ? sy : 0));
  const float ym = __ldg(p + at - (y > 0 ? sy : 0));
  const float zp = __ldg(p + at + (z + 1 < gz ? sz : 0));
  const float zm = __ldg(p + at - (z > 0 ? sz : 0));
  const float tv = __fadd_rn(__fadd_rn(pair(pc, xp, xm, wx),
                                       pair(pc, yp, ym, wy)),
                             pair(pc, zp, zm, wz));
  out[i] = __fadd_rn(gi, tv);
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p [gx, gy, gz, c] f32 contiguous, the whole grid; g [bx, by, bz, c] f32
// with element strides (g_sx, g_sy, g_sz, g_sc) and out [bx, by, bz, c] f32
// contiguous, the box at (ox, oy, oz) (the whole grid: offsets 0, sizes =
// the grid's). out must not alias p or g. wx, wy, wz: the x, y, z terms'
// weights, already divided by 6. dense = 0: the term only where g != 0.
int dvgo_tv_add_grad(const float* p, const float* g, float* out, int gx,
                     int gy, int gz, int c, int ox, int oy, int oz, int bx,
                     int by, int bz, long long g_sx, long long g_sy,
                     long long g_sz, long long g_sc, float wx, float wy,
                     float wz, int dense, void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || c < 1 || bx < 1 || by < 1 || bz < 1 ||
      ox < 0 || oy < 0 || oz < 0 || ox + bx > gx || oy + by > gy ||
      oz + bz > gz)
    return cudaErrorInvalidValue;
  const long long n = (long long)bx * by * bz * c;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  tv_add_grad_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, g, out, gx, gy, gz, c, ox, oy, oz, bx, by, bz, g_sx, g_sy, g_sz,
      g_sc, n, wx, wy, wz, dense);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
