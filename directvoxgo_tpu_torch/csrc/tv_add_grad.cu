// Total-variation stencil plus gradient add (kernel K-F).
//
// Replaces: directvoxgo_tpu/ops/tv.py::_tv_rows_pallas (and the jnp
// total_variation_add_grad / boxed tv_term path of the JAX engine).
//
// For each element of a box of an f32 grid p [X, Y, Z, C] (channels
// independent; C = 1 for a [X, Y, Z] grid) whose gradient is g [bx, by, bz,
// C]:
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
// MaskedAdam's skip_zero_grad keys on. out is a new buffer, never p or g.
//
// Bound on the H100: about 25 flops per element against 12 bytes (p, g,
// out), so it is bound by memory traffic: g and out once, p once over the
// box and its 1-voxel halo. Two paths, picked by the wrapper
// (ops/tv.py::rows_path):
//
//  - rows (dvgo_tv_add_grad_rows): g dense with its channels innermost
//    (contiguous, or the permuted view autograd hands over after the
//    sweep's station-major transpose), the box's flat (z*C) run and the
//    grid's row in whole 16-byte vectors. A block owns a tile of TY y rows
//    x TR floats of the run and marches along x over a slice of the box.
//    Dense mode: each x plane of p is staged with cp.async into one of
//    three shared buffers (the tile, its y-1 and y+1 rows and +-H floats of
//    z halo, H >= C), two planes ahead of the one computed, so every
//    element of p comes from device memory once per block (plus the halo
//    rows, which the neighbouring blocks read at the same time and L2
//    serves). p[x-1] of a thread's own four elements stays in registers,
//    p[x+1] is the next staged plane; the z neighbours are +-C floats away
//    in the staged row, and the z border is tested on the flat index (f <
//    C, f >= (gz-1)*C) without a division. Sparse mode (gated by g != 0):
//    only the elements whose gradient is not zero need p, a few % of the
//    grid on the fern path, so p is not staged and a nonzero element reads
//    its centre and six neighbours from the grid. In both, the plane's g
//    tile goes through shared memory, read one plane ahead in g's own
//    memory order (so a z-major g is read as coalesced as a contiguous
//    one), and out is written as float4 with streaming hints; index math is
//    32-bit (the wrapper sends larger grids to the strided path).
//  - strided (dvgo_tv_add_grad): the first version, one thread per
//    element, g read through its strides (autograd's channel slices of a
//    stacked grid's gradient) and boxes at any offset.
// Both entries take the box's offsets as host integers or, with a non-null
// `offs`, as int32 [3] in device memory, read by every block at its start
// and clamped into the grid: a train step captured as a CUDA graph then
// replays each step's box where its draw put it. The wrapper picks the
// rows path for device offsets only where every offset the box admits
// keeps the flat run in whole vectors (C a multiple of 4, or the box
// spanning the grid's z).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float cl(float x) {
  return fminf(fmaxf(x, -1.f), 1.f);
}

__device__ __forceinline__ float pair(float p, float up, float dn, float w) {
  return __fmul_rn(w, __fadd_rn(cl(__fsub_rn(p, up)), cl(__fsub_rn(p, dn))));
}

__device__ __forceinline__ float stencil(float pc, float xp, float xm,
                                         float yp, float ym, float zp,
                                         float zm, float wx, float wy,
                                         float wz) {
  return __fadd_rn(__fadd_rn(pair(pc, xp, xm, wx), pair(pc, yp, ym, wy)),
                   pair(pc, zp, zm, wz));
}

// ---- strided path: one thread per element ---------------------------------

__global__ void __launch_bounds__(THREADS)
tv_add_grad_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ out, int gx, int gy, int gz, int c,
                   int ox, int oy, int oz, int bx, int by, int bz,
                   long long g_sx, long long g_sy, long long g_sz,
                   long long g_sc, long long n, float wx, float wy,
                   float wz, int dense, const int* __restrict__ offs) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  if (offs) {
    ox = min(max(__ldg(offs), 0), gx - bx);
    oy = min(max(__ldg(offs + 1), 0), gy - by);
    oz = min(max(__ldg(offs + 2), 0), gz - bz);
  }
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
  out[i] = __fadd_rn(gi, stencil(pc, xp, xm, yp, ym, zp, zm, wx, wy, wz));
}

// ---- rows path: x-marching tiles staged in shared memory ------------------

constexpr int TR = 128;            // floats of the flat run per tile row
constexpr int TY = THREADS / (TR / 4);   // y rows per tile (8)
// Row stride of the staged g tile: 4 floats of padding keep the float4
// reads aligned and spread a z-major g's writes (rows 8 apart at C = 1)
// over the banks.
constexpr int GT = TR + 4;
constexpr int H_MAX = 32;          // z halo, floats (C <= 32)
constexpr int CHUNKS = 2;          // 16-byte staging copies of p a thread
static_assert((TY + 2) * (TR + 2 * H_MAX) / 4 <= CHUNKS * THREADS,
              "staging chunks");
// Gradient elements a thread stages per plane (z-major: the tile's z range
// touches up to TR + 2C floats of each row).
constexpr int GJ = ((TR + 2 * H_MAX) * TY + THREADS - 1) / THREADS;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
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

struct RowArgs {
  int gx, gy, gzc, c, ox, oy, ozc, bx, by, run, halo, x_per_block;
  int gsx, gsy, gsz;   // g's element strides (channel stride 1)
  int g_zmajor;        // g's z stride above its y stride (a permuted view)
  float wx, wy, wz;
};

// Planes staged ahead of the one computed, and the ring of buffers: dense
// mode stages p and g, sparse mode only g, so it can look further ahead.
template <bool DENSE>
struct Ring {
  static constexpr int DIST = DENSE ? 2 : 3, NBUF = DIST + 1;
};

// DENSE: the stencil on every element, p staged plane by plane. Sparse
// (gated by g != 0): only the elements whose gradient is not zero need p,
// a few % of the grid on the fern path, so p is not staged; a nonzero
// element reads its centre and six neighbours from the grid (L1/L2).
template <bool DENSE>
__global__ void __launch_bounds__(THREADS)
tv_rows_kernel(const float* __restrict__ p, const float* __restrict__ g,
               float* __restrict__ out, RowArgs a,
               const int* __restrict__ offs) {
  constexpr int DIST = Ring<DENSE>::DIST, NBUF = Ring<DENSE>::NBUF;
  if (offs) {
    a.ox = min(max(__ldg(offs), 0), a.gx - a.bx);
    a.oy = min(max(__ldg(offs + 1), 0), a.gy - a.by);
    a.ozc = min(max(__ldg(offs + 2) * a.c, 0), a.gzc - a.run);
  }
  extern __shared__ float4 smem4[];
  float* gt = reinterpret_cast<float*>(smem4);   // g tiles [NBUF][TY][GT]
  float* smem = gt + NBUF * TY * GT;             // p planes (DENSE)
  const int sw = TR + 2 * a.halo;              // staged row, floats
  const int plane_floats = (TY + 2) * sw;
  const int lane = threadIdx.x, r = threadIdx.y;
  const int tid = r * (TR / 4) + lane;
  const int e0 = blockIdx.x * TR;              // tile start in the run
  const int y0 = blockIdx.y * TY;              // tile start, box rows
  const int xa = blockIdx.z * a.x_per_block;
  const int xb = min(xa + a.x_per_block, a.bx);
  const int row_stride = a.gzc, plane_stride = a.gy * a.gzc;

  // This thread's staging copies of p (the same for every plane): shared
  // offset and the in-plane offset of p, or -1 off the grid's row.
  int s_off[CHUNKS], p_off[CHUNKS];
  const int per_row = sw / 4;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int q = tid + k * THREADS;
    const int sr = q / per_row, sc = q - sr * per_row;
    const int yg = min(max(a.oy + y0 - 1 + sr, 0), a.gy - 1);
    const int f = a.ozc + e0 - a.halo + 4 * sc;
    const bool ok = DENSE && sr < TY + 2 && f >= 0 && f < a.gzc;
    s_off[k] = sr * sw + 4 * sc;
    p_off[k] = ok ? yg * row_stride + f : -1;
  }
  // This thread's gradient elements of the tile, numbered in g's memory
  // order so that neighbouring lanes read neighbouring addresses: (y, z*C)
  // rows for a contiguous g, (z, y, C) for a z-major one (the sweep's
  // permuted gradient). Tile offset, and g's offset without the x term (-1:
  // outside the box). The divisions run once per thread, not per plane.
  int t_off[GJ], g_off[GJ];
#pragma unroll
  for (int j = 0; j < GJ; ++j) {
    const int k = tid + j * THREADS;
    int rr, e, zb, ch;
    if (a.g_zmajor) {
      const int per_z = TY * a.c, zl = k / per_z, rem = k - zl * per_z;
      rr = rem / a.c;
      ch = rem - rr * a.c;
      zb = e0 / a.c + zl;
      e = zb * a.c + ch - e0;
    } else {
      rr = k / TR;
      e = k - rr * TR;
      zb = (e0 + e) / a.c;
      ch = e0 + e - zb * a.c;
    }
    const bool ok = rr < TY && e >= 0 && e < TR && e0 + e < a.run &&
                    y0 + rr < a.by;
    t_off[j] = rr * GT + e;
    g_off[j] = ok ? (y0 + rr) * a.gsy + zb * a.gsz + ch : -1;
  }
  // Plane x (box) into ring slot `buf`: g where x < xb, p (DENSE) where
  // x <= xb (plane xb is the last one's x+1 neighbour; clamped to the grid).
  auto stage = [&](int buf, int x) {
    if (x < xb) {
      const float* src = g + x * a.gsx;
      float* dst = gt + buf * TY * GT;
#pragma unroll
      for (int j = 0; j < GJ; ++j)
        if (g_off[j] >= 0) cp_async4(dst + t_off[j], src + g_off[j]);
    }
    if (DENSE && x <= xb) {
      const int xg = min(max(a.ox + x, 0), a.gx - 1);
      const float* src = p + xg * plane_stride;
      float* dst = smem + buf * plane_floats;
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k)
        if (p_off[k] >= 0) cp_async16(dst + s_off[k], src + p_off[k]);
    }
    cp_async_commit();
  };

  const int y = y0 + r;                        // box row of this thread
  const int e = e0 + 4 * lane;                 // run element of this thread
  const bool mine = y < a.by && e < a.run;
  const int f = a.ozc + e;                     // flat index in the grid row
  const int col = a.halo + 4 * lane;           // its column in a staged row
  const int out_row = y * a.run + e;           // offset inside an x plane
  const int out_plane = a.by * a.run;
  const int yg = a.oy + y;

  float4 pm = make_float4(0.f, 0.f, 0.f, 0.f);
  if (DENSE && mine) {
    const int xg = max(a.ox + xa - 1, 0);
    pm = __ldg(reinterpret_cast<const float4*>(
        p + xg * plane_stride + yg * row_stride + f));
  }
#pragma unroll
  for (int d = 0; d < DIST; ++d) stage(d, xa + d);
  for (int i = 0, x = xa; x < xb; ++i, ++x) {
    __syncthreads();               // slot (i + DIST) % NBUF is free
    stage((i + DIST) % NBUF, x + DIST);
    cp_async_wait<DIST - 1>();     // planes x and x+1 landed
    __syncthreads();
    const float4 gq = *reinterpret_cast<const float4*>(
        gt + (i % NBUF) * TY * GT + r * GT + 4 * lane);
    const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
    float o[4];
    if (DENSE) {
      const float* cur = smem + (i % NBUF) * plane_floats;
      const float* nxt = smem + ((i + 1) % NBUF) * plane_floats;
      const float4 pc = *reinterpret_cast<const float4*>(cur + (r + 1) * sw +
                                                          col);
      const float4 pn = *reinterpret_cast<const float4*>(
          nxt + (r + 1) * sw + col);
      const float4 ym = *reinterpret_cast<const float4*>(cur + r * sw + col);
      const float4 yp = *reinterpret_cast<const float4*>(
          cur + (r + 2) * sw + col);
      const float* row = cur + (r + 1) * sw + col;
      const float pcv[4] = {pc.x, pc.y, pc.z, pc.w};
      const float pnv[4] = {pn.x, pn.y, pn.z, pn.w};
      const float pmv[4] = {pm.x, pm.y, pm.z, pm.w};
      const float ymv[4] = {ym.x, ym.y, ym.z, ym.w};
      const float ypv[4] = {yp.x, yp.y, yp.z, yp.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float zm = f + k >= a.c ? row[k - a.c] : pcv[k];
        const float zp = f + k + a.c < a.gzc ? row[k + a.c] : pcv[k];
        o[k] = __fadd_rn(gv[k], stencil(pcv[k], pnv[k], pmv[k], ypv[k],
                                        ymv[k], zp, zm, a.wx, a.wy, a.wz));
      }
      pm = pc;
    } else {
      const int xg = a.ox + x;
      const float* c = p + xg * plane_stride + yg * row_stride + f;
      const int sxp = xg + 1 < a.gx ? plane_stride : 0;
      const int sxm = xg > 0 ? plane_stride : 0;
      const int syp = yg + 1 < a.gy ? row_stride : 0;
      const int sym = yg > 0 ? row_stride : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!mine || gv[k] == 0.f) {
          o[k] = __fadd_rn(gv[k], 0.f);
          continue;
        }
        const float* q = c + k;
        const float pc = __ldg(q);
        const float zp = __ldg(q + (f + k + a.c < a.gzc ? a.c : 0));
        const float zm = __ldg(q - (f + k >= a.c ? a.c : 0));
        o[k] = __fadd_rn(gv[k], stencil(pc, __ldg(q + sxp), __ldg(q - sxm),
                                        __ldg(q + syp), __ldg(q - sym), zp,
                                        zm, a.wx, a.wy, a.wz));
      }
    }
    if (mine)
      __stcs(reinterpret_cast<float4*>(out + x * out_plane + out_row),
             make_float4(o[0], o[1], o[2], o[3]));
  }
}

int sm_count();

template <bool DENSE>
int launch_rows(const float* p, const float* g, float* out, RowArgs a,
                const int* offs, cudaStream_t st) {
  // x slices: enough blocks for several waves, at least 16 planes each (a
  // slice stages planes beyond its own).
  const int tiles = (a.run + TR - 1) / TR * ((a.by + TY - 1) / TY);
  const int want = 16 * sm_count();
  int slices = (want + tiles - 1) / tiles;
  slices = max(1, min(slices, (a.bx + 15) / 16));
  a.x_per_block = (a.bx + slices - 1) / slices;
  slices = (a.bx + a.x_per_block - 1) / a.x_per_block;
  size_t smem = (size_t)Ring<DENSE>::NBUF * TY * GT * 4;
  if (DENSE)
    smem += (size_t)Ring<DENSE>::NBUF * (TY + 2) * (TR + 2 * a.halo) * 4;
  dim3 grid((a.run + TR - 1) / TR, (a.by + TY - 1) / TY, slices);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  tv_rows_kernel<DENSE><<<grid, dim3(TR / 4, TY), smem, st>>>(p, g, out,
                                                               a, offs);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
  }
  return n;
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
// offs: null, or int32 [3] in device memory holding the box's (ox, oy, oz),
// which the kernel reads (clamped into the grid) in place of the host's
// (then 0).
int dvgo_tv_add_grad(const float* p, const float* g, float* out, int gx,
                     int gy, int gz, int c, int ox, int oy, int oz, int bx,
                     int by, int bz, long long g_sx, long long g_sy,
                     long long g_sz, long long g_sc, float wx, float wy,
                     float wz, int dense, const int* offs, void* stream) {
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
      g_sc, n, wx, wy, wz, dense, offs);
  return static_cast<int>(cudaGetLastError());
}

// The rows path: as dvgo_tv_add_grad, with g's channel stride 1 (or c = 1)
// and every offset into g under 2^31; p and out 16-byte aligned; gz*c,
// oz*c and bz*c multiples of 4; c at most 32; the grid under 2^31
// elements. Device offsets (offs non-null) must keep oz*c a multiple of 4
// for every offset the box admits (the wrapper's rule).
int dvgo_tv_add_grad_rows(const float* p, const float* g, float* out, int gx,
                          int gy, int gz, int c, int ox, int oy, int oz,
                          int bx, int by, int bz, long long g_sx,
                          long long g_sy, long long g_sz, long long g_sc,
                          float wx, float wy, float wz, int dense,
                          const int* offs, void* stream) {
  if (gx < 1 || gy < 1 || gz < 1 || c < 1 || c > H_MAX || bx < 1 ||
      by < 1 || bz < 1 || ox < 0 || oy < 0 || oz < 0 || ox + bx > gx ||
      oy + by > gy || oz + bz > gz || (gz * c) % 4 || (oz * c) % 4 ||
      (bz * c) % 4 || (long long)gx * gy * gz * c >= 0x7fffffffLL ||
      (c > 1 && g_sc != 1) || g_sx < 0 || g_sy < 0 || g_sz < 0 ||
      (bx - 1) * g_sx + (by - 1) * g_sy + (bz - 1) * g_sz + c >=
          0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return cudaErrorInvalidValue;
  RowArgs a;
  a.gx = gx;
  a.gy = gy;
  a.gzc = gz * c;
  a.c = c;
  a.ox = ox;
  a.oy = oy;
  a.ozc = oz * c;
  a.bx = bx;
  a.by = by;
  a.run = bz * c;
  a.halo = (c + 3) / 4 * 4;
  a.gsx = (int)g_sx;
  a.gsy = (int)g_sy;
  a.gsz = (int)g_sz;
  a.g_zmajor = g_sz > g_sy;
  a.wx = wx;
  a.wy = wy;
  a.wz = wz;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dense ? launch_rows<true>(p, g, out, a, offs, st)
               : launch_rows<false>(p, g, out, a, offs, st);
}

}  // extern "C"
