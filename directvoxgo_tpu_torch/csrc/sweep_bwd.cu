// Station-sweep backward (kernel K-C): the grid cotangent of the bilinear
// station taps.
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
// Rounding points, those of the JAX backward: t by one IEEE division, u and
// v as one FMA each; wu rounded to the interp dtype and rnd() rounding the
// product to it (bf16 sweeps; nothing is rounded in f32 sweeps); the
// products, the (1-f)/f split and the sum over rays in f32. Taps off the
// slab, or outside the ray tile's v-window [vb, vb + wv) when windowed, add
// nothing; neither do zero cotangents or zero weights, so a voxel no ray
// touches stays exactly 0.
//
// Bound on the H100: the TPU version contracts dense [N, Gu] x [N, Gv*C]
// hat rows per station because scatters are slow there; here each (ray,
// station) has four nonzero taps, a scatter-add of C values each. The bytes
// it must move are the cotangent once, the rays once and the touched voxels
// once; its operations are far below the FMA rate. The first version (one
// thread per ray looping over 8 stations, a runtime channel count, one
// scalar f32 atomic per tap and channel, twice between slabs) was bound by
// the atomics: by their count on the steps, and by their contention on the
// counted view (neighbouring rays of one view hit the same few voxels of a
// one-channel plane: ~2e8 atomics on a 104x96 plane). Around it, a zero
// fill of the whole f32 accumulator and a cast of all of it to the grid
// dtype cost more than the scatter on the large grids.
// Design:
//  - global form (the steps): one thread per (ray, station), blocks of a 32
//    x 8 tile along the cotangent's unit-stride axis (rays, or stations when
//    autograd hands over its [C, N, S] layout, read through its strides
//    without a copy); the channel count is a template parameter (1, 5, 11,
//    14, plus a generic instance); a tap's C values go out as
//    red.global.add.v4.f32 reductions into an accumulator whose channel
//    stride is padded to a multiple of 4 (14 -> 16: 4 reductions where the
//    first version issued 14 atomics; v4 beat v2 and scalar reductions);
//  - shared form (a counted view's dense 104x96x1 plane): a block owns one
//    station and a chunk of rays and sums its taps in a shared-memory
//    plane. Neighbouring rays of a view hit the same voxels, so the taps of
//    a run of neighbouring lanes on one voxel are summed in the warp first
//    (segmented shuffle reduction) and added with one shared-memory atomic;
//    the block then flushes each nonzero voxel once, (1-f)/f onto the two
//    grid slabs. The split scales the block's partial sum rather than each
//    tap, as the plain version scales the station's whole sum;
//  - the accumulator is a scratch buffer that stays zero between calls, and
//    each touched voxel is marked in a byte per voxel: the finishing pass
//    copies only the touched voxels into the zero-filled output and zeroes
//    them and their marks again, so no call fills or casts the whole f32
//    grid. Marks and scratch are zero between calls, so a call takes no
//    state from the host: a train step captured as a CUDA graph replays
//    the same launches with the same arguments.
// The order of the f32 reductions varies from run to run, so the sums
// differ in their last bits between runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_scatter.cuh"

namespace {

using dvgo::hat;
using dvgo::round_bf16;

constexpr int C_MAX = 16;
constexpr int FAST = 32;     // global form: lanes along the unit-stride axis
constexpr int SLOW = 8;      //   warps along the other one
constexpr int SHARED_THREADS = 512;
constexpr int FINISH_THREADS = 256;

// The accumulator's channel stride for C channels: 1 for one channel, else
// C rounded up to whole 16-byte vectors.
__host__ __device__ constexpr int acc_stride(int c) {
  return c == 1 ? 1 : (c + 3) / 4 * 4;
}

struct Sweep {
  const float* g;
  long long gs_s, gs_c, gs_n;     // cotangent strides, in elements
  const float* rays;
  const int* v_base;
  float* acc;                     // [Gp, Gu, Gv, as] f32, zero at entry
  uint8_t* flags;                 // [Gp, Gu, Gv]: epoch where touched
  int epoch, n, s_total, gu, gv, c, as, k, wv, window_mode, tile_n, seg_idx;
};

// The ray's window [v_lo, v_hi) and its (u, v) at station s, exactly as
// sweep_fwd.cu computes them; false when no tap has weight.
__device__ __forceinline__ bool station_uv(const Sweep& w, int r, int s,
                                           float inv_k, float& u, float& v,
                                           int& v_lo, int& v_hi) {
  const float op = w.rays[r], ou = w.rays[w.n + r], ov = w.rays[2 * w.n + r];
  const float dp = w.rays[3 * w.n + r], du = w.rays[4 * w.n + r],
              dv = w.rays[5 * w.n + r];
  v_lo = 0;
  v_hi = w.gv;
  if (w.window_mode == 1) v_lo = w.v_base[r / w.tile_n];
  if (w.window_mode == 2) v_lo = w.v_base[w.seg_idx];
  if (w.window_mode != 0) v_hi = min(v_lo + w.wv, w.gv);
  const float t = __fdiv_rn(__fsub_rn(__fmul_rn((float)s, inv_k), op), dp);
  u = __fmaf_rn(t, du, ou);
  v = __fmaf_rn(t, dv, ov);
  return u > -1.f && u < (float)w.gu && v > -1.f && v < (float)w.gv;
}

// g[s, 0:c, r] into gs (zeros beyond c); false when all of them are zero.
template <int NC, bool GENERIC>
__device__ __forceinline__ bool load_cot(const Sweep& w, int r, int s,
                                         float (&gs)[NC]) {
  const float* p = w.g + s * w.gs_s + r * w.gs_n;
  bool any = false;
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    gs[ch] = (!GENERIC || ch < w.c) ? p[ch * w.gs_c] : 0.f;
    any = any || gs[ch] != 0.f;
  }
  return any;
}

// One tap's values x[c] = wu * rnd(wvv * g[c]); false when all are zero.
template <bool BF16, int NC, int A>
__device__ __forceinline__ bool tap_values(float wu, float wvv,
                                           const float (&gs)[NC],
                                           float (&x)[A]) {
  bool any = false;
#pragma unroll
  for (int ch = 0; ch < A; ++ch) {
    float val = 0.f;
    if (ch < NC) {
      float rhs = __fmul_rn(wvv, gs[ch]);
      if (BF16) rhs = round_bf16(rhs);
      val = __fmul_rn(wu, rhs);
    }
    x[ch] = val;
    any = any || val != 0.f;
  }
  return any;
}

// w * x[0:A) onto the voxel at p in VR-wide reductions, skipping vectors
// that are all zero (GENERIC: only the vectors that hold a channel < c).
template <int A, int VR, bool GENERIC>
__device__ __forceinline__ void red_voxel(float* p, const float (&x)[A],
                                          float w, int c) {
#pragma unroll
  for (int i = 0; i < A / VR; ++i) {
    if (GENERIC && i * VR >= c) continue;
    float y[VR];
    bool any = false;
#pragma unroll
    for (int e = 0; e < VR; ++e) {
      y[e] = __fmul_rn(w, x[i * VR + e]);
      any = any || x[i * VR + e] != 0.f;
    }
    if (any) dvgo::red_add<VR>(p + i * VR, y);
  }
}

// The voxel's (1-f) share onto grid slab z and its f share onto slab z+1,
// each voxel marked touched.
template <int A, int VR, bool GENERIC>
__device__ __forceinline__ void split_voxel(const Sweep& w,
                                            const dvgo::SlabSplit& sp,
                                            size_t vox, const float (&x)[A]) {
  const size_t plane = (size_t)w.gu * w.gv;
  const size_t at = (size_t)sp.z * plane + vox;
  red_voxel<A, VR, GENERIC>(w.acc + at * w.as, x, sp.f_lo, w.c);
  w.flags[at] = (uint8_t)w.epoch;
  if (sp.j > 0) {
    red_voxel<A, VR, GENERIC>(w.acc + (at + plane) * w.as, x, sp.f_hi, w.c);
    w.flags[at + plane] = (uint8_t)w.epoch;
  }
}

// Tap q (a = q / 2, b = q % 2) of a ray at (u, v): its voxel iu*Gv + iv
// in a slab plane and its values x[c] = wu * rnd(wvv * g[c]), or -1 (x
// zero) when the tap lies off the slab or its window, or adds nothing.
template <bool BF16, int NC, int A>
__device__ __forceinline__ int tap_voxel(const Sweep& w, float u, float v,
                                         int v_lo, int v_hi, int q,
                                         const float (&gs)[NC],
                                         float (&x)[A]) {
  const int iu = (int)floorf(u) + q / 2, iv = (int)floorf(v) + q % 2;
#pragma unroll
  for (int ch = 0; ch < A; ++ch) x[ch] = 0.f;
  if (iu < 0 || iu >= w.gu || iv < v_lo || iv >= v_hi) return -1;
  float wu = hat(u, iu);
  if (BF16) wu = round_bf16(wu);
  const float wvv = hat(v, iv);
  if (wu == 0.f || wvv == 0.f || !tap_values<BF16>(wu, wvv, gs, x))
    return -1;
  return iu * w.gv + iv;
}

// Global form: one thread per (ray, station). Block b covers a FAST x SLOW
// tile; lanes run along stations when s_fast (the cotangent's unit stride
// is the station axis), else along rays.
template <bool BF16, int C>
__global__ void __launch_bounds__(FAST * SLOW)
sweep_bwd_global(Sweep w, int tiles_fast, int s_fast) {
  constexpr bool GENERIC = C == 0;
  constexpr int NC = GENERIC ? C_MAX : C;
  constexpr int A = acc_stride(NC);
  constexpr int VR = A % 4 == 0 ? 4 : 1;
  const int tf = blockIdx.x % tiles_fast, to = blockIdx.x / tiles_fast;
  const int fast = tf * FAST + threadIdx.x, slow = to * SLOW + threadIdx.y;
  const int s = s_fast ? fast : slow, r = s_fast ? slow : fast;
  if (r >= w.n || s >= w.s_total) return;
  const float inv_k = 1.f / (float)w.k;
  float u, v;
  int v_lo, v_hi;
  if (!station_uv(w, r, s, inv_k, u, v, v_lo, v_hi)) return;
  float gs[NC];
  if (!load_cot<NC, GENERIC>(w, r, s, gs)) return;
  const dvgo::SlabSplit sp = dvgo::slab_split(s, w.k);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float x[A];
    const int vox = tap_voxel<BF16>(w, u, v, v_lo, v_hi, q, gs, x);
    if (vox >= 0) split_voxel<A, VR, GENERIC>(w, sp, (size_t)vox, x);
  }
}

// Shared form: block b sums station b % S over its chunk b / S of rays in
// a [Gu, Gv, C] f32 plane of shared memory, then flushes the plane.
// Neighbouring lanes take neighbouring rays, whose taps mostly hit the same
// voxels on a dense view: each run of neighbouring lanes on one voxel is
// summed in the warp first (a segmented shuffle reduction, in lane order),
// and the run's first lane adds the sum with one shared-memory atomic.
template <bool BF16, int C>
__global__ void __launch_bounds__(SHARED_THREADS)
sweep_bwd_shared(Sweep w, int chunk_n) {
  constexpr bool GENERIC = C == 0;
  constexpr int NC = GENERIC ? C_MAX : C;
  constexpr int A = acc_stride(NC);
  constexpr int VR = A % 4 == 0 ? 4 : 1;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float plane[];
  const int s = blockIdx.x % w.s_total;
  const int chunk = blockIdx.x / w.s_total;
  const int c = GENERIC ? w.c : C;
  const int n_vox = w.gu * w.gv;
  for (int i = threadIdx.x; i < n_vox * c; i += blockDim.x) plane[i] = 0.f;
  __syncthreads();
  const float inv_k = 1.f / (float)w.k;
  const int r_begin = chunk * chunk_n;
  const int r_end = min(w.n, r_begin + chunk_n);
  const int lane = threadIdx.x & 31;
  // A block-uniform trip count: every lane of a warp reaches the shuffles.
  const int n_iter = (r_end - r_begin + (int)blockDim.x - 1) /
                     (int)blockDim.x;
  for (int it = 0; it < n_iter; ++it) {
    const int r = r_begin + it * blockDim.x + threadIdx.x;
    float u = 0.f, v = 0.f, gs[NC];
    int v_lo = 0, v_hi = 0;
    const bool live = r < r_end &&
                      station_uv(w, r, s, inv_k, u, v, v_lo, v_hi) &&
                      load_cot<NC, GENERIC>(w, r, s, gs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float x[A];
      int at = -1;
      if (live) {
        at = tap_voxel<BF16>(w, u, v, v_lo, v_hi, q, gs, x);
        if (at >= 0) at *= c;
      } else {
#pragma unroll
        for (int ch = 0; ch < A; ++ch) x[ch] = 0.f;
      }
      // The run of lanes from a head to the next head shares one voxel:
      // lane l adds lane l + off while l + off stays inside the run.
      const int up = __shfl_up_sync(FULL, at, 1);
      const bool head = lane == 0 || up != at;
      const unsigned after = __ballot_sync(FULL, head) &
                             ~(lane == 31 ? FULL : (2u << lane) - 1u);
      const int end = after ? __ffs(after) - 1 : 32;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) {
        float sum = x[ch];
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float y = __shfl_down_sync(FULL, sum, off);
          if (lane + off < end) sum = __fadd_rn(sum, y);
        }
        if (head && at >= 0 && (!GENERIC || ch < c) && sum != 0.f)
          atomicAdd(plane + at + ch, sum);
      }
    }
  }
  __syncthreads();
  const dvgo::SlabSplit sp = dvgo::slab_split(s, w.k);
  for (int vox = threadIdx.x; vox < n_vox; vox += blockDim.x) {
    float x[A];
    bool any = false;
#pragma unroll
    for (int ch = 0; ch < A; ++ch) {
      x[ch] = (ch < NC && (!GENERIC || ch < c)) ? plane[vox * c + ch] : 0.f;
      any = any || x[ch] != 0.f;
    }
    if (any) split_voxel<A, VR, GENERIC>(w, sp, (size_t)vox, x);
  }
}

__device__ __forceinline__ void store_out(float* o, float x) { *o = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

// The voxels this call touched (flag == epoch) from the scratch into the
// zero-filled output, rounded to its dtype, and zeroed again in the scratch,
// their flags cleared. Thread t takes 16 bytes of the scratch, float4 t % per
// of voxel t / per (per: the voxel's as / 4 float4s rounded up to a power of
// two, the lanes past as / 4 idle; as = 1, one channel: one float a thread),
// so that a warp reads and zeroes contiguous bytes and holds every thread of
// its voxels. Each lane reads its voxel's flag, the warp meets at
// __syncwarp, and only then does lane q = 0 clear the flag: no flag is
// cleared while a thread of its voxel still reads it. The loop runs while
// the warp's first item is in range, so all 32 lanes reach every
// __syncwarp.
template <typename OUT>
__global__ void __launch_bounds__(FINISH_THREADS)
sweep_bwd_finish(float* __restrict__ acc, int as, int per,
                 uint8_t* __restrict__ flags, int epoch,
                 OUT* __restrict__ out, int n_vox, int c) {
  const unsigned n_items = (unsigned)n_vox * per;
  const unsigned nq = as == 1 ? 1 : as / 4, sh = __ffs(per) - 1;
  for (unsigned base = blockIdx.x * FINISH_THREADS + (threadIdx.x & ~31u);
       base < n_items; base += gridDim.x * FINISH_THREADS) {
    const unsigned t = base + (threadIdx.x & 31u);
    const unsigned v = t >> sh, q = t & (per - 1);
    const bool hit = t < n_items && q < nq && flags[v] == (uint8_t)epoch;
    __syncwarp();
    if (!hit) continue;
    if (q == 0) flags[v] = 0;
    OUT* o = out + (size_t)v * c;
    if (as == 1) {
      store_out(o, acc[v]);
      acc[v] = 0.f;
      continue;
    }
    float4* p = reinterpret_cast<float4*>(acc + (size_t)v * as) + q;
    const float4 x = *p;
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((int)(4 * q) + e < c) store_out(o + 4 * q + e, xs[e]);
    *p = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <bool BF16, int C>
int launch(const Sweep& w, int chunks, cudaStream_t st) {
  if (chunks == 0) {
    const bool s_fast = w.gs_s == 1 && w.gs_n != 1;
    const int tiles_fast = s_fast ? (w.s_total + FAST - 1) / FAST
                                  : (w.n + FAST - 1) / FAST;
    const long long tiles_slow = s_fast ? (w.n + SLOW - 1) / SLOW
                                        : (w.s_total + SLOW - 1) / SLOW;
    if ((long long)tiles_fast * tiles_slow > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    sweep_bwd_global<BF16, C>
        <<<(unsigned)(tiles_fast * tiles_slow), dim3(FAST, SLOW), 0, st>>>(
            w, tiles_fast, (int)s_fast);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)w.gu * w.gv * w.c * sizeof(float);
  // The opt-in above 48 KB, once per instance (the size only grows).
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_bwd_shared<BF16, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  sweep_bwd_shared<BF16, C><<<(unsigned)((long long)w.s_total * chunks),
                              SHARED_THREADS, smem, st>>>(
      w, (w.n + chunks - 1) / chunks);
  return cudaGetLastError();
}

template <bool BF16>
int launch_c(const Sweep& w, int chunks, cudaStream_t st) {
  switch (w.c) {
    case 1: return launch<BF16, 1>(w, chunks, st);
    case 5: return launch<BF16, 5>(w, chunks, st);
    case 11: return launch<BF16, 11>(w, chunks, st);
    case 14: return launch<BF16, 14>(w, chunks, st);
    default: return launch<BF16, 0>(w, chunks, st);
  }
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dvgo_sweep_bwd_max_channels() { return C_MAX; }

// limits[0..2] = the dynamic shared memory a block may opt into, the shared
// memory of one SM, the number of SMs, of CUDA device `device`.
int dvgo_sweep_bwd_limits(int device, int* limits) {
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                   cudaDevAttrMultiProcessorCount};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = cudaDeviceGetAttribute(&limits[i], attrs[i], device);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// g: station cotangents g[s, c, n] at element strides (gs_s, gs_c, gs_n),
// f32; rays [6, N] f32 rows (op, ou, ov, dp, du, dv) with dp != 0; acc: the
// [Gp, Gu, Gv, as] f32 scratch (as = acc_stride(c)), ZERO at
// entry; flags [Gp, Gu, Gv] bytes, zero at entry (the finishing pass
// clears the ones it consumes): the touched voxels get epoch (1..255). S = k*(Gp-1)+1. window_mode 0: full
// transpose (v_base unused); 1: ray r counts only v-taps in [v_base[r /
// tile_n], +wv); 2: every ray counts only v-taps in [v_base[seg_idx], +wv).
// chunks 0: the global form; chunks > 0: the shared form with chunks ray
// chunks per station (the [Gu, Gv, C] f32 plane must fit in a block's
// dynamic shared memory).
int dvgo_sweep_bwd(const float* g, long long gs_s, long long gs_c,
                   long long gs_n, const float* rays, const int* v_base,
                   float* acc, int as, unsigned char* flags, int epoch, int n,
                   int s_total, int gu, int gv, int c, int k,
                   int interp_is_bf16, int wv, int window_mode, int tile_n,
                   int seg_idx, int chunks, void* stream) {
  if (c < 1 || c > C_MAX || as != acc_stride(c) || n < 1 || s_total < 1 ||
      k < 1 || (s_total - 1) % k != 0 || epoch < 1 || epoch > 255 ||
      chunks < 0 || window_mode < 0 || window_mode > 2 ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0 ||
      (window_mode != 0 && (v_base == nullptr || wv < 1 || tile_n < 1)))
    return cudaErrorInvalidValue;
  const Sweep w{g, gs_s, gs_c, gs_n, rays, v_base, acc, flags, epoch, n,
                s_total, gu, gv, c, as, k, wv, window_mode, tile_n, seg_idx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return interp_is_bf16 ? launch_c<true>(w, chunks, st)
                        : launch_c<false>(w, chunks, st);
}

// out [Gp*Gu*Gv, c] (bf16 if out_is_bf16 else f32), zero-filled by the
// caller, gets the voxels flagged with epoch; those are zeroed in acc and
// their flags cleared to 0.
int dvgo_sweep_bwd_finish(float* acc, int as, unsigned char* flags,
                          int epoch, void* out, int out_is_bf16,
                          long long n_vox, int c, void* stream) {
  int per = 1;
  while (as > 1 && per < as / 4) per *= 2;
  const long long items = n_vox * per;
  if (c < 1 || as != acc_stride(c) || n_vox < 1 || per > 32 ||
      items >= (1LL << 31) || epoch < 1 || epoch > 255)
    return cudaErrorInvalidValue;
  const long long want = (items + FINISH_THREADS - 1) / FINISH_THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 32 ? want : 132 * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_is_bf16)
    sweep_bwd_finish<__nv_bfloat16><<<blocks, FINISH_THREADS, 0, st>>>(
        acc, as, per, flags, epoch, static_cast<__nv_bfloat16*>(out),
        (int)n_vox, c);
  else
    sweep_bwd_finish<float><<<blocks, FINISH_THREADS, 0, st>>>(
        acc, as, per, flags, epoch, static_cast<float*>(out), (int)n_vox, c);
  return cudaGetLastError();
}

}  // extern "C"
