// Station-sweep forward (kernel K-A): per ray and station, a bilinear tap of
// C channels of the station slab.
//
// Replaces: directvoxgo_tpu/ops/pallas_sweep_train.py::sweep_fwd_pallas
// (the full-Gv form and, with v_base/wv, the per-ray-tile v-windowed form).
//
// For ray n at station s (axis coordinate p = s/k):
//   t = (p - op) / dp,  u = ou + t*du,  v = ov + t*dv
//   out[s, c, n] = sum_v wv(v) * sum_u wu(u) * slab[s, u, v, c]
// with hat weights w(x, i) = max(0, 1 - |x - i|). A coordinate in (-1, 0)
// still weights index 0; taps outside the slab read zero (no clamping).
// Windowed (wv > 0): ray n of tile n / tile_n reads only v in
// [v_base[tile], v_base[tile] + wv); its other taps read zero.
//
// Rounding points, those of the Pallas kernel and of the plain version
// (they decide which edge taps have weight, and so the mask gate): t by one
// IEEE division of the rounded (s/k - op); u and v as one fused multiply-add
// each, as XLA contracts them; wu rounded to the slab dtype, wv kept f32;
// per v tap tmp = wu0*x0 + wu1*x1, then acc += tmp*wv, every product and sum
// rounded to f32 in that order.
//
// Bound on the H100: the TPU version is a dense [Gu] x [Gu, Gv*C] matmul per
// ray and station because gathers are slow there; here only the 4 nonzero
// taps are read, ~6*C flops per (ray, station), so the kernel is bound by
// memory: the slabs once plus the [S, C, N] f32 output once, and the output
// dominates. A training batch's rays are drawn at random, so each (ray,
// station) gathers 2-4 voxels from cache lines no neighbouring thread
// shares. The first version (one thread per ray looping over 8 stations, a
// runtime channel count under C_MAX = 16, 2-byte loads, 64-bit offsets)
// spent its instructions on offsets and a predicated 16-channel loop and
// kept few gathers in flight: it ran at 2-30% of its bound and lost to one
// grid_sample call on the counted view and the render chunk.
// Design:
//  - one thread per (ray, station), blocks of 32 rays x 8 stations: N*S
//    threads fill the 132 SMs at N = 4096, the 8 warps of a block share
//    their rays' loads in L1, and each warp stores out[s, c, n0:n0+32] as
//    one 128-byte line per channel. Batches of 2^24 (ray, station) pairs
//    or more (a counted view) take 8 consecutive stations a thread, which
//    shares the ray's loads and coordinates setup over them;
//  - the channel count is a template parameter: 1, 5, 11 and 14 (the
//    counted view, the coarse step, the MPI step, the fine step and render
//    chunk), plus one generic instance for any other C <= C_MAX;
//  - a voxel's C channels come in the widest loads its bytes and the
//    slabs' address allow (14 bf16: seven 4-byte loads where the first
//    version issued 14 2-byte ones); offsets inside a slab are 32-bit.
//    Padding the channels to 16-byte loads was measured and dropped: the
//    strided station-slab build it needs cost more than the loads saved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C_MAX = 16;
constexpr int RAYS = 32;       // rays per block: one warp's lanes
constexpr int STATIONS = 8;    // stations per block: one per warp

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

// Hat weight rounded to the slab dtype (the interp dtype of the sweep).
__device__ __forceinline__ float round_w(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ float round_w(float w, const float*) { return w; }

template <int VB> struct VecOf;
template <> struct VecOf<16> { using T = uint4; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<4> { using T = unsigned int; };
template <> struct VecOf<2> { using T = unsigned short; };

// C = 0 is the generic instance (runtime channel count c <= C_MAX); VB is
// the load width in bytes; thread (x, y) of a block takes ray x of the
// block's 32 and SPT consecutive stations, the y-th run of the block's.
template <typename T, int C, int VB, int SPT>
__global__ void __launch_bounds__(RAYS * STATIONS)
sweep_fwd_kernel(const T* __restrict__ slabs, const float* __restrict__ rays,
                 const int* __restrict__ v_base, float* __restrict__ out,
                 int n, int s_total, int gu, int gv, int c_rt, float inv_k,
                 int wv, int tile_n) {
  constexpr bool GENERIC = C == 0;
  constexpr int NC = GENERIC ? C_MAX : C;
  constexpr int E = VB / (int)sizeof(T);      // channels per load
  constexpr int NV = (NC + E - 1) / E;        // loads per voxel
  using V = typename VecOf<VB>::T;
  const int c = GENERIC ? c_rt : C;
  const int plane = gu * gv * c;              // elements of one slab
  const int r = blockIdx.x * RAYS + threadIdx.x;
  const int s0 = (blockIdx.y * STATIONS + threadIdx.y) * SPT;
  if (r >= n || s0 >= s_total) return;
  const float op = rays[r], ou = rays[n + r], ov = rays[2 * n + r];
  const float dp = rays[3 * n + r], du = rays[4 * n + r],
              dv = rays[5 * n + r];
  int v_lo = 0, v_hi = gv;
  if (wv > 0) {
    v_lo = v_base[r / tile_n];
    v_hi = min(v_lo + wv, gv);
  }
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = s0 + i;
    if (s >= s_total) break;
    const float t = __fdiv_rn(__fsub_rn(__fmul_rn((float)s, inv_k), op), dp);
    const float u = __fmaf_rn(t, du, ou);
    const float v = __fmaf_rn(t, dv, ov);
    float acc[NC];
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) acc[ch] = 0.f;
    // Nonzero hat support needs u in (-1, gu) and v in (-1, gv); the test
    // also rejects NaN and the huge t of rays parallel to the stations.
    if (u > -1.f && u < (float)gu && v > -1.f && v < (float)gv) {
      const T* slab = slabs + (size_t)s * plane;
      const int iu0 = (int)floorf(u), iv0 = (int)floorf(v);
      float wu[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wu[a] = round_w(fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(
                            u, (float)(iu0 + a))))),
                        slab);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int iv = iv0 + b;
        if (iv < v_lo || iv >= v_hi) continue;
        const float w_v =
            fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(v, (float)iv))));
        float tmp[NC];
#pragma unroll
        for (int ch = 0; ch < NC; ++ch) tmp[ch] = 0.f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int iu = iu0 + a;
          if (iu < 0 || iu >= gu) continue;
          const V* px =
              reinterpret_cast<const V*>(slab + (iu * gv + iv) * c);
          alignas(16) V buf[NV];
#pragma unroll
          for (int j = 0; j < NV; ++j)
            buf[j] = (!GENERIC || j * E < c) ? __ldg(px + j) : V();
          const T* x = reinterpret_cast<const T*>(buf);
#pragma unroll
          for (int ch = 0; ch < NC; ++ch)
            if (!GENERIC || ch < c)
              tmp[ch] = __fadd_rn(tmp[ch], __fmul_rn(wu[a], to_f(x[ch])));
        }
#pragma unroll
        for (int ch = 0; ch < NC; ++ch)
          acc[ch] = __fadd_rn(acc[ch], __fmul_rn(tmp[ch], w_v));
      }
    }
    float* o = out + (size_t)s * c * n + r;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
      if (!GENERIC || ch < c) o[(size_t)ch * n] = acc[ch];
  }
}

struct Args {
  const void* slabs;
  const float* rays;
  const int* v_base;
  float* out;
  int n, s_total, gu, gv, c, wv, tile_n, spt;
  float inv_k;
  cudaStream_t st;
};

template <typename T, int C, int VB, int SPT>
int launch(const Args& a) {
  if constexpr (VB < (int)sizeof(T)) {
    return cudaErrorInvalidValue;
  } else {
    const int runs = (a.s_total + SPT - 1) / SPT;
    dim3 grid((a.n + RAYS - 1) / RAYS, (runs + STATIONS - 1) / STATIONS);
    sweep_fwd_kernel<T, C, VB, SPT><<<grid, dim3(RAYS, STATIONS), 0, a.st>>>(
        static_cast<const T*>(a.slabs), a.rays, a.v_base, a.out, a.n,
        a.s_total, a.gu, a.gv, a.c, a.inv_k, a.wv, a.tile_n);
    return cudaGetLastError();
  }
}

template <typename T, int C, int VB>
int launch_spt(const Args& a) {
  switch (a.spt) {
    case 1: return launch<T, C, VB, 1>(a);
    case 8: return launch<T, C, VB, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int C>
int launch_vb(const Args& a, int vec_bytes) {
  switch (vec_bytes) {
    case 16: return launch_spt<T, C, 16>(a);
    case 8: return launch_spt<T, C, 8>(a);
    case 4: return launch_spt<T, C, 4>(a);
    case 2: return launch_spt<T, C, 2>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_c(const Args& a, int vec_bytes) {
  switch (a.c) {
    case 1: return launch_vb<T, 1>(a, vec_bytes);
    case 5: return launch_vb<T, 5>(a, vec_bytes);
    case 11: return launch_vb<T, 11>(a, vec_bytes);
    case 14: return launch_vb<T, 14>(a, vec_bytes);
    default: return launch_vb<T, 0>(a, vec_bytes);
  }
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dvgo_sweep_fwd_max_channels() { return C_MAX; }

// slabs [S, Gu, Gv, C] contiguous (bf16 if slab_is_bf16 else f32), read
// in vec_bytes-wide loads: vec_bytes must divide C*elem and the slabs'
// address. rays [6, N] f32 rows (op, ou, ov, dp, du, dv) with dp != 0, out
// [S, C, N] f32. wv > 0 selects the windowed form: v_base [ceil(N /
// tile_n)] int32 window starts. Each thread takes stations_per_thread (1
// or 8) consecutive stations of its ray.
int dvgo_sweep_fwd(const void* slabs, int slab_is_bf16, const float* rays,
                   const int* v_base, float* out, int n, int s_total, int gu,
                   int gv, int c, int vec_bytes, int k, int wv, int tile_n,
                   int stations_per_thread, void* stream) {
  const int elem = slab_is_bf16 ? 2 : 4;
  if (c < 1 || c > C_MAX || n < 1 || s_total < 1 || k < 1 ||
      vec_bytes < elem || vec_bytes % elem != 0 ||
      (c * elem) % vec_bytes != 0 ||
      (long long)gu * gv * c >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(slabs) % vec_bytes != 0 ||
      (wv > 0 && (v_base == nullptr || tile_n < 1)))
    return cudaErrorInvalidValue;
  Args a{slabs, rays, v_base, out, n, s_total, gu, gv, c, wv, tile_n,
         stations_per_thread, 1.f / (float)k,
         static_cast<cudaStream_t>(stream)};
  return slab_is_bf16 ? launch_c<__nv_bfloat16>(a, vec_bytes)
                      : launch_c<float>(a, vec_bytes);
}

}  // extern "C"
