// FIRST VERSION of kernel K-A, kept unchanged beside its redesign
// (sweep_fwd.cu) as the yardstick that chip_smoke.py times it against. The
// port never loads it.
//
// Station-sweep forward: per ray and station, a bilinear tap of C channels
// of the station slab.
//
// Replaces: directvoxgo_tpu/ops/pallas_sweep_train.py::sweep_fwd_pallas
// (the full-Gv form and, with v_base/wv, the per-ray-tile v-windowed form).
//
// For ray n at station s (axis coordinate p = s/k):
//   t = (p - op) / dp,  u = ou + t*du,  v = ov + t*dv
//   out[s, c, n] = sum_v wv(v) * sum_u wu(u) * slab[s, u, v, c]
// with hat weights w(x, i) = max(0, 1 - |x - i|) (wu rounded to the slab
// dtype, wv kept f32, as the Pallas kernel and the XLA scan do). A
// coordinate in (-1, 0) still weights index 0; taps outside the slab read
// zero (no clamping). Windowed (wv > 0): ray n of tile n / tile_n reads only
// v in [v_base[tile], v_base[tile] + wv); its other taps read zero.
//
// Bound on the H100: the TPU version is a dense [Gu] x [Gu, Gv*C] matmul per
// ray and station because gathers are slow there; here only the 4 nonzero
// taps are read. The work per (ray, station) is 4*C loads and ~6*C flops, so
// the kernel is bound by memory traffic. The bytes it must move are the
// slabs once plus the [S, C, N] f32 output once, and the output dominates.
// Design: one thread per ray, looping over a block of S_BLK stations
// (blockIdx.y), so stores of out[s, c, :] are coalesced over rays and a
// station's slab stays hot in L2 across the ray blocks that read it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C_MAX = 16;
constexpr int THREADS = 128;
constexpr int S_BLK = 8;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

// Hat weight rounded to the slab dtype (the interp dtype of the sweep).
__device__ __forceinline__ float round_w(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}
__device__ __forceinline__ float round_w(float w, const float*) { return w; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
sweep_fwd_kernel(const T* __restrict__ slabs, const float* __restrict__ rays,
                 const int* __restrict__ v_base, float* __restrict__ out,
                 int n, int s_total, int gu, int gv, int c, float inv_k,
                 int wv, int tile_n) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= n) return;
  const float op = rays[r], ou = rays[n + r], ov = rays[2 * n + r];
  const float dp = rays[3 * n + r], du = rays[4 * n + r],
              dv = rays[5 * n + r];
  int v_lo = 0, v_hi = gv;
  if (wv > 0) {
    v_lo = v_base[r / tile_n];
    v_hi = min(v_lo + wv, gv);
  }
  const int s0 = blockIdx.y * S_BLK;
  const int s1 = min(s0 + S_BLK, s_total);
  const size_t slab_elems = (size_t)gu * gv * c;
  for (int s = s0; s < s1; ++s) {
    const float t = __fdiv_rn(__fsub_rn(__fmul_rn((float)s, inv_k), op), dp);
    // (u, v) as fused multiply-adds, as XLA contracts them in JAX.
    const float u = __fmaf_rn(t, du, ou);
    const float v = __fmaf_rn(t, dv, ov);
    float acc[C_MAX];
#pragma unroll
    for (int ch = 0; ch < C_MAX; ++ch) acc[ch] = 0.f;
    // Nonzero hat support needs u in (-1, gu) and v in (-1, gv); the test
    // also rejects NaN and the huge t of rays parallel to the stations.
    if (u > -1.f && u < (float)gu && v > -1.f && v < (float)gv) {
      const T* slab = slabs + (size_t)s * slab_elems;
      const int iu0 = (int)floorf(u), iv0 = (int)floorf(v);
      float wu[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wu[a] = round_w(
            fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(u, (float)(iu0 + a))))),
            slab);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int iv = iv0 + b;
        if (iv < v_lo || iv >= v_hi) continue;
        const float wv =
            fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(v, (float)iv))));
        float tmp[C_MAX];
#pragma unroll
        for (int ch = 0; ch < C_MAX; ++ch) tmp[ch] = 0.f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int iu = iu0 + a;
          if (iu < 0 || iu >= gu) continue;
          const T* px = slab + ((size_t)iu * gv + iv) * c;
#pragma unroll
          for (int ch = 0; ch < C_MAX; ++ch)
            if (ch < c)
              tmp[ch] = __fadd_rn(tmp[ch], __fmul_rn(wu[a], to_f(px[ch])));
        }
#pragma unroll
        for (int ch = 0; ch < C_MAX; ++ch)
          acc[ch] = __fadd_rn(acc[ch], __fmul_rn(tmp[ch], wv));
      }
    }
    float* o = out + (size_t)s * c * n + r;
#pragma unroll
    for (int ch = 0; ch < C_MAX; ++ch)
      if (ch < c) o[(size_t)ch * n] = acc[ch];
  }
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dvgo_sweep_fwd_max_channels() { return C_MAX; }

// slabs [S, Gu, Gv, C] (bf16 if slab_is_bf16 else f32), rays [6, N] f32
// rows (op, ou, ov, dp, du, dv) with dp != 0, out [S, C, N] f32. wv > 0
// selects the windowed form: v_base [ceil(N / tile_n)] int32 window starts.
int dvgo_sweep_fwd(const void* slabs, int slab_is_bf16, const float* rays,
                   const int* v_base, float* out, int n, int s_total, int gu,
                   int gv, int c, int k, int wv, int tile_n, void* stream) {
  if (c < 1 || c > C_MAX || n < 1 || s_total < 1 ||
      (wv > 0 && (v_base == nullptr || tile_n < 1)))
    return cudaErrorInvalidValue;
  dim3 grid((n + THREADS - 1) / THREADS, (s_total + S_BLK - 1) / S_BLK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slab_is_bf16)
    sweep_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(slabs), rays, v_base, out, n,
        s_total, gu, gv, c, 1.f / (float)k, wv, tile_n);
  else
    sweep_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(slabs), rays, v_base, out, n, s_total, gu,
        gv, c, 1.f / (float)k, wv, tile_n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
