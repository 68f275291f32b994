// Device code shared by the kernels that scatter station cotangents onto the
// permuted grid (sweep_bwd.cu, train_fused_bwd.cu) and by those that tap the
// station slabs: the hat weights, the bf16 rounding point and the (1-f)/f
// split of a station between the two grid slabs that bracket it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dvgo {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Hat weight of index i at coordinate x: max(0, 1 - |x - i|).
__device__ __forceinline__ float hat(float x, int i) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(x, (float)i))));
}

// Station s = z*k + j is (1 - j/k) of grid slab z plus j/k of slab z + 1.
struct SlabSplit {
  int z, j;
  float f_lo, f_hi;
};

__device__ __forceinline__ SlabSplit slab_split(int s, int k) {
  SlabSplit sp;
  sp.z = s / k;
  sp.j = s - sp.z * k;
  sp.f_hi = (float)((double)sp.j / (double)k);
  sp.f_lo = (float)(1.0 - (double)sp.j / (double)k);
  return sp;
}

// One tap's share of a station cotangent g: x = wu * rnd(wvv * g) (rnd rounds
// to bf16 when BF16), (1-f) of it onto px (grid slab z) and f of it onto
// px + slab_elems (slab z + 1, only when the station lies between slabs).
// Adds nothing when x is zero, so untouched voxels stay exactly zero.
template <bool BF16>
__device__ __forceinline__ void scatter_tap(float* px, size_t slab_elems,
                                            const SlabSplit& sp, float wu,
                                            float wvv, float g) {
  float rhs = __fmul_rn(wvv, g);
  if (BF16) rhs = round_bf16(rhs);
  const float x = __fmul_rn(wu, rhs);
  if (x == 0.f) return;
  atomicAdd(px, __fmul_rn(sp.f_lo, x));
  if (sp.j > 0) atomicAdd(px + slab_elems, __fmul_rn(sp.f_hi, x));
}

// Global reduction of VR (1 or 4) consecutive f32 values onto p (aligned
// to 4*VR bytes) as one operation: red.global.add(.v4).f32 (v4: sm_90).
template <int VR>
__device__ __forceinline__ void red_add(float* p, const float* x);

template <>
__device__ __forceinline__ void red_add<1>(float* p, const float* x) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(x[0])
               : "memory");
}

template <>
__device__ __forceinline__ void red_add<4>(float* p, const float* x) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3])
               : "memory");
}

}  // namespace dvgo
