// Fused whole-frame renderer of the camera sweep: per intermediate-image
// pixel, march the station slabs front to back (density/mask warp, alpha,
// transmittance, the colour MLP where a sample is visible).
//
// Replaces: directvoxgo_tpu/ops/pallas_render4.py::render_frame_pallas4 (v4),
// directvoxgo_tpu/ops/pallas_render3.py::render_frame_pallas3 (v3) and
// directvoxgo_tpu/ops/pallas_render.py::render_frame_pallas (v1). Two
// compile-time switches give each its exact function:
//   view term: EMB (v4) recomputes layer 1's view half in f32 from the
//     per-pixel embedding, emb . W1b + b1; SHARED1 (v3, v1) takes that half
//     as a bf16 input shared1 [Hi, Wi, W] and adds it widened to f32.
//   k0 order: V_FIRST (v4, v3) contracts the colour slab along v first,
//     U_FIRST (v1) along u first, as the geometry warp does.
//
// Per pixel (i, j) and station s (lam = (p_s - op) * inv_span):
//   u = ou + lam*(ur[i] - ou), v = ov + lam*(vr[j] - ov)
//   hat taps au, av (two per axis, rounded to bf16, zero off the slab)
//   density/mask = sum_b av_b * bf16(sum_a au_a * D[s, u_a, v_b])
//   alpha = 1 - exp(-softplus(density + act_shift) * dnorm * interval_scale)
//   ok = near <= lam*dclip <= far && mask > 0 && alpha > fast_thres
//        && T >= 1e-3;  w = T * (ok ? alpha : 0)
//   if w > 0: k0_c = sum_a au_a * bf16(sum_b av_b * K[s, u_a, v_b, c])
//             (U_FIRST: sum_b av_b * bf16(sum_a au_a * K[s, u_a, v_b, c]));
//             h1 = bf16(relu(k0[c0:] . W1a + (emb . W1b + b1)))
//             (SHARED1: bf16(relu(k0[c0:] . W1a + f32(shared1))));
//             h2 = bf16(relu(h1 . W2 + b2)); logit = h2 . W3 + b3 (+k0[:3])
//             rgb += w * sigmoid(logit); depth += w * lam * dnorm
//   T *= (1 - alpha) + 1e-10
// All products of two bf16 values are exact in f32, so the warps round
// exactly where the Pallas matmuls do. The geometry uses explicitly
// rounded operations: p and (u, v) are fused multiply-adds, as XLA
// contracts them in the JAX kernels, and nothing else is contracted. A
// one-ulp change of u can decide whether a tap at the slab's edge has a
// weight at all, and so whether the mask gate opens.
//
// Bound on the H100: the MLP. Every visible sample costs
// F*W + W*W + 3*W multiply-adds (18.3k at lego width), against ~16 bytes
// of slab reads per station for the geometry; the frame's bytes (slabs
// once, the per-pixel inputs once, rgb/depth/T once) take well under a
// millisecond at 3.35 TB/s, so the kernel is bound by the MLP's
// operations, which it runs on the f32 FMA units (67 TFLOP/s) rather than
// the tensor cores.
// Design: one block per 8x16 pixel tile (inside one 128x128 activity
// tile), one thread per pixel marching all stations. The MLP weights sit
// in dynamic shared memory as f32 (87.6 KB at lego width, read as
// broadcast float4s); each thread keeps its hidden layer in registers.
// The block skips station blocks that the activity table marks empty and
// stops once every pixel of the tile has T < 1e-3 (both exact). Moving the
// MLP onto wgmma over the block's visible samples is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_V = 16;   // threads along v (columns, contiguous)
constexpr int TILE_U = 8;    // threads along u (rows)
constexpr int ACT_TILE = 128;
constexpr int S_BLK = 16;
constexpr int F_MAX = 16;
constexpr int E_MAX = 32;
constexpr float T_TERMINATE = 1e-3f;
constexpr float T_EPS = 1e-10f;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Hat weight of coordinate x at integer index i, rounded to bf16.
__device__ __forceinline__ float hat(float x, float i) {
  return bf(fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(x, i)))));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Scalars {
  float op, ou, ov, inv_span, p_first, p_step, act_shift, interval_scale,
      fast_thres, near, far, bg;
};

template <int W, bool SHARED1, bool U_FIRST>
__global__ void __launch_bounds__(TILE_U * TILE_V)
render_frame_kernel(const __nv_bfloat16* __restrict__ d_geo,
                    const __nv_bfloat16* __restrict__ d_k0,
                    const __nv_bfloat16* __restrict__ emb,
                    const float* __restrict__ dnorm,
                    const float* __restrict__ dclip,
                    const float* __restrict__ ur,
                    const float* __restrict__ vr,
                    const float* __restrict__ mlp,
                    const int* __restrict__ activity,
                    float* __restrict__ out_rgb, float* __restrict__ out_depth,
                    float* __restrict__ out_t, int s_total, int gu, int gv,
                    int hi, int wi, int f_k0, int c0, int e_dim, int has_mlp,
                    Scalars sc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int f_mlp = f_k0 - c0;
  // Shared layout (floats): w1a [F, W], w1bt [W, E4] (E padded to a
  // multiple of 4 with zeros), b1 [W], b2 [W], w2t [W, W], w3 [W, 3],
  // b3 [3]; every block offset is a multiple of 4. SHARED1: E is 0 and b1
  // is not read.
  const int e_pad = (e_dim + 3) / 4 * 4;
  const float* w1a = smem;
  const float* w1bt = w1a + f_mlp * W;
  const float* b1 = w1bt + e_pad * W;
  const float* b2 = b1 + W;
  const float* w2t = b2 + W;
  const float* w3 = w2t + W * W;
  const float* b3 = w3 + 3 * W;
  const int tid = threadIdx.y * TILE_V + threadIdx.x;
  if (has_mlp) {
    const int n = (f_mlp + e_pad + 2 + W + 3) * W + 3;
    for (int k = tid; k < n; k += TILE_U * TILE_V) smem[k] = mlp[k];
  }
  __syncthreads();

  const int j = blockIdx.x * TILE_V + threadIdx.x;
  const int i = blockIdx.y * TILE_U + threadIdx.y;
  const bool inb = i < hi && j < wi;
  const int pix = inb ? i * wi + j : 0;
  const float urv = inb ? ur[i] : 0.f, vrv = inb ? vr[j] : 0.f;
  const float dn = inb ? dnorm[pix] : 0.f, dc = inb ? dclip[pix] : 0.f;
  const float interval = __fmul_rn(dn, sc.interval_scale);
  const int nsb = s_total / S_BLK;
  const int ti = (blockIdx.y * TILE_U) / ACT_TILE;
  const int tj = (blockIdx.x * TILE_V) / ACT_TILE;
  const int* act = activity + ((size_t)ti * (wi / ACT_TILE) + tj) * nsb;
  const size_t slab = (size_t)gu * gv;

  float t_cum = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f;
  for (int sb = 0; sb < nsb; ++sb) {
    if (!act[sb]) continue;                          // block-uniform
    if (!__syncthreads_or(inb && t_cum >= T_TERMINATE)) break;
    if (!inb) continue;
    for (int jj = 0; jj < S_BLK; ++jj) {
      const int s = sb * S_BLK + jj;
      const float p = __fmaf_rn(sc.p_step, (float)s, sc.p_first);
      const float lam = __fmul_rn(__fsub_rn(p, sc.op), sc.inv_span);
      const float u = __fmaf_rn(lam, __fsub_rn(urv, sc.ou), sc.ou);
      const float v = __fmaf_rn(lam, __fsub_rn(vrv, sc.ov), sc.ov);
      const float fu0 = floorf(u), fv0 = floorf(v);
      const int iu[2] = {(int)fu0, (int)fu0 + 1};
      const int iv[2] = {(int)fv0, (int)fv0 + 1};
      float au[2], av[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        au[a] = (iu[a] >= 0 && iu[a] < gu) ? hat(u, fu0 + a) : 0.f;
        av[a] = (iv[a] >= 0 && iv[a] < gv) ? hat(v, fv0 + a) : 0.f;
      }
      // u-contraction per tap column, rounded to bf16, then v.
      float density = 0.f, maskv = 0.f;
      const __nv_bfloat16* g = d_geo + (size_t)s * slab * 2;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (av[b] == 0.f) continue;
        float td = 0.f, tm = 0.f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (au[a] == 0.f) continue;
          const __nv_bfloat16* px = g + ((size_t)iu[a] * gv + iv[b]) * 2;
          td = __fadd_rn(td, __fmul_rn(au[a], ld(px)));
          tm = __fadd_rn(tm, __fmul_rn(au[a], ld(px + 1)));
        }
        density = __fadd_rn(density, __fmul_rn(av[b], bf(td)));
        maskv = __fadd_rn(maskv, __fmul_rn(av[b], bf(tm)));
      }
      const float alpha = __fsub_rn(
          1.f, expf(__fmul_rn(-softplus(__fadd_rn(density, sc.act_shift)),
                              interval)));
      const float dist = __fmul_rn(lam, dn);
      const float t_px = __fmul_rn(lam, dc);
      const bool ok = t_px >= sc.near && t_px <= sc.far && maskv > 0.f &&
                      alpha > sc.fast_thres && t_cum >= T_TERMINATE;
      const float a_s = ok ? alpha : 0.f;
      const float w = __fmul_rn(t_cum, a_s);
      t_cum = __fmul_rn(t_cum, __fadd_rn(__fsub_rn(1.f, a_s), T_EPS));
      if (!(w > 0.f)) continue;

      float cr = 0.5f, cg = 0.5f, cb = 0.5f;
      if (d_k0 != nullptr) {
        // One axis contracted per tap of the other, rounded to bf16, then
        // the other axis: v first (v3, v4) or u first (v1).
        float cl[F_MAX];
#pragma unroll
        for (int c = 0; c < F_MAX; ++c) cl[c] = 0.f;
        const __nv_bfloat16* kk = d_k0 + (size_t)s * slab * f_k0;
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const float w_out = U_FIRST ? av[o] : au[o];
          if (w_out == 0.f) continue;
          float tp[F_MAX];
#pragma unroll
          for (int c = 0; c < F_MAX; ++c) tp[c] = 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float w_in = U_FIRST ? au[n] : av[n];
            if (w_in == 0.f) continue;
            const int a = U_FIRST ? n : o, b = U_FIRST ? o : n;
            const __nv_bfloat16* px =
                kk + ((size_t)iu[a] * gv + iv[b]) * f_k0;
#pragma unroll
            for (int c = 0; c < F_MAX; ++c)
              if (c < f_k0)
                tp[c] = __fadd_rn(tp[c], __fmul_rn(w_in, ld(px + c)));
          }
#pragma unroll
          for (int c = 0; c < F_MAX; ++c)
            cl[c] = __fadd_rn(cl[c], __fmul_rn(w_out, bf(tp[c])));
        }
        if (has_mlp) {
          // Layer 1: h = bf16(relu(k0 . W1a + view term)).
          float h[W];
#pragma unroll
          for (int k = 0; k < W; ++k) h[k] = 0.f;
#pragma unroll
          for (int q = 0; q < F_MAX; ++q) {
            if (q >= f_mlp) break;
            // (compile-time register indices: c0 is 0 or 3)
            const float x =
                bf(c0 ? (q + 3 < F_MAX ? cl[q + 3] : 0.f) : cl[q]);
            const float4* row = reinterpret_cast<const float4*>(w1a + q * W);
#pragma unroll
            for (int k = 0; k < W / 4; ++k) {
              const float4 wq = row[k];
              h[4 * k] += x * wq.x;
              h[4 * k + 1] += x * wq.y;
              h[4 * k + 2] += x * wq.z;
              h[4 * k + 3] += x * wq.w;
            }
          }
          if constexpr (SHARED1) {
            // shared1 [Hi, Wi, W] bf16, eight values per 16-byte load.
            const uint4* s8 =
                reinterpret_cast<const uint4*>(emb + (size_t)pix * W);
#pragma unroll
            for (int q = 0; q < W / 8; ++q) {
              const uint4 raw = s8[q];
              const __nv_bfloat162* p2 =
                  reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                const float2 f = __bfloat1622float2(p2[t]);
                const int k = 8 * q + 2 * t;
                h[k] = bf(fmaxf(h[k] + f.x, 0.f));
                h[k + 1] = bf(fmaxf(h[k + 1] + f.y, 0.f));
              }
            }
          } else {
            float em[E_MAX];
            const __nv_bfloat16* e = emb + (size_t)pix * e_dim;
#pragma unroll
            for (int q = 0; q < E_MAX; ++q)
              em[q] = q < e_dim ? ld(e + q) : 0.f;
            const int e4 = (e_dim + 3) / 4;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              const float4* row =
                  reinterpret_cast<const float4*>(w1bt) + k * e4;
              float sh = 0.f;
#pragma unroll
              for (int q = 0; q < E_MAX / 4; ++q) {
                if (q >= e4) break;
                const float4 wq = row[q];
                sh += em[4 * q] * wq.x;
                sh += em[4 * q + 1] * wq.y;
                sh += em[4 * q + 2] * wq.z;
                sh += em[4 * q + 3] * wq.w;
              }
              h[k] = bf(fmaxf(h[k] + (sh + b1[k]), 0.f));
            }
          }
          // Layers 2 and 3, one hidden unit of layer 2 at a time.
          float l0 = 0.f, l1 = 0.f, l2 = 0.f;
          for (int o = 0; o < W; ++o) {
            const float4* row = reinterpret_cast<const float4*>(w2t + o * W);
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < W / 4; ++k) {
              const float4 wq = row[k];
              acc += h[4 * k] * wq.x;
              acc += h[4 * k + 1] * wq.y;
              acc += h[4 * k + 2] * wq.z;
              acc += h[4 * k + 3] * wq.w;
            }
            const float h2 = bf(fmaxf(acc + b2[o], 0.f));
            l0 += h2 * w3[3 * o];
            l1 += h2 * w3[3 * o + 1];
            l2 += h2 * w3[3 * o + 2];
          }
          l0 += b3[0];
          l1 += b3[1];
          l2 += b3[2];
          if (c0) {
            l0 += cl[0];
            l1 += cl[1];
            l2 += cl[2];
          }
          cr = sigmoid(l0);
          cg = sigmoid(l1);
          cb = sigmoid(l2);
        } else {
          cr = sigmoid(cl[0]);
          cg = sigmoid(cl[1]);
          cb = sigmoid(cl[2]);
        }
      }
      acc_r += w * cr;
      acc_g += w * cg;
      acc_b += w * cb;
      acc_d += w * dist;
    }
  }
  if (!inb) return;
  const size_t plane = (size_t)hi * wi;
  out_rgb[pix] = acc_r + t_cum * sc.bg;
  out_rgb[plane + pix] = acc_g + t_cum * sc.bg;
  out_rgb[2 * plane + pix] = acc_b + t_cum * sc.bg;
  out_depth[pix] = acc_d;
  out_t[pix] = t_cum;
}

template <int W, bool SHARED1, bool U_FIRST>
int launch(const void* d_geo, const void* d_k0, const void* emb,
           const float* dnorm, const float* dclip, const float* ur,
           const float* vr, const float* mlp, const int* activity,
           float* rgb, float* depth, float* tcum, int s_total, int gu, int gv,
           int hi, int wi, int f_k0, int c0, int e_dim, int has_mlp,
           Scalars sc, cudaStream_t st) {
  const int f_mlp = f_k0 - c0;
  const int e_pad = (e_dim + 3) / 4 * 4;
  const size_t smem =
      has_mlp ? ((size_t)(f_mlp + e_pad + 2 + W + 3) * W + 4) * sizeof(float)
              : 0;
  auto kernel = render_frame_kernel<W, SHARED1, U_FIRST>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(TILE_V, TILE_U);
  dim3 grid(wi / TILE_V, hi / TILE_U);
  kernel<<<grid, block, smem, st>>>(
      static_cast<const __nv_bfloat16*>(d_geo),
      static_cast<const __nv_bfloat16*>(d_k0),
      static_cast<const __nv_bfloat16*>(emb), dnorm, dclip, ur, vr, mlp,
      activity, rgb, depth, tcum, s_total, gu, gv, hi, wi, f_k0, c0, e_dim,
      has_mlp, sc);
  return (int)cudaGetLastError();
}

// The three forms: v4 (emb, v first), v3 (shared1, v first) and v1
// (shared1, u first). Without an MLP the view term is unused, so u first
// takes v1's instance.
template <int W>
int launch_form(int shared1, int u_first, const void* d_geo,
                const void* d_k0, const void* emb, const float* dnorm,
                const float* dclip, const float* ur, const float* vr,
                const float* mlp, const int* activity, float* rgb,
                float* depth, float* tcum, int s_total, int gu, int gv,
                int hi, int wi, int f_k0, int c0, int e_dim, int has_mlp,
                Scalars sc, cudaStream_t st) {
  if (u_first)
    return launch<W, true, true>(d_geo, d_k0, emb, dnorm, dclip, ur, vr, mlp,
                                 activity, rgb, depth, tcum, s_total, gu, gv,
                                 hi, wi, f_k0, c0, e_dim, has_mlp, sc, st);
  if (shared1)
    return launch<W, true, false>(d_geo, d_k0, emb, dnorm, dclip, ur, vr,
                                  mlp, activity, rgb, depth, tcum, s_total,
                                  gu, gv, hi, wi, f_k0, c0, e_dim, has_mlp,
                                  sc, st);
  return launch<W, false, false>(d_geo, d_k0, emb, dnorm, dclip, ur, vr, mlp,
                                 activity, rgb, depth, tcum, s_total, gu, gv,
                                 hi, wi, f_k0, c0, e_dim, has_mlp, sc, st);
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dvgo_render_frame_max_features() { return F_MAX; }
int dvgo_render_frame_max_emb() { return E_MAX; }

// d_geo [S, Gu, Gv, 2] bf16, d_k0 [S, Gu, Gv, F] bf16 (or null),
// emb [Hi, Wi, E] bf16 (shared1: [Hi, Wi, width] bf16 with e_dim 0; null
// without an MLP), dnorm/dclip [Hi, Wi] f32, ur [Hi], vr [Wi] f32, mlp: the
// packed f32 weights (or null), activity [Hi/128, Wi/128, S/16] i32;
// outputs rgb [3, Hi, Wi], depth and T [Hi, Wi] f32. Hi and Wi are
// multiples of 128, S of 16; the MLP width is 32, 64 or 128. u_first with
// an MLP needs shared1 (the v1 form).
int dvgo_render_frame(const void* d_geo, const void* d_k0, const void* emb,
                      const float* dnorm, const float* dclip, const float* ur,
                      const float* vr, const float* mlp, const int* activity,
                      float* rgb, float* depth, float* tcum, int s_total,
                      int gu, int gv, int hi, int wi, int f_k0, int c0,
                      int e_dim, int width, int has_mlp, int shared1,
                      int u_first, float op, float ou,
                      float ov, float inv_span, float p_first, float p_step,
                      float act_shift, float interval_scale, float fast_thres,
                      float near, float far, float bg, void* stream) {
  if (hi % ACT_TILE || wi % ACT_TILE || s_total % S_BLK || s_total < 1 ||
      gu < 1 || gv < 1 || f_k0 > F_MAX || e_dim > E_MAX ||
      (has_mlp && (d_k0 == nullptr || f_k0 - c0 < 1)) ||
      (has_mlp && shared1 && e_dim != 0) || (has_mlp && u_first && !shared1))
    return (int)cudaErrorInvalidValue;
  Scalars sc{op,        ou,        ov,     inv_span,       p_first,
             p_step,    act_shift, interval_scale, fast_thres, near,
             far,       bg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!has_mlp) width = 32;  // shared memory and registers unused
  switch (width) {
    case 32:
      return launch_form<32>(shared1, u_first, d_geo, d_k0, emb, dnorm,
                             dclip, ur, vr, mlp, activity, rgb, depth, tcum,
                             s_total, gu, gv, hi, wi, f_k0, c0, e_dim,
                             has_mlp, sc, st);
    case 64:
      return launch_form<64>(shared1, u_first, d_geo, d_k0, emb, dnorm,
                             dclip, ur, vr, mlp, activity, rgb, depth, tcum,
                             s_total, gu, gv, hi, wi, f_k0, c0, e_dim,
                             has_mlp, sc, st);
    case 128:
      return launch_form<128>(shared1, u_first, d_geo, d_k0, emb, dnorm,
                              dclip, ur, vr, mlp, activity, rgb, depth, tcum,
                              s_total, gu, gv, hi, wi, f_k0, c0, e_dim,
                              has_mlp, sc, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
