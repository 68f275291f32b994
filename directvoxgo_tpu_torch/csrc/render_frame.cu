// Fused whole-frame renderer of the camera sweep: per intermediate-image
// pixel, march the station slabs front to back (density/mask warp, alpha,
// transmittance), and run the colour MLP on the tensor cores over the
// visible samples of a warp's pixels.
//
// Replaces: directvoxgo_tpu/ops/pallas_render4.py::render_frame_pallas4 (v4),
// directvoxgo_tpu/ops/pallas_render3.py::render_frame_pallas3 (v3) and
// directvoxgo_tpu/ops/pallas_render.py::render_frame_pallas (v1). Two
// compile-time switches give each its exact function:
//   view term: EMB (v4) computes layer 1's view half in f32 from the
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
// The geometry uses explicitly rounded operations: p and (u, v) are fused
// multiply-adds, as XLA contracts them in the JAX kernels, and nothing else
// is contracted. A one-ulp change of u can decide whether a tap at the
// slab's edge has a weight at all, and so whether the mask gate opens. The
// march is the first version's (csrc/render_frame_first.cu) line for line,
// so T and depth are bit-identical to it.
//
// Bound on the H100: the MLP's F*W + W*W + 3*W multiply-adds per visible
// sample (18.3k at lego width) at the bf16 tensor rate, plus ~40 f32
// operations per live (pixel, station) of the march; the frame's bytes take
// well under a millisecond. The first version ran the MLP per thread in
// f32 from a register array: a warp paid the whole MLP whenever any of its
// 32 pixels had a visible sample (at lego density 1-3 lanes live), and
// v4's W=128 instance spilled.
// Design: one block per 8x16 pixel tile (inside one 128x128 activity
// tile), one thread per pixel marching the stations; each warp owns two
// rows of 16 pixels (two groups). A visible sample appends, through a warp
// ballot, an entry to its group's queue in shared memory (the bf16 MLP
// features, w, the pixel's lane, k0[:3] in f32). When a group's queue may
// not take another station (more than QCAP - 16 entries), and at the end
// of the march, the warp flushes it: in tiles of 16 entries, layer 1 (K =
// F padded to 16), layer 2 (W x W) and layer 3 (W x 8, three columns used)
// as mma.sync.m16n8k16 bf16 x bf16 -> f32, the TPU kernels' arithmetic
// (bf16 operands, f32 accumulation) in another summation order. Layer 1's
// accumulators become layer 2's A fragments in registers (relu, bf16), and
// layer 2 runs one k-tile of layer 3 at a time, so no hidden layer touches
// shared memory. The weights sit in shared memory as bf16 B fragments,
// each lane's 8 bytes contiguous (packed on the host, ops/render_frame.py::
// pack_mlp_mma). v4 computes its view term emb . W1b + b1 per pixel, not
// per sample: one m16 MMA pass over the group's 16 pixels (their embedding
// held as A fragments in registers from the start, f32 accumulation), kept
// in shared memory until the warp's other group flushes, and added to
// layer 1's accumulator before the relu, as pallas_render4 does; v3 and v1
// read shared1 per entry. The colours go back to the queue, and each
// pixel's thread adds w*rgb in station order.
// mma.sync, not wgmma: a flush holds at most QCAP = 32 entries (two
// m16 tiles), far below wgmma's 64-row tiles. The block skips station
// blocks that the activity table marks empty and stops once every pixel of
// the tile has T < 1e-3 (both exact).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_V = 16;   // threads along v (columns, contiguous)
constexpr int TILE_U = 8;    // threads along u (rows)
constexpr int WARPS = TILE_U * TILE_V / 32;
constexpr int ACT_TILE = 128;
constexpr int S_BLK = 16;
constexpr int F_MAX = 16;
constexpr int E_MAX = 32;
constexpr float T_TERMINATE = 1e-3f;
constexpr float T_EPS = 1e-10f;
constexpr unsigned FULL = 0xffffffffu;

// Sample queue of one group (16 pixels) of a warp.
constexpr int QCAP = 32;     // entries
constexpr int FSTRIDE = 24;  // bf16 per feature row (48 bytes: no conflicts)

__device__ unsigned long long g_queue_stats[3];  // flushes, entries, tiles
__device__ int g_queue_count;

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

// Two f32 values as a bf16 pair (the first in the low half).
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// D = A . B + D, one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

struct Scalars {
  float op, ou, ov, inv_span, p_first, p_step, act_shift, interval_scale,
      fast_thres, near, far, bg;
};

// Shared memory of one warp: two group queues and (v4) the view cache.
template <int W, bool SHARED1>
struct WarpSmem {
  __nv_bfloat16 feat[2][QCAP][FSTRIDE];
  float w[2][QCAP];
  int slot[2][QCAP];
  float x[2][QCAP][4];       // k0[:3] in, rgb out
  float view[SHARED1 ? 1 : 16][W + 8];
};

template <int W, bool SHARED1>
__host__ __device__ constexpr size_t weights_bytes() {
  // b1, b2 [W], b3 [8] f32; fragments: w1a 1 x W/8, w1b 2 x W/8 (v4),
  // w2 W/16 x W/8, w3 W/16 x 1 tiles of 256 bytes.
  return (2 * W + 8) * 4 +
         256 * (W / 8 + (SHARED1 ? 0 : 2 * (W / 8)) + (W / 16) * (W / 8) +
                W / 16);
}

// The MLP of one group's queue: `n` entries of pixels `16*grp ..` of this
// warp (pixel row `row`, first column `col0`), colours back to q.x.
template <int W, bool SHARED1>
__device__ void flush(WarpSmem<W, SHARED1>& q, int grp, int n,
                      const float* __restrict__ b1,
                      const float* __restrict__ b2,
                      const float* __restrict__ b3, const uint2* f1,
                      const uint2* fe, const uint2* f2, const uint2* f3,
                      const uint32_t (&ea)[E_MAX / 16][4], int& cached,
                      const __nv_bfloat16* __restrict__ emb, int row,
                      int col0, int wi, int c0, int lane) {
  constexpr int NT = W / 8, KT = W / 16;
  const int g = lane >> 2, t4 = lane & 3;
  if (g_queue_count && lane == 0) {
    atomicAdd(&g_queue_stats[0], 1ull);
    atomicAdd(&g_queue_stats[1], (unsigned long long)n);
    atomicAdd(&g_queue_stats[2], (unsigned long long)((n + 15) / 16));
  }
  if constexpr (!SHARED1) {
    if (cached != grp) {
      // The view term of the group's 16 pixels (rows g and g+8 of `ea`),
      // kept until the other group of the warp flushes.
      cached = grp;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma(d, ea[0], fe[nt * 32 + lane]);
        mma(d, ea[1], fe[(NT + nt) * 32 + lane]);
        const int c = nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(&q.view[g][c]) =
            make_float2(d[0] + b1[c], d[1] + b1[c + 1]);
        *reinterpret_cast<float2*>(&q.view[g + 8][c]) =
            make_float2(d[2] + b1[c], d[3] + b1[c + 1]);
      }
      __syncwarp();
    }
  }
  for (int t0 = 0; t0 < n; t0 += 16) {
    const int r0 = t0 + g, r1 = r0 + 8;
    const bool v0 = r0 < n, v1 = r1 < n;
    uint32_t a1[4];
    {
      const uint32_t* fa = reinterpret_cast<const uint32_t*>(q.feat[grp][r0]);
      const uint32_t* fb = reinterpret_cast<const uint32_t*>(q.feat[grp][r1]);
      a1[0] = v0 ? fa[t4] : 0u;
      a1[1] = v1 ? fb[t4] : 0u;
      a1[2] = v0 ? fa[t4 + 4] : 0u;
      a1[3] = v1 ? fb[t4 + 4] : 0u;
    }
    const int s0 = v0 ? q.slot[grp][r0] & 15 : 0;
    const int s1 = v1 ? q.slot[grp][r1] & 15 : 0;
    // Layer 1 (+ view term, relu, bf16) into layer 2's A fragments.
    uint32_t h1[KT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma(d, a1, f1[nt * 32 + lane]);
      const int c = nt * 8 + 2 * t4;
      float2 va, vb;
      if constexpr (SHARED1) {
        const uint32_t* sh = reinterpret_cast<const uint32_t*>(emb);
        const size_t px = (size_t)row * wi + col0;
        va = unpack2(__ldg(sh + ((px + s0) * W + c) / 2));
        vb = unpack2(__ldg(sh + ((px + s1) * W + c) / 2));
      } else {
        va = *reinterpret_cast<const float2*>(&q.view[s0][c]);
        vb = *reinterpret_cast<const float2*>(&q.view[s1][c]);
      }
      h1[nt >> 1][2 * (nt & 1)] =
          pack2(fmaxf(d[0] + va.x, 0.f), fmaxf(d[1] + va.y, 0.f));
      h1[nt >> 1][2 * (nt & 1) + 1] =
          pack2(fmaxf(d[2] + vb.x, 0.f), fmaxf(d[3] + vb.y, 0.f));
    }
    // Layer 2, two n-tiles at a time (one k-tile of layer 3), then 3.
    float lg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k3 = 0; k3 < KT; ++k3) {
      uint32_t h2[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * k3 + half;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          mma(d, h1[kt], f2[(kt * NT + nt) * 32 + lane]);
        const int c = nt * 8 + 2 * t4;
        h2[2 * half] = pack2(fmaxf(d[0] + b2[c], 0.f),
                             fmaxf(d[1] + b2[c + 1], 0.f));
        h2[2 * half + 1] = pack2(fmaxf(d[2] + b2[c], 0.f),
                                 fmaxf(d[3] + b2[c + 1], 0.f));
      }
      mma(lg, h2, f3[k3 * 32 + lane]);
    }
    // Logits of rows r0 (lg[0..1]) and r1 (lg[2..3]), columns 2*t4 + 0/1.
    if (t4 < 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, c = 2 * t4 + (e & 1);
        if (c < 3 && r < n) {
          float l = lg[e] + b3[c];
          if (c0) l += q.x[grp][r][c];
          q.x[grp][r][c] = sigmoid(l);
        }
      }
    }
  }
  __syncwarp();
}

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
  constexpr size_t WB = weights_bytes<W, SHARED1>();
  const int f_mlp = f_k0 - c0;
  const int tid = threadIdx.y * TILE_V + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // Weights: b1, b2, b3, then the fragments (as packed by the host).
  const float* b1 = reinterpret_cast<const float*>(smem4);
  const float* b2 = b1 + W;
  const float* b3 = b2 + W;
  const uint2* f1 = reinterpret_cast<const uint2*>(b3 + 8);
  const uint2* fe = f1 + (W / 8) * 32;
  const uint2* f2 = fe + (SHARED1 ? 0 : 2 * (W / 8) * 32);
  const uint2* f3 = f2 + (W / 16) * (W / 8) * 32;
  WarpSmem<W, SHARED1>* qs = reinterpret_cast<WarpSmem<W, SHARED1>*>(
      reinterpret_cast<char*>(smem4) + WB);
  WarpSmem<W, SHARED1>& q = qs[warp];
  if (has_mlp) {
    const float4* src = reinterpret_cast<const float4*>(mlp);
    for (int k = tid; k < (int)(WB / 16); k += TILE_U * TILE_V)
      smem4[k] = src[k];
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
  // This warp's two pixel rows (groups), their first column.
  const int grp = lane >> 4;
  const int row0 = blockIdx.y * TILE_U + 2 * warp;
  const int col0 = blockIdx.x * TILE_V;
  int qn[2] = {0, 0};
  int cached = -1;    // the group whose view term q.view holds (v4)
  // v4: each group's view embedding as the A fragments of its 16 pixels
  // (rows g and g+8; E zero-padded to 32), loaded once.
  uint32_t ea[2][E_MAX / 16][4] = {};
  if constexpr (!SHARED1) {
    if (has_mlp) {
      const unsigned short* e16 =
          reinterpret_cast<const unsigned short*>(emb);
      const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
#pragma unroll
        for (int kt = 0; kt < E_MAX / 16; ++kt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const size_t base =
                ((size_t)(row0 + gi) * wi + col0 + g + 8 * (r & 1)) * e_dim;
            const int k = kt * 16 + 2 * t4 + (r >= 2 ? 8 : 0);
            const uint32_t lo = k < e_dim ? e16[base + k] : 0u;
            const uint32_t hi = k + 1 < e_dim ? e16[base + k + 1] : 0u;
            ea[gi][kt][r] = lo | (hi << 16);
          }
        }
      }
    }
  }

  float t_cum = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f;
  // Adds the colours of group `gi`'s flushed queue to its pixels, in queue
  // order (for each pixel, its stations' order).
  auto drain = [&](int gi) {
    flush<W, SHARED1>(q, gi, qn[gi], b1, b2, b3, f1, fe, f2, f3, ea[gi],
                      cached, emb, row0 + gi, col0, wi, c0, lane);
    if (grp == gi) {
      for (int r = 0; r < qn[gi]; ++r) {
        if (q.slot[gi][r] != lane) continue;
        const float w = q.w[gi][r];
        acc_r = __fmaf_rn(w, q.x[gi][r][0], acc_r);
        acc_g = __fmaf_rn(w, q.x[gi][r][1], acc_g);
        acc_b = __fmaf_rn(w, q.x[gi][r][2], acc_b);
      }
    }
    __syncwarp();
    qn[gi] = 0;
  };

  for (int sb = 0; sb < nsb; ++sb) {
    if (!act[sb]) continue;                          // block-uniform
    if (!__syncthreads_or(inb && t_cum >= T_TERMINATE)) break;
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
      const bool ok = inb && t_px >= sc.near && t_px <= sc.far &&
                      maskv > 0.f && alpha > sc.fast_thres &&
                      t_cum >= T_TERMINATE;
      const float a_s = ok ? alpha : 0.f;
      const float w = __fmul_rn(t_cum, a_s);
      t_cum = __fmul_rn(t_cum, __fadd_rn(__fsub_rn(1.f, a_s), T_EPS));
      const bool vis = w > 0.f;

      float cl[F_MAX];
#pragma unroll
      for (int c = 0; c < F_MAX; ++c) cl[c] = 0.f;
      if (vis && d_k0 != nullptr) {
        // One axis contracted per tap of the other, rounded to bf16, then
        // the other axis: v first (v3, v4) or u first (v1).
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
      }
      if (vis) acc_d += w * dist;
      if (!has_mlp) {
        if (vis) {
          float cr = 0.5f, cg = 0.5f, cb = 0.5f;
          if (d_k0 != nullptr) {
            cr = sigmoid(cl[0]);
            cg = sigmoid(cl[1]);
            cb = sigmoid(cl[2]);
          }
          acc_r = __fmaf_rn(w, cr, acc_r);
          acc_g = __fmaf_rn(w, cg, acc_g);
          acc_b = __fmaf_rn(w, cb, acc_b);
        }
        continue;
      }
      // Queue the visible sample in its group's queue (warp ballot).
      const unsigned m = __ballot_sync(FULL, vis);
      if (vis) {
        const unsigned gm = m >> (16 * grp) & 0xffffu;
        const int r = (grp ? qn[1] : qn[0]) +
                      __popc(gm & ((1u << (lane & 15)) - 1u));
        uint32_t fw[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float x2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qq = 2 * k + e;
            // (compile-time register indices: c0 is 0 or 3)
            const float x = c0 ? (qq + 3 < F_MAX ? cl[qq + 3] : 0.f)
                               : cl[qq];
            x2[e] = qq < f_mlp ? x : 0.f;
          }
          fw[k] = pack2(x2[0], x2[1]);
        }
        uint4* dst = reinterpret_cast<uint4*>(q.feat[grp][r]);
        dst[0] = make_uint4(fw[0], fw[1], fw[2], fw[3]);
        dst[1] = make_uint4(fw[4], fw[5], fw[6], fw[7]);
        q.w[grp][r] = w;
        q.slot[grp][r] = lane;
        q.x[grp][r][0] = cl[0];
        q.x[grp][r][1] = cl[1];
        q.x[grp][r][2] = cl[2];
      }
      qn[0] += __popc(m & 0xffffu);
      qn[1] += __popc(m >> 16);
      __syncwarp();
#pragma unroll
      for (int gi = 0; gi < 2; ++gi)
        if (qn[gi] > QCAP - 16) drain(gi);
    }
  }
  if (has_mlp) {
#pragma unroll
    for (int gi = 0; gi < 2; ++gi)
      if (qn[gi] > 0) drain(gi);
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
  const size_t smem = has_mlp ? weights_bytes<W, SHARED1>() +
                                    WARPS * sizeof(WarpSmem<W, SHARED1>)
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

// Copies the sample-queue counters (flushes, queued samples, MMA tiles)
// since the last call into out[0..2] (when out is not null), zeroes them,
// and counts from here on while `enable`. Synchronous.
int dvgo_render_frame_queue_stats(int enable, long long* out) {
  unsigned long long v[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(v, g_queue_stats, sizeof(v));
  if (err != cudaSuccess) return (int)err;
  if (out)
    for (int k = 0; k < 3; ++k) out[k] = (long long)v[k];
  const unsigned long long zero[3] = {0, 0, 0};
  err = cudaMemcpyToSymbol(g_queue_stats, zero, sizeof(zero));
  if (err != cudaSuccess) return (int)err;
  const int on = enable ? 1 : 0;
  return (int)cudaMemcpyToSymbol(g_queue_count, &on, sizeof(on));
}

// d_geo [S, Gu, Gv, 2] bf16, d_k0 [S, Gu, Gv, F] bf16 (or null),
// emb [Hi, Wi, E] bf16 (shared1: [Hi, Wi, width] bf16 with e_dim 0; null
// without an MLP), dnorm/dclip [Hi, Wi] f32, ur [Hi], vr [Wi] f32, mlp: the
// packed weights of ops/render_frame.py::pack_mlp_mma, 16-byte aligned (or
// null), activity [Hi/128, Wi/128, S/16] i32; outputs rgb [3, Hi, Wi],
// depth and T [Hi, Wi] f32. Hi and Wi are multiples of 128, S of 16; the
// MLP width is 32, 64 or 128. u_first with an MLP needs shared1 (the v1
// form).
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
      (has_mlp && c0 && f_k0 < 3) ||
      (has_mlp && reinterpret_cast<uintptr_t>(mlp) % 16) ||
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
