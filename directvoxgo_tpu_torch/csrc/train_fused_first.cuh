// The first version of the device code shared by the fused train-step
// kernels, kept beside their redesign (train_fused.cuh) as the yardstick of
// its time: built only by chip_smoke.py (train_fused_fwd_first.cu,
// train_fused_bwd_first.cu), never loaded by the port. Only the diagnostic
// modes (MODE_*) were added to it. The march of a ray over the stations
// (coordinates, window cells, bilinear taps of the bf16 slabs, alpha and the gates), the
// ring of gated samples a block collects, and the colour MLP's forward on a
// chunk of them with bf16 tensor-core tiles (m16n8k16, f32 sums).
//
// A block owns RAYS rays of one ray tile. Threads 0..RAYS-1 march one ray
// each, station by station; a sample whose weight passes fast_color_thres is
// pushed onto a ring in shared memory, and whenever CHUNK samples wait, all
// four warps run the MLP on them, 16 rows each, with the bf16 weights held in
// shared memory.
//
// Both kernels compute every gate with the same device functions on the same
// taps, so the backward sees the forward's alpha, T and gates bit for bit.
// Multiplications that feed an addition are written with explicit intrinsics
// so that the compiler does not contract them: the arithmetic is that of the
// plain PyTorch versions in ops/train_fused.py.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grid_scatter.cuh"

namespace dvgo_fused {

using dvgo::hat;
using dvgo::round_bf16;

constexpr int RAYS = 64;       // rays per block
constexpr int THREADS = 128;   // four warps
constexpr int CHUNK = 64;      // samples per MLP pass
constexpr int QCAP = 128;      // ring capacity: a waiting chunk + one push
constexpr int S_BLK = 8;       // stations per march block (window cells)
constexpr int KPAD = 16;       // MLP input / output columns, padded
constexpr int C_MAX = 16;      // slab channels (2 + k0), at most
constexpr int RAY_ROWS = 12;   // rows of rays16 the kernels read
constexpr float T_EPS = 1e-10f;
constexpr float T_TERMINATE = 1e-3f;

// Diagnostic forms (a bit mask; 0 is the kernel): no tensor-core products
// (their accumulators are set to a small constant, so that the epilogues and
// scatters after them still run), no per-sample global scatters (K-E), no
// reverse walk (K-E's phase 2). Their outputs are meaningless; chip_smoke.py
// times them to see where the time goes. MODE_GATES (K-D) is the kernel with
// pack rows 5-7 set to each ray's count of gated samples, sum of (ms + 1)
// and sum of (ms + 1)^2 over them: a fingerprint of the gates to compare.
constexpr int MODE_NO_MLP = 1;
constexpr int MODE_NO_SCATTER = 2;
constexpr int MODE_NO_PHASE2 = 4;
constexpr int MODE_GATES = 8;
constexpr float SKIPPED_PRODUCT = 1e-3f;

// What both kernels take: see dvgo_train_fused_fwd for the shapes.
struct Geometry {
  const __nv_bfloat16* slabs;
  const float* rays16;
  const float* sh1;
  const __nv_bfloat16* w1a;
  const __nv_bfloat16* w2;
  const float* b2;
  const __nv_bfloat16* w3;
  const float* b3;
  const int* uvb;
  int n, s_real, s_pad, gu, gv, c, f, direct, desc, nt, windowed, wu, wv,
      mode;
  float p0, pstep, act_shift, thres, bg;
};

struct Window {
  int u_lo, u_hi, v_lo, v_hi;
};

// The (u, v) window of march block mb for ray tile `tile`; false when the
// cell holds no station inside any of the tile's [t_lo, t_hi].
__device__ __forceinline__ bool cell_window(const Geometry& g, int mb,
                                            int tile, Window& w) {
  if (!g.windowed) {
    w.u_lo = 0, w.u_hi = g.gu, w.v_lo = 0, w.v_hi = g.gv;
    return true;
  }
  const int* cell = g.uvb + ((size_t)mb * (g.n / g.nt) + tile) * 4;
  w.u_lo = cell[0] * 16;
  w.u_hi = min(w.u_lo + g.wu, g.gu);
  w.v_lo = cell[1] * 8;
  w.v_hi = min(w.v_lo + g.wv, g.gv);
  return cell[2] != 0;
}

struct Station {
  float t, u, v;
  int sidx;   // slab index of the march station
};

// March station ms of the ray whose rays16 rows sit at ray[row * RAYS].
// False when the station reads nothing: beyond the last slab (the padding of
// a descending march) or without hat support on the plane (also NaN and the
// huge t of a ray along the stations).
__device__ __forceinline__ bool station_at(const Geometry& g,
                                           const float* ray, int ms,
                                           Station& st) {
  const float p_s = __fadd_rn(g.p0, __fmul_rn(g.pstep, (float)ms));
  st.t = __fdiv_rn(__fsub_rn(p_s, ray[0]), ray[3 * RAYS]);
  st.u = __fmaf_rn(st.t, ray[4 * RAYS], ray[1 * RAYS]);
  st.v = __fmaf_rn(st.t, ray[5 * RAYS], ray[2 * RAYS]);
  st.sidx = g.desc ? g.s_pad - 1 - ms : ms;
  return st.sidx < g.s_real && st.u > -1.f && st.u < (float)g.gu &&
         st.v > -1.f && st.v < (float)g.gv;
}

// Whether t lies in the ray's [t_lo, t_hi] (rows 6, 7) and the ray hits.
__device__ __forceinline__ bool in_range(const float* ray, float t) {
  const float tlo = ray[6 * RAYS], thi = ray[7 * RAYS];
  return t >= tlo && t <= thi && thi > tlo;
}

// The four taps of (u, v): u weights rounded to bf16, v weights f32; a tap
// outside the window (which lies inside the plane) weighs nothing.
struct Taps {
  int iu0, iv0;
  float wu[2], wv[2];
};

__device__ __forceinline__ Taps make_taps(float u, float v, const Window& w) {
  Taps tp;
  tp.iu0 = (int)floorf(u);
  tp.iv0 = (int)floorf(v);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int iu = tp.iu0 + a, iv = tp.iv0 + a;
    tp.wu[a] = (iu >= w.u_lo && iu < w.u_hi) ? round_bf16(hat(u, iu)) : 0.f;
    tp.wv[a] = (iv >= w.v_lo && iv < w.v_hi) ? hat(v, iv) : 0.f;
  }
  return tp;
}

// The first n_ch (at most C_MAX) channels of the station slab at the taps:
// per channel the u blend of exact bf16 products first, then the f32 v
// weights. Every load is issued before any value is used (the march runs on
// two warps per block, which hide no latency): a tap without weight reads a
// clamped, valid address and multiplies it by zero, as the plain version
// does. An even channel count reads two channels per 32-bit load.
template <int N_CH>
__device__ __forceinline__ void tap_channels(const __nv_bfloat16* slab,
                                             int gu, int gv, int c,
                                             const Taps& tp, float* vals) {
  static_assert(N_CH % 2 == 0 && N_CH <= C_MAX, "channel pairs");
  const int n_ch = min(N_CH, c);
  size_t at[2][2];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int a = 0; a < 2; ++a)
      at[b][a] = ((size_t)min(max(tp.iu0 + a, 0), gu - 1) * gv +
                  min(max(tp.iv0 + b, 0), gv - 1)) * c;
  float px[2][2][N_CH];
  if ((c & 1) == 0) {
    unsigned raw[2][2][N_CH / 2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const unsigned* p =
            reinterpret_cast<const unsigned*>(slab + at[b][a]);
#pragma unroll
        for (int i = 0; i < N_CH / 2; ++i)
          raw[b][a][i] = 2 * i < n_ch ? p[i] : 0u;
      }
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < N_CH / 2; ++i) {
          px[b][a][2 * i] = __uint_as_float(raw[b][a][i] << 16);
          px[b][a][2 * i + 1] = __uint_as_float(raw[b][a][i] & 0xffff0000u);
        }
  } else {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int ch = 0; ch < N_CH; ++ch)
          px[b][a][ch] = ch < n_ch
                             ? __bfloat162float(slab[at[b][a] + ch]) : 0.f;
  }
#pragma unroll
  for (int ch = 0; ch < N_CH; ++ch) {
    const float lo = __fadd_rn(__fmul_rn(tp.wu[0], px[0][0][ch]),
                               __fmul_rn(tp.wu[1], px[0][1][ch]));
    const float hi = __fadd_rn(__fmul_rn(tp.wu[0], px[1][0][ch]),
                               __fmul_rn(tp.wu[1], px[1][1][ch]));
    vals[ch] = __fadd_rn(__fmul_rn(lo, tp.wv[0]), __fmul_rn(hi, tp.wv[1]));
  }
}

__device__ __forceinline__ const __nv_bfloat16* slab_of(const Geometry& g,
                                                        int sidx) {
  return g.slabs + (size_t)sidx * g.gu * g.gv * g.c;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// One station's compositing state from its density and mask taps.
struct Gate {
  float araw, a, om, w, weff;
  bool occ, live;
};

__device__ __forceinline__ Gate gate(const Geometry& g, float dens,
                                     float maskv, bool in_t, float interval,
                                     float t_cum) {
  Gate o;
  const float x = __fadd_rn(dens, g.act_shift);
  const float softplus =
      __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
  o.araw = __fsub_rn(1.f, expf(-__fmul_rn(softplus, interval)));
  o.occ = in_t && maskv > 0.f && o.araw > g.thres;
  o.a = o.occ ? o.araw : 0.f;
  o.om = o.a > 0.f ? __fadd_rn(__fsub_rn(1.f, o.a), T_EPS) : 1.f;
  o.live = t_cum >= T_TERMINATE;
  o.w = o.live ? __fmul_rn(t_cum, o.a) : 0.f;
  o.weff = o.w > g.thres ? o.w : 0.f;
  return o;
}

// One station of a marching thread: the forward's step of the transmittance
// recursion. A ray is alive while it has hit the box, has not passed t_hi and
// its T is at least T_TERMINATE; a station it skips (dead, off the plane or
// outside [t_lo, t_hi]) has a = 0 and changes nothing. `push`: the sample's
// weight passes the gate, and vals holds its slab channels.
struct Marched {
  bool alive, push;
  float weff;
  float vals[C_MAX];
};

__device__ __forceinline__ Marched march_station(const Geometry& g,
                                                 const float* ray, int ms,
                                                 const Window& win,
                                                 float& t_cum) {
  Marched m;
  m.push = false;
  m.weff = 0.f;
  Station st;
  const bool on_plane = station_at(g, ray, ms, st);
  m.alive = t_cum >= T_TERMINATE && ray[7 * RAYS] > ray[6 * RAYS] &&
            !(st.t > ray[7 * RAYS]);
  if (m.alive && on_plane && in_range(ray, st.t)) {
    const Taps tp = make_taps(st.u, st.v, win);
    tap_channels<C_MAX>(slab_of(g, st.sidx), g.gu, g.gv, g.c, tp, m.vals);
    const Gate gt =
        gate(g, m.vals[0], m.vals[1], true, ray[8 * RAYS], t_cum);
    t_cum = __fmul_rn(t_cum, gt.om);   // live here; om is 1 where a is 0
    m.weff = gt.weff;
    m.push = m.weff > 0.f;
  }
  return m;
}

// The ring of gated samples. A chunk is CHUNK consecutive slots starting at
// 0 or CHUNK, so its rows are contiguous for the tensor-core loads.
struct Queue {
  __nv_bfloat16* feat;   // [QCAP][KPAD]
  int* lane;             // [QCAP] ray within the block, -1 = padding row
  int* ms;               // [QCAP] march station
  float* weff;           // [QCAP]
  float* aux;            // [QCAP][4] k0[:3] taps (rgb = sigmoid(logit + aux))
  int* state;            // [0] samples waiting, [1] first waiting slot
};

// Slot for this lane's sample (or -1). Every lane of the warp must call it.
__device__ __forceinline__ int queue_slot(const Queue& q, bool push) {
  const unsigned m = __ballot_sync(0xffffffffu, push);
  if (m == 0u) return -1;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(&q.state[0], __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (!push) return -1;
  return (q.state[1] + base + __popc(m & ((1u << lane) - 1u))) & (QCAP - 1);
}

// Fill slot with the sample's features (and aux) from its slab channels.
__device__ __forceinline__ void queue_write(const Geometry& g, const Queue& q,
                                            int slot, int lane, int ms,
                                            float weff, const float* vals) {
  q.lane[slot] = lane;
  q.ms[slot] = ms;
  q.weff[slot] = weff;
#pragma unroll
  for (int i = 0; i < KPAD; ++i) {   // constant indices: vals in registers
    float x = 0.f;
    if (i < g.f) {
      if (g.direct) {
        if (2 + i < C_MAX) x = vals[2 + i];
      } else {
        if (5 + i < C_MAX) x = vals[5 + i];
      }
    }
    q.feat[slot * KPAD + i] = __float2bfloat16_rn(x);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q.aux[slot * 4 + i] = g.direct ? 0.f : vals[2 + i];
}

// Rows [count, CHUNK) of the chunk at `base` become padding: zero features,
// zero weight, no ray. Their MLP rows stay finite and add nothing.
__device__ __forceinline__ void queue_pad(const Queue& q, int base,
                                          int count) {
  for (int i = count + threadIdx.x; i < CHUNK; i += THREADS) {
    const int slot = base + i;
    q.lane[slot] = -1;
    q.ms[slot] = 0;
    q.weff[slot] = 0.f;
    for (int j = 0; j < KPAD; ++j)
      q.feat[slot * KPAD + j] = __float2bfloat16_rn(0.f);
    for (int j = 0; j < 4; ++j) q.aux[slot * 4 + j] = 0.f;
  }
}

// The march both kernels share: threads 0..RAYS-1 take their rays (rays16
// rows at rays[row * RAYS + lane]) through the stations in march order and
// push the gated samples; whenever CHUNK samples wait, and once more for the
// rest at the end, the whole block calls run_chunk(first ring slot). The
// marching threads call at_block(march block, T) at the first station of
// every active cell. A block leaves the loop as soon as none of its rays is
// alive; returns one past the last station it visited.
template <class RunChunk, class AtBlock>
__device__ __forceinline__ int march_rays(const Geometry& g, const Queue& q,
                                          const float* rays, int tile,
                                          float& t_cum, RunChunk run_chunk,
                                          AtBlock at_block) {
  const int tid = threadIdx.x;
  int ms_end = 0;
  for (int ms = 0; ms < g.s_pad; ++ms) {
    Window win;
    if (!cell_window(g, ms / S_BLK, tile, win)) {
      ms = ms / S_BLK * S_BLK + S_BLK - 1;   // skip the inactive cell
      continue;
    }
    bool alive = false;
    if (tid < RAYS) {
      if (ms % S_BLK == 0) at_block(ms / S_BLK, t_cum);
      const Marched m = march_station(g, rays + tid, ms, win, t_cum);
      alive = m.alive;
      const int slot = queue_slot(q, m.push);
      if (slot >= 0) queue_write(g, q, slot, tid, ms, m.weff, m.vals);
    }
    ms_end = ms + 1;
    // No ray of the block is alive: nothing further can pass a gate.
    if (!__syncthreads_or(alive)) break;
    if (q.state[0] >= CHUNK) {
      run_chunk(q.state[1]);
      __syncthreads();
      if (tid == 0) {
        q.state[0] -= CHUNK;
        q.state[1] = (q.state[1] + CHUNK) & (QCAP - 1);
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (q.state[0] > 0) {
    queue_pad(q, q.state[1], q.state[0]);
    __syncthreads();
    run_chunk(q.state[1]);
  }
  __syncthreads();
  return ms_end;
}

template <int W>
struct MlpDims {
  static constexpr int NT = W / 16;   // 16-column tiles of a layer
  // Row stride of the bf16 [.][W] buffers in shared memory, padded so that
  // the eight rows a tensor tile load touches fall into different banks.
  static constexpr int LD = W + 8;
};

// Byte offsets, into the block's dynamic shared memory, of what the MLP
// passes read and write. The device functions form their pointers from the
// shared array itself, so that the compiler knows the address space and the
// tensor tile loads become shared-memory matrix loads (through a pointer it
// cannot trace they become generic loads plus register transposes).
// feat [QCAP][KPAD] bf16 and lane [QCAP] int are the ring; h1, h2 [CHUNK][LD]
// bf16; logit [CHUNK][KPAD] f32;
// the bf16 weights w1a [KPAD][LD], w2 [W][LD], w3 [W][KPAD], copied once per
// block (read from global memory by every tile load they cost more than the
// products).
struct MlpSmem {
  unsigned feat, lane, h1, h2, logit, w1a, w2, w3;
};

template <typename T>
__device__ __forceinline__ T* shared_at(unsigned offset) {
  extern __shared__ __align__(128) unsigned char smem[];
  return reinterpret_cast<T*>(smem + offset);
}

template <int W>
__device__ __forceinline__ void load_weights(const Geometry& g,
                                             const MlpSmem& m) {
  using D = MlpDims<W>;
  __nv_bfloat16* w1a = shared_at<__nv_bfloat16>(m.w1a);
  __nv_bfloat16* w2 = shared_at<__nv_bfloat16>(m.w2);
  __nv_bfloat16* w3 = shared_at<__nv_bfloat16>(m.w3);
  for (int i = threadIdx.x; i < KPAD * W; i += THREADS)
    w1a[i / W * D::LD + i % W] = g.w1a[i];
  for (int i = threadIdx.x; i < W * W; i += THREADS)
    w2[i / W * D::LD + i % W] = g.w2[i];
  for (int i = threadIdx.x; i < W * KPAD; i += THREADS) w3[i] = g.w3[i];
}

// ---- m16n8k16 bf16 tensor-core tiles by hand. nvcuda::wmma loads its tiles
// through generic pointers (one 32-bit load per register plus a register
// transpose for a row-major B); ldmatrix brings a warp's four 8x8 tiles in
// one instruction, and with the accumulators' layout known the bias, ReLU
// and bf16 rounding run on registers, without a round trip through shared
// memory.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 tiles; lane l gives the address of row (l & 7) of tile l >> 3.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] * b[16x8], f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where a lane sits in these tiles. Accumulators: c[0], c[1] are row qr,
// columns qc and qc + 1 of the 16x8 tile; c[2], c[3] the same in row
// qr + 8. ldmatrix: for a 16x16 block stored with its rows in memory rows,
// lane l addresses row lm_r at column lm_c and the four registers are the
// (rows 0-7 | 8-15) x (cols 0-7 | 8-15) quarters in the order 00, 10, 01, 11
// (the A operand's order); lm_r2/lm_c2 give the order 00, 01, 10, 11.
struct LanePos {
  int qr, qc, lm_r, lm_c, lm_r2, lm_c2;
  __device__ __forceinline__ LanePos() {
    const int l = threadIdx.x & 31;
    qr = l >> 2, qc = (l & 3) * 2;
    lm_r = (l & 7) + ((l >> 3) & 1) * 8, lm_c = (l >> 4) * 8;
    lm_r2 = (l & 7) + (l >> 4) * 8, lm_c2 = ((l >> 3) & 1) * 8;
  }
};

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x,
                                             float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// acc[j] (j over the W/8 column tiles) = A[16 x 16*KT] @ B, this warp's 16
// rows. A: row-major bf16 at a_rows (row stride lda). B given row-major
// [k][n] (TRANS_B false: ldmatrix.trans) or as its transpose [n][k] (TRANS_B
// true), row stride ldb. `skip` (a diagnostic form) leaves acc at
// SKIPPED_PRODUCT.
template <int NT8, int KT, bool TRANS_B>
__device__ __forceinline__ void rows_product(float (&acc)[NT8][4],
                                             const __nv_bfloat16* a_rows,
                                             int lda, const __nv_bfloat16* b,
                                             int ldb, const LanePos& lp,
                                             bool skip = false) {
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = skip ? SKIPPED_PRODUCT : 0.f;
  if (skip) return;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    unsigned a[4];
    ldsm_x4(a, a_rows + lp.lm_r * lda + kt * 16 + lp.lm_c);
#pragma unroll
    for (int np = 0; np < NT8 / 2; ++np) {
      unsigned bf[4];
      if (TRANS_B)   // stored [n][k]: tiles (n 0-7 | 8-15) x (k 0-7 | 8-15)
        ldsm_x4(bf, b + (np * 16 + lp.lm_r2) * ldb + kt * 16 + lp.lm_c2);
      else           // stored [k][n]: tiles (k 0-7 | 8-15) x (n 0-7 | 8-15)
        ldsm_x4_t(bf, b + (kt * 16 + lp.lm_r) * ldb + np * 16 + lp.lm_c);
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// The MLP's forward on this warp's 16 rows of the chunk at ring slot `base`:
// h1 and h2 are the ReLU outputs rounded to bf16, logit is without b3.
// Warp-local: no block barrier inside.
template <int W>
__device__ __forceinline__ void mlp_forward_rows(const Geometry& g,
                                                 const MlpSmem& m, int base,
                                                 int ray0) {
  using D = MlpDims<W>;
  constexpr int NT8 = W / 8;
  const LanePos lp;
  const bool skip = g.mode & MODE_NO_MLP;
  const int row0 = (threadIdx.x >> 5) * 16;
  const __nv_bfloat16* feat =
      shared_at<__nv_bfloat16>(m.feat) + (base + row0) * KPAD;
  const int* lane_of = shared_at<int>(m.lane) + base + row0;
  __nv_bfloat16* h1 = shared_at<__nv_bfloat16>(m.h1) + row0 * D::LD;
  __nv_bfloat16* h2 = shared_at<__nv_bfloat16>(m.h2) + row0 * D::LD;
  float* logit = shared_at<float>(m.logit) + row0 * KPAD;
  float acc[NT8][4];

  // layer 1: feat @ w1a + sh1[ray]
  rows_product<NT8, 1, false>(acc, feat, KPAD,
                              shared_at<__nv_bfloat16>(m.w1a), D::LD, lp,
                              skip);
  const int lr_lo = lane_of[lp.qr], lr_hi = lane_of[lp.qr + 8];
  const float* sh_lo = g.sh1 + (size_t)(ray0 + max(lr_lo, 0)) * W + lp.qc;
  const float* sh_hi = g.sh1 + (size_t)(ray0 + max(lr_hi, 0)) * W + lp.qc;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    float2 lo = __ldg(reinterpret_cast<const float2*>(sh_lo + j * 8));
    float2 hi = __ldg(reinterpret_cast<const float2*>(sh_hi + j * 8));
    if (lr_lo < 0) lo = make_float2(0.f, 0.f);
    if (lr_hi < 0) hi = make_float2(0.f, 0.f);
    store_bf16x2(h1 + lp.qr * D::LD + j * 8 + lp.qc,
                 fmaxf(__fadd_rn(acc[j][0], lo.x), 0.f),
                 fmaxf(__fadd_rn(acc[j][1], lo.y), 0.f));
    store_bf16x2(h1 + (lp.qr + 8) * D::LD + j * 8 + lp.qc,
                 fmaxf(__fadd_rn(acc[j][2], hi.x), 0.f),
                 fmaxf(__fadd_rn(acc[j][3], hi.y), 0.f));
  }
  __syncwarp();

  // layer 2: h1 @ w2 + b2
  rows_product<NT8, W / 16, false>(acc, h1, D::LD,
                                   shared_at<__nv_bfloat16>(m.w2), D::LD, lp,
                                   skip);
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const float2 bias =
        __ldg(reinterpret_cast<const float2*>(g.b2 + j * 8 + lp.qc));
    store_bf16x2(h2 + lp.qr * D::LD + j * 8 + lp.qc,
                 fmaxf(__fadd_rn(acc[j][0], bias.x), 0.f),
                 fmaxf(__fadd_rn(acc[j][1], bias.y), 0.f));
    store_bf16x2(h2 + (lp.qr + 8) * D::LD + j * 8 + lp.qc,
                 fmaxf(__fadd_rn(acc[j][2], bias.x), 0.f),
                 fmaxf(__fadd_rn(acc[j][3], bias.y), 0.f));
  }
  __syncwarp();

  // layer 3: h2 @ w3 (three real columns of KPAD; both 8-column tiles are
  // written so that the buffer holds no stale values)
  float out[2][4];
  rows_product<2, W / 16, false>(out, h2, D::LD,
                                 shared_at<__nv_bfloat16>(m.w3), KPAD, lp,
                                 skip);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *reinterpret_cast<float2*>(logit + lp.qr * KPAD + j * 8 + lp.qc) =
        make_float2(out[j][0], out[j][1]);
    *reinterpret_cast<float2*>(logit + (lp.qr + 8) * KPAD + j * 8 + lp.qc) =
        make_float2(out[j][2], out[j][3]);
  }
  __syncwarp();
}

// rgb of chunk row `row` from its logits (adds b3 and, unless direct, aux).
__device__ __forceinline__ void row_rgb(const Geometry& g, const float* logit,
                                        const float* aux, int row,
                                        float rgb[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float x = __fadd_rn(logit[row * KPAD + ch], g.b3[ch]);
    if (!g.direct) x = __fadd_rn(x, aux[row * 4 + ch]);
    rgb[ch] = sigmoidf(x);
  }
}

// Byte offsets into the dynamic shared memory, each region aligned to 128.
struct Carver {
  size_t at = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t here = at;
    at += (bytes + 127) / 128 * 128;
    return here;
  }
};

}  // namespace dvgo_fused
