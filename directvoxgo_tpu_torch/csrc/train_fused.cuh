// Device code shared by the fused train-step kernels (train_fused_fwd.cu,
// train_fused_bwd.cu): the march of a block's rays over the stations
// (coordinates, window cells, bilinear taps of the bf16 slabs, alpha, the
// transmittance recursion and the gates), the ring of gated samples a block
// collects, and bf16 tensor-core tiles (mma.sync m16n8k16, f32 sums) for the
// colour MLP.
//
// The unit of work is a group of GROUP rays of one ray tile. A launch has one
// persistent block per SM; each block takes groups from a counter in device
// memory until none are left, so an SM whose rays gate few samples takes
// more of them (the gated samples per 64 rays of a lego fine step vary by
// 2.3x, and a fixed block per 64 rays left the kernel waiting for the
// busiest). A block has one thread per (station, ray) pair of a march block
// of MARCH stations: thread t takes ray t % GROUP and station t / GROUP.
// Per march block,
//   A. every thread taps its pair's density and mask and computes the part
//      of alpha that does not depend on T (the gathers leave the serial
//      chain);
//   B. threads 0..GROUP-1 run their ray's T recursion over the block's
//      stations in march order, from shared memory (cheap, and the same
//      arithmetic as a one-thread-per-station march, so T and every gate are
//      bit for bit those of the first version);
//   C. the pairs whose weight passes the gate are compacted into the ring by
//      warp ballot and a prefix sum over the warps (no atomics), each thread
//      tapping and writing its own features (only gated pairs read them:
//      some 40% of the visited ones on a lego fine step); whenever CHUNK
//      samples wait, the whole block runs the MLP on them.
// That is three barriers per MARCH stations where the first version had one
// per station, and sixteen warps per SM where it had four.
//
// Both kernels compute alpha and the gates with the same device functions on
// the same taps, so the backward sees the forward's alpha, T and gates bit for
// bit. Multiplications that feed an addition are written with explicit
// intrinsics so that the compiler does not contract them: the arithmetic is
// that of the plain PyTorch versions in ops/train_fused.py.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "grid_scatter.cuh"

namespace dvgo_fused {

using dvgo::hat;
using dvgo::round_bf16;

constexpr int GROUP = 8;                // rays of a unit of work
constexpr int MARCH = 64;               // stations per march block
constexpr int THREADS = GROUP * MARCH;  // one thread per (station, ray)
constexpr int WARPS = THREADS / 32;
static_assert(GROUP * 4 == 32, "a warp's lanes hold the 4 sums of each ray");
constexpr int S_BLK = 8;   // stations per window cell (the uvb granularity)
constexpr int CHUNK = 64;   // samples per MLP pass (K-E; K-D takes twice as
//                             many, see train_fused_fwd.cu)
constexpr int QCAP = 640;   // ring: a partial chunk and a march block's pairs
constexpr int KPAD = 16;    // MLP input / output columns, padded
constexpr int C_MAX = 16;   // slab channels (2 + k0), at most
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

// March station ms of the ray whose rays16 rows sit at ray[row * GROUP].
// False when the station reads nothing: beyond the last slab (the padding of
// a descending march) or without hat support on the plane (also NaN and the
// huge t of a ray along the stations).
__device__ __forceinline__ bool station_at(const Geometry& g,
                                           const float* ray, int ms,
                                           Station& st) {
  const float p_s = __fadd_rn(g.p0, __fmul_rn(g.pstep, (float)ms));
  st.t = __fdiv_rn(__fsub_rn(p_s, ray[0]), ray[3 * GROUP]);
  st.u = __fmaf_rn(st.t, ray[4 * GROUP], ray[1 * GROUP]);
  st.v = __fmaf_rn(st.t, ray[5 * GROUP], ray[2 * GROUP]);
  st.sidx = g.desc ? g.s_pad - 1 - ms : ms;
  return st.sidx < g.s_real && st.u > -1.f && st.u < (float)g.gu &&
         st.v > -1.f && st.v < (float)g.gv;
}

// Whether t lies in the ray's [t_lo, t_hi] (rows 6, 7) and the ray hits.
__device__ __forceinline__ bool in_range(const float* ray, float t) {
  const float tlo = ray[6 * GROUP], thi = ray[7 * GROUP];
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
// weights. Every load is issued before any value is used: a tap without
// weight reads a clamped, valid address and multiplies it by zero, as the
// plain version does. An even channel count reads two channels per 32-bit
// load.
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

// The part of a station's compositing state that does not depend on T, from
// its density and mask taps (a station inside [t_lo, t_hi]).
struct Alpha {
  float araw, a, om;
  bool occ;
};

__device__ __forceinline__ Alpha alpha_of(const Geometry& g, float dens,
                                          float maskv, float interval) {
  Alpha o;
  const float x = __fadd_rn(dens, g.act_shift);
  const float softplus =
      __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
  o.araw = __fsub_rn(1.f, expf(-__fmul_rn(softplus, interval)));
  o.occ = maskv > 0.f && o.araw > g.thres;
  o.a = o.occ ? o.araw : 0.f;
  o.om = o.a > 0.f ? __fadd_rn(__fsub_rn(1.f, o.a), T_EPS) : 1.f;
  return o;
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

template <typename T>
__device__ __forceinline__ T* shared_at(unsigned offset) {
  extern __shared__ __align__(128) unsigned char smem[];
  return reinterpret_cast<T*>(smem + offset);
}

// ---- the march

// Shared memory of the march: the pair states of one march block, the warps'
// counts of gated pairs, each ray's T entering the block, and the ring of
// gated samples (features, ray within the group, march station, w_eff and
// the k0[:3] taps for rgb = sigmoid(logit + aux)). A chunk of CH samples is
// CH consecutive ring slots starting at a multiple of CH, so its rows are
// contiguous for the tensor-core loads.
struct MarchSmem {
  // pair: (a, om, flags as int bits, 0) of every pair of the march block
  unsigned pair, weff, wcount, t_start, feat, lane, ms, q_weff, aux;
  __host__ __device__ void carve(Carver& c) {
    pair = c.take(sizeof(float4) * THREADS);
    weff = c.take(sizeof(float) * THREADS);
    wcount = c.take(sizeof(int) * WARPS);
    t_start = c.take(sizeof(float) * GROUP);
    feat = c.take(sizeof(__nv_bfloat16) * QCAP * KPAD);
    lane = c.take(sizeof(int) * QCAP);
    ms = c.take(sizeof(int) * QCAP);
    q_weff = c.take(sizeof(float) * QCAP);
    aux = c.take(sizeof(float) * QCAP * 4);
  }
};

constexpr int F_VISITED = 1;    // pair flag: its window cell is active
constexpr int F_NOT_PAST = 2;   // pair flag: the ray hits and t <= t_hi
constexpr int F_COUNTS = 4;     // pair flag: the station's taps count

// Rows [count, CH) of the chunk at ring slot `base` become padding: zero
// features, zero weight, no ray. Their MLP rows stay finite and add nothing.
template <int CH>
__device__ __forceinline__ void queue_pad(const MarchSmem& s, int base,
                                          int count) {
  for (int i = count + threadIdx.x; i < CH; i += THREADS) {
    const int slot = base + i;
    shared_at<int>(s.lane)[slot] = -1;
    shared_at<int>(s.ms)[slot] = 0;
    shared_at<float>(s.q_weff)[slot] = 0.f;
    for (int j = 0; j < KPAD; ++j)
      shared_at<__nv_bfloat16>(s.feat)[slot * KPAD + j] =
          __float2bfloat16_rn(0.f);
    for (int j = 0; j < 4; ++j) shared_at<float>(s.aux)[slot * 4 + j] = 0.f;
  }
}

// The march of one group (see the top of this file). `rays` holds the
// group's rays16 rows at rays[row * GROUP + ray] in shared memory, and the
// caller has set s.t_start to 1 for every ray. Threads 0..GROUP-1 carry
// their ray's T in t_cum (1 on entry), call at_block(window cell, T) as they
// enter every active cell and gated(ms, passed) at every station of the
// march block, `passed` where its sample passes the gate; the whole block calls run_chunk(first ring slot) whenever CH
// samples wait and once more for the rest at the end. A march block whose
// cells are all inactive is skipped, and the group leaves the loop after a
// march block at whose last visited station none of its rays is alive.
// Returns one past the last march block visited.
template <int CH, class RunChunk, class AtBlock, class Gated>
__device__ __forceinline__ int march_rays(const Geometry& g,
                                          const MarchSmem& s,
                                          const float* rays, int tile,
                                          float& t_cum, RunChunk run_chunk,
                                          AtBlock at_block, Gated gated) {
  static_assert(QCAP % CH == 0 && QCAP >= CH - 1 + THREADS,
                "the ring holds a partial chunk and a march block's pairs");
  const int tid = threadIdx.x, r = tid % GROUP, j = tid / GROUP;
  const int warp = tid >> 5, lane = tid & 31;
  const float* ray = rays + r;
  float4* p_pair = shared_at<float4>(s.pair);
  float* p_weff = shared_at<float>(s.weff);
  int* p_wcount = shared_at<int>(s.wcount);
  float* p_tstart = shared_at<float>(s.t_start);
  int q_head = 0, q_count = 0, mb_end = 0;
  bool alive = true;   // of thread tid's ray, at its last visited station
  for (int mb = 0; mb * MARCH < g.s_pad; ++mb) {
    // A. this thread's pair: the density and mask taps and the part of
    // alpha without T (the features wait for the gate, below). A ray that
    // enters the block dead (T below T_TERMINATE) reads nothing.
    const int ms = mb * MARCH + j;
    int flags = 0, sidx = 0;
    Taps tp;
    Alpha al;
    al.a = 0.f, al.om = 1.f;
    Window win;
    if (ms < g.s_pad && cell_window(g, ms / S_BLK, tile, win)) {
      flags = F_VISITED;
      Station st;
      const bool on = station_at(g, ray, ms, st);
      if (p_tstart[r] >= T_TERMINATE && ray[7 * GROUP] > ray[6 * GROUP] &&
          !(st.t > ray[7 * GROUP])) {
        flags |= F_NOT_PAST;
        if (on && in_range(ray, st.t)) {
          tp = make_taps(st.u, st.v, win);
          sidx = st.sidx;
          float geo[2];
          tap_channels<2>(slab_of(g, sidx), g.gu, g.gv, g.c, tp, geo);
          al = alpha_of(g, geo[0], geo[1], ray[8 * GROUP]);
          flags |= F_COUNTS;
        }
      }
    }
    p_pair[tid] = make_float4(al.a, al.om, __int_as_float(flags), 0.f);
    if (!__syncthreads_or(flags)) continue;   // every cell inactive
    mb_end = mb + 1;
    // B. the T recursion of each ray over the block's stations, in march
    // order. alive: T >= T_TERMINATE, the ray hits and has not passed t_hi
    // (a ray that entered the block dead has F_NOT_PAST clear). Every
    // station's state is loaded, and its products formed, whatever its
    // flags, so that the loads of the unrolled stations issue together and
    // the serial part is a few selects without branches.
    if (tid < GROUP) {
#pragma unroll 8
      for (int jj = 0; jj < MARCH; ++jj) {
        const int k = jj * GROUP + tid;
        const float4 pr = p_pair[k];
        const int fl = __float_as_int(pr.z);
        const bool visited = fl & F_VISITED;
        if (visited && jj % S_BLK == 0)
          at_block((mb * MARCH + jj) / S_BLK, t_cum);
        const bool live = t_cum >= T_TERMINATE && (fl & F_NOT_PAST);
        alive = visited ? live : alive;
        const bool counts = visited && live && (fl & F_COUNTS);
        const float w = __fmul_rn(t_cum, pr.x);   // live where it counts
        const float t_next = __fmul_rn(t_cum, pr.y);
        const float weff = counts && w > g.thres ? w : 0.f;
        t_cum = counts ? t_next : t_cum;   // om is 1 where a is 0
        gated(mb * MARCH + jj, weff > 0.f);
        p_weff[k] = weff;
      }
      p_tstart[tid] = t_cum;
    }
    // No ray of the group is alive: nothing further can pass a gate.
    const bool any_alive = __syncthreads_or(tid < GROUP && alive);
    // C. the gated pairs into the ring, in (station, ray) order.
    const float weff = p_weff[tid];
    const bool push = weff > 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, push);
    if (lane == 0) p_wcount[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int cnt = p_wcount[w];
      before += w < warp ? cnt : 0;
      total += cnt;
    }
    if (push) {
      // The gated pair's features: every slab channel at its taps again
      // (density and mask come out as in A).
      float vals[C_MAX];
      tap_channels<C_MAX>(slab_of(g, sidx), g.gu, g.gv, g.c, tp, vals);
      const int slot = (q_head + q_count + before +
                        __popc(bal & ((1u << lane) - 1u))) % QCAP;
      shared_at<int>(s.lane)[slot] = r;
      shared_at<int>(s.ms)[slot] = ms;
      shared_at<float>(s.q_weff)[slot] = weff;
      unsigned packed[KPAD / 2];
#pragma unroll
      for (int i = 0; i < KPAD; i += 2) {   // constant indices: registers
        float x[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ch = i + h;
          x[h] = 0.f;
          if (ch < g.f) {
            if (g.direct) {
              if (2 + ch < C_MAX) x[h] = vals[2 + ch];
            } else {
              if (5 + ch < C_MAX) x[h] = vals[5 + ch];
            }
          }
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(x[0], x[1]);
        packed[i / 2] = *reinterpret_cast<const unsigned*>(&pair);
      }
      uint4* dst = reinterpret_cast<uint4*>(
          shared_at<__nv_bfloat16>(s.feat) + slot * KPAD);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      float* aux = shared_at<float>(s.aux) + slot * 4;
#pragma unroll
      for (int i = 0; i < 3; ++i) aux[i] = g.direct ? 0.f : vals[2 + i];
      aux[3] = 0.f;
    }
    q_count += total;
    // The ring's new rows are visible to all after one barrier. Chunks that
    // follow each other need none between them: what a chunk reads after
    // its last barrier, the next one writes only after two of its own.
    if (q_count >= CH) __syncthreads();
    while (q_count >= CH) {
      run_chunk(q_head);
      q_head = (q_head + CH) % QCAP;
      q_count -= CH;
    }
    if (!any_alive) break;
  }
  __syncthreads();
  if (q_count > 0) {
    queue_pad<CH>(s, q_head, q_count);
    __syncthreads();
    run_chunk(q_head);
  }
  __syncthreads();
  return mb_end;
}

// Blocks of a persistent launch of `kernel` with `smem` bytes of dynamic
// shared memory: as many as the device's SMs hold at once, at most n_groups.
template <class Kernel>
__host__ cudaError_t persistent_blocks(Kernel kernel, size_t smem,
                                       int n_groups, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = std::min(sms * per_sm, n_groups);
  return cudaSuccess;
}

// The next group for this block from the launch's counter (zeroed before
// the launch), or -1 when every group is taken. Block-wide; `slot` is an int
// in shared memory.
__device__ __forceinline__ int next_group(unsigned* counter, int* slot,
                                          int n_groups) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int grp = *slot;
  return grp < n_groups ? grp : -1;
}

// ---- m16n8k16 bf16 tensor-core tiles by hand: ldmatrix brings a warp's
// four 8x8 tiles in one instruction, and with the accumulators' layout known
// the bias, ReLU and bf16 rounding run on registers.

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
// qr + 8 (an A fragment's registers are rows qr | qr + 8 by columns
// qc.. | qc + 8.., in the order 00, 10, 01, 11). ldmatrix: for a 16x16 block
// stored with its rows in memory rows, lane l addresses row lm_r at column
// lm_c and the four registers are the (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
// quarters in the order 00, 10, 01, 11 (the A operand's order); lm_r2/lm_c2
// give the order 00, 01, 10, 11.
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

__device__ __forceinline__ void fill_block(float (&c)[2][4], float v) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[t][i] = v;
}

// c (a 16x16 block: two 16x8 tiles) += A[16 x 16*KT] @ B[16*KT x 16], all
// bf16 in shared memory. A_ROWS: A stored row-major [m][k] at a (row stride
// lda); else A^T is stored, [k][m], as the activations are for a weight
// gradient. B_ROWS: B stored row-major [k][n] at b (row stride ldb); else
// B^T is stored, [n][k], as a weight is for the product with a cotangent.
template <int KT, bool A_ROWS, bool B_ROWS>
__device__ __forceinline__ void block_mma(float (&c)[2][4],
                                          const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* b, int ldb,
                                          const LanePos& lp) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    unsigned af[4], bf[4];
    if (A_ROWS)
      ldsm_x4(af, a + lp.lm_r * lda + kt * 16 + lp.lm_c);
    else
      ldsm_x4_t(af, a + (kt * 16 + lp.lm_r2) * lda + lp.lm_c2);
    if (B_ROWS)
      ldsm_x4_t(bf, b + (kt * 16 + lp.lm_r) * ldb + lp.lm_c);
    else
      ldsm_x4(bf, b + lp.lm_r2 * ldb + kt * 16 + lp.lm_c2);
    mma_bf16(c[0], af, bf[0], bf[1]);
    mma_bf16(c[1], af, bf[2], bf[3]);
  }
}

template <int W, int CH = CHUNK>
struct MlpDims {
  static constexpr int NB = W / 16;   // 16-column blocks of a layer
  // Row stride of the bf16 [.][W] buffers in shared memory, padded so that
  // the eight rows a tensor tile load touches fall into different banks.
  static constexpr int LD = W + 8;
  // 16x16 blocks of a [CH, W] product, and how many a warp takes (block
  // b goes to warp b % WARPS; WARPS is a multiple of NB, so a warp's blocks
  // share their columns).
  static constexpr int ROW_BLOCKS = CH / 16 * NB;
  static constexpr int PER_WARP = (ROW_BLOCKS + WARPS - 1) / WARPS;
  static_assert(WARPS % NB == 0, "a warp's row blocks share their columns");
};

// Byte offsets, into the block's dynamic shared memory, of what the MLP
// passes read and write. The device functions form their pointers from the
// shared array itself, so that the compiler knows the address space and the
// tensor tile loads become shared-memory matrix loads. The bf16 weights
// w1a [KPAD][LD], w2 [W][LD], w3 [W][KPAD] are copied once per block; h1, h2
// [CH][LD] bf16 (h2 may be h1: the forward alone keeps no activations);
// logit [CH][KPAD] f32.
struct MlpSmem {
  unsigned h1, h2, logit, w1a, w2, w3;
};

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

// The MLP's forward on the chunk at ring slot `base`, block-wide: h1 and h2
// are the ReLU outputs rounded to bf16, logit is without b3. Layer 2's
// blocks stay in registers until every warp has read h1, so h2 may overwrite
// it. Ends with a barrier.
template <int W, int CH>
__device__ __forceinline__ void mlp_forward(const Geometry& g,
                                            const MarchSmem& s,
                                            const MlpSmem& m, int base,
                                            int ray0) {
  using D = MlpDims<W, CH>;
  const LanePos lp;
  const int warp = threadIdx.x >> 5;
  const bool skip = g.mode & MODE_NO_MLP;
  const float fill = skip ? SKIPPED_PRODUCT : 0.f;
  const __nv_bfloat16* feat =
      shared_at<__nv_bfloat16>(s.feat) + base * KPAD;
  const int* lane_of = shared_at<int>(s.lane) + base;
  __nv_bfloat16* h1 = shared_at<__nv_bfloat16>(m.h1);
  __nv_bfloat16* h2 = shared_at<__nv_bfloat16>(m.h2);
  const __nv_bfloat16* w1a = shared_at<__nv_bfloat16>(m.w1a);
  const __nv_bfloat16* w2 = shared_at<__nv_bfloat16>(m.w2);
  const __nv_bfloat16* w3 = shared_at<__nv_bfloat16>(m.w3);

  // layer 1: feat @ w1a + sh1[ray]
#pragma unroll
  for (int i = 0; i < D::PER_WARP; ++i) {
    const int b = warp + i * WARPS;
    if (b >= D::ROW_BLOCKS) break;
    const int mt = b / D::NB, nt = b % D::NB;
    float c[2][4];
    fill_block(c, fill);
    if (!skip)
      block_mma<1, true, true>(c, feat + mt * 16 * KPAD, KPAD,
                               w1a + nt * 16, D::LD, lp);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + lp.qr + 8 * half;
      const int lr = lane_of[row];
      const float* sh = g.sh1 + (size_t)(ray0 + max(lr, 0)) * W + nt * 16 +
                        lp.qc;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float2 v = __ldg(reinterpret_cast<const float2*>(sh + t * 8));
        if (lr < 0) v = make_float2(0.f, 0.f);
        store_bf16x2(h1 + row * D::LD + nt * 16 + t * 8 + lp.qc,
                     fmaxf(__fadd_rn(c[t][2 * half], v.x), 0.f),
                     fmaxf(__fadd_rn(c[t][2 * half + 1], v.y), 0.f));
      }
    }
  }
  __syncthreads();

  // layer 2: h1 @ w2 + b2
  float c2[D::PER_WARP][2][4];
#pragma unroll
  for (int i = 0; i < D::PER_WARP; ++i) {
    const int b = warp + i * WARPS;
    fill_block(c2[i], fill);
    if (b < D::ROW_BLOCKS && !skip)
      block_mma<W / 16, true, true>(c2[i], h1 + b / D::NB * 16 * D::LD,
                                    D::LD, w2 + b % D::NB * 16, D::LD, lp);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < D::PER_WARP; ++i) {
    const int b = warp + i * WARPS;
    if (b >= D::ROW_BLOCKS) break;
    const int mt = b / D::NB, nt = b % D::NB;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col = nt * 16 + t * 8 + lp.qc;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(g.b2 + col));
#pragma unroll
      for (int half = 0; half < 2; ++half)
        store_bf16x2(h2 + (mt * 16 + lp.qr + 8 * half) * D::LD + col,
                     fmaxf(__fadd_rn(c2[i][t][2 * half], bias.x), 0.f),
                     fmaxf(__fadd_rn(c2[i][t][2 * half + 1], bias.y), 0.f));
    }
  }
  __syncthreads();

  // layer 3: h2 @ w3 (three real columns of KPAD; both 8-column tiles are
  // written so that the buffer holds no stale values)
  if (warp < CH / 16) {
    float c[2][4];
    fill_block(c, fill);
    if (!skip)
      block_mma<W / 16, true, true>(c, h2 + warp * 16 * D::LD, D::LD, w3,
                                    KPAD, lp);
    float* logit = shared_at<float>(m.logit);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            logit + (warp * 16 + lp.qr + 8 * half) * KPAD + t * 8 + lp.qc) =
            make_float2(c[t][2 * half], c[t][2 * half + 1]);
  }
  __syncthreads();
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

}  // namespace dvgo_fused
