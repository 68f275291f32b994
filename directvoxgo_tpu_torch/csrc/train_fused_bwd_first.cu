// The first version of kernel K-E, kept beside its redesign
// (train_fused_bwd.cu) as the yardstick of its time; built only by
// chip_smoke.py, never loaded by the port. mode: see train_fused_first.cuh.
//
// Fused train-step backward (kernel K-E): the cotangents of the permuted
// grids, of the hoisted view term sh1 and of the colour MLP's weights, from
// the cotangents of the three per-ray outputs of train_fused_fwd.cu.
//
// Replaces: directvoxgo_tpu/ops/pallas_train_fused.py::train_bwd_pallas (the
// windowed and the full form) together with the XLA glue behind it
// (_station_slabs_transpose and the channel split of _fused_chain_bwd).
//
// Per ray, with the forward's alpha, T, w and gates recomputed from the same
// taps by the same device functions (train_fused.cuh):
//   A_s      = sum_c rgb_c * g_rgb_c                  (dL/dw_eff; the rgbper
//                                                      term's weights are
//                                                      detached)
//   d_rgb    = w_eff * (g_rgb + 2 g_rgbper (rgb - gt)),
//   d_logit  = d_rgb * rgb * (1 - rgb), then the MLP's backward with
//              d_logit, d_h2, d_h1 rounded to bf16 before each product and
//              the bias gradients and d_sh1 summed from the f32 values
//   d_w      = A_s where w > thres
//   d_alpha  = [occ and live] d_w*T - (R + [live] g_ainv*ainv) / om  (occ)
//   R       <- R + d_w*w, after use, walking the stations in reverse
//   d_dens   = d_alpha * interval * sigmoid(dens + shift) * (1 - alpha_raw)
// and per tap of a station with a nonzero cotangent g (d_dens for the
// density, d_feat and, unless direct, d_logit for k0):
//   grid[z] += (1-f) * wu * rnd_bf16(wv * g),  grid[z+1] += f * (same)
// which is the scatter of sweep_bwd.cu (grid_scatter.cuh). The mask channel
// gets nothing, and a voxel no sample touches stays exactly zero in the
// zero-filled accumulators.
//
// Bound on the H100: the bytes are the tapped slab voxels (twice: no value of
// the forward is saved, so the forward's 168 MB [S, 16, N] f32 residual of the
// TPU design is neither written nor read; the two scratch arrays of this
// launch are T per march block, 4 bytes per ray and block, and A, 4 bytes
// per gated sample), the touched voxels of the two accumulators and d_sh1.
// The operations are three passes of the MLP over the gated samples (forward
// again, and two products per layer backward) on the tensor cores. As in the
// forward, the march is a dependent chain per ray and is bound by latency;
// the scatter is bound by the rate of f32 atomics into L2.
// Design: a block owns 64 rays. Phase 1 marches them forward exactly as
// train_fused_fwd.cu does, keeps T at the start of every march block, and
// runs the MLP forward and backward on chunks of 64 gated samples with
// m16n8k16 tensor-core tiles (train_fused.cuh), the bf16 weights in shared
// memory. The row-wise products (d_h2, d_h1, d_feat) are done by one warp per
// 16 rows, with the ReLU masks and the bf16 rounding applied to the
// accumulators, and overwrite h2 and h1 in place. The weight gradients (sums
// over the chunk's rows) are dealt to the four warps by output tile and
// accumulate in f32 in shared memory; the block adds them to the zero-filled
// outputs with atomics when it is done (the bias gradients stay in registers
// until then). d_h1's f32 values are added straight to the zero-filled d_sh1
// (a float atomic add in shared memory is a compare-and-swap loop on this
// card and cost more than all the products). The k0 cotangents are
// scattered per chunk. Phase 2 walks the march blocks in reverse, one thread
// per ray: it loads the eight stations' taps and dL/dw_eff at once, recomputes
// the block's recursion from its T in registers, then descends the stations
// with the suffix sum R and scatters d_dens. The order of the atomics varies
// from run to run, so sums differ in their last bits between runs.

#include "train_fused_first.cuh"

namespace {

using namespace dvgo_fused;

constexpr int COT_ROWS = 6;   // rows of cot the kernel reads

struct BwdOut {
  float* t_chk;      // [s_pad / 8, N] scratch
  float* a_buf;      // [s_pad, N] scratch
  float* d_density;  // [Gp, Gu, Gv], zero-filled
  float* d_k0;       // [Gp, Gu, Gv, C - 2], zero-filled
  float* d_sh1;      // [N, W], zero-filled
  float* d_w1a;      // [16, W], zero-filled
  float* d_w2;       // [W, W], zero-filled
  float* d_b2;       // [W], zero-filled
  float* d_w3;       // [W, 16], zero-filled
  float* d_b3;       // [16], zero-filled
  const float* cot;  // [8, N]
  int k;
};

// out[16 x 8*NT8] += X^T @ Y over the chunk's rows, for the 8-column tile
// pairs np_begin, np_begin + np_step, ...: out f32 in shared memory (row
// stride ldo), X [CHUNK][ldx] and Y [CHUNK][ldy] bf16 in shared memory, x
// pointing at the 16 columns of X that become out's rows. A weight gradient:
// the sum over samples of (activation column) x (cotangent row).
__device__ __forceinline__ void rows_sum_product(
    float* out, int ldo, const __nv_bfloat16* x, int ldx,
    const __nv_bfloat16* y, int ldy, int np_begin, int np_end, int np_step,
    const LanePos& lp) {
  unsigned a[CHUNK / 16][4];
#pragma unroll
  for (int kt = 0; kt < CHUNK / 16; ++kt)
    ldsm_x4_t(a[kt], x + (kt * 16 + lp.lm_r2) * ldx + lp.lm_c2);
  for (int np = np_begin; np < np_end; np += np_step) {
    float c[2][4];
    float* at_lo = out + lp.qr * ldo + np * 16 + lp.qc;
    float* at_hi = at_lo + 8 * ldo;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float2 lo = *reinterpret_cast<const float2*>(at_lo + 8 * t);
      const float2 hi = *reinterpret_cast<const float2*>(at_hi + 8 * t);
      c[t][0] = lo.x, c[t][1] = lo.y, c[t][2] = hi.x, c[t][3] = hi.y;
    }
#pragma unroll
    for (int kt = 0; kt < CHUNK / 16; ++kt) {
      unsigned bf[4];
      ldsm_x4_t(bf, y + (kt * 16 + lp.lm_r) * ldy + np * 16 + lp.lm_c);
      mma_bf16(c[0], a[kt], bf[0], bf[1]);
      mma_bf16(c[1], a[kt], bf[2], bf[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      *reinterpret_cast<float2*>(at_lo + 8 * t) =
          make_float2(c[t][0], c[t][1]);
      *reinterpret_cast<float2*>(at_hi + 8 * t) =
          make_float2(c[t][2], c[t][3]);
    }
  }
}

template <int W>
struct BwdSmem {
  unsigned rays, cot, q_feat, q_lane, q_ms, q_weff, q_aux, q_state, h1, h2,
      logit, dl3, dlogit, w1a, w2, w3, dw2, dw1a, dw3, total;
  __host__ __device__ BwdSmem() {
    Carver c;
    rays = c.take(sizeof(float) * RAY_ROWS * RAYS);
    cot = c.take(sizeof(float) * COT_ROWS * RAYS);
    q_feat = c.take(sizeof(__nv_bfloat16) * QCAP * KPAD);
    q_lane = c.take(sizeof(int) * QCAP);
    q_ms = c.take(sizeof(int) * QCAP);
    q_weff = c.take(sizeof(float) * QCAP);
    q_aux = c.take(sizeof(float) * QCAP * 4);
    q_state = c.take(sizeof(int) * 2);
    h1 = c.take(sizeof(__nv_bfloat16) * CHUNK * MlpDims<W>::LD);
    h2 = c.take(sizeof(__nv_bfloat16) * CHUNK * MlpDims<W>::LD);
    logit = c.take(sizeof(float) * CHUNK * KPAD);
    dl3 = c.take(sizeof(float) * CHUNK * 4);
    dlogit = c.take(sizeof(__nv_bfloat16) * CHUNK * KPAD);
    w1a = c.take(sizeof(__nv_bfloat16) * KPAD * MlpDims<W>::LD);
    w2 = c.take(sizeof(__nv_bfloat16) * W * MlpDims<W>::LD);
    w3 = c.take(sizeof(__nv_bfloat16) * W * KPAD);
    dw2 = c.take(sizeof(float) * W * MlpDims<W>::LD);
    dw1a = c.take(sizeof(float) * KPAD * MlpDims<W>::LD);
    dw3 = c.take(sizeof(float) * W * KPAD);
    total = c.at;
  }
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
train_fused_bwd_kernel(Geometry g, BwdOut o) {
  using D = MlpDims<W>;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<W> lay;
  float* rays = reinterpret_cast<float*>(smem + lay.rays);
  float* cot = reinterpret_cast<float*>(smem + lay.cot);
  Queue q;
  q.feat = reinterpret_cast<__nv_bfloat16*>(smem + lay.q_feat);
  q.lane = reinterpret_cast<int*>(smem + lay.q_lane);
  q.ms = reinterpret_cast<int*>(smem + lay.q_ms);
  q.weff = reinterpret_cast<float*>(smem + lay.q_weff);
  q.aux = reinterpret_cast<float*>(smem + lay.q_aux);
  q.state = reinterpret_cast<int*>(smem + lay.q_state);
  MlpSmem mlp;
  mlp.feat = lay.q_feat, mlp.lane = lay.q_lane, mlp.h1 = lay.h1;
  mlp.h2 = lay.h2, mlp.logit = lay.logit;
  mlp.w1a = lay.w1a, mlp.w2 = lay.w2, mlp.w3 = lay.w3;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * 16;
  const int ray0 = blockIdx.x * RAYS;
  const int tile = ray0 / g.nt;
  const int k0c = g.c - 2;
  const size_t plane = (size_t)g.gu * g.gv;

  for (int i = tid; i < RAY_ROWS * RAYS; i += THREADS)
    rays[i] = g.rays16[(size_t)(i / RAYS) * g.n + ray0 + i % RAYS];
  for (int i = tid; i < COT_ROWS * RAYS; i += THREADS)
    cot[i] = o.cot[(size_t)(i / RAYS) * g.n + ray0 + i % RAYS];
  // dw2 .. dw3 are laid out one after another: zero them in one sweep.
  for (size_t i = lay.dw2 / 4 + tid; i < lay.total / 4; i += THREADS)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  for (int i = tid; i < CHUNK * KPAD; i += THREADS)
    shared_at<__nv_bfloat16>(lay.dlogit)[i] = __float2bfloat16_rn(0.f);
  if (tid < 2) q.state[tid] = 0;
  queue_pad(q, 0, 0);
  queue_pad(q, CHUNK, 0);
  load_weights<W>(g, mlp);
  __syncthreads();

  // Bias gradients stay in registers over the whole launch: a lane always
  // owns the same two columns of every 8-column tile (b2, summed over its
  // two rows of every chunk) and, in the row epilogue, the three channels of
  // its own rows (b3).
  constexpr int NT8 = W / 8;
  float db2_acc[NT8][2], db3_acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT8; ++j) db2_acc[j][0] = db2_acc[j][1] = 0.f;

  // The MLP forward and backward on the chunk at `base`. Block-wide. The
  // cotangents d_h2 and d_h1 overwrite h2 and h1 in place once every product
  // that reads the activations is done.
  auto run_chunk = [&](int base) {
    // Pointers formed here from the shared array (see MlpSmem).
    const __nv_bfloat16* feat =
        shared_at<__nv_bfloat16>(lay.q_feat) + base * KPAD;
    const int* lane_of = shared_at<int>(lay.q_lane) + base;
    __nv_bfloat16* h1 = shared_at<__nv_bfloat16>(lay.h1);
    __nv_bfloat16* h2 = shared_at<__nv_bfloat16>(lay.h2);
    float* logit = shared_at<float>(lay.logit);
    float* dl3 = shared_at<float>(lay.dl3);
    __nv_bfloat16* dlogit = shared_at<__nv_bfloat16>(lay.dlogit);
    float* dw2 = shared_at<float>(lay.dw2);
    float* dw1a = shared_at<float>(lay.dw1a);
    float* dw3 = shared_at<float>(lay.dw3);
    const __nv_bfloat16* w1a_s = shared_at<__nv_bfloat16>(lay.w1a);
    const __nv_bfloat16* w2_s = shared_at<__nv_bfloat16>(lay.w2);
    const __nv_bfloat16* w3_s = shared_at<__nv_bfloat16>(lay.w3);
    const LanePos lp;
    const bool no_mlp = g.mode & MODE_NO_MLP;
    const bool no_scatter = g.mode & MODE_NO_SCATTER;
    float rows[NT8][4];   // this warp's 16 rows of a row-wise product

    // 1. forward; per row: rgb, A -> a_buf, d_logit.
    mlp_forward_rows<W>(g, mlp, base, ray0);
    if (lane < 16) {
      const int row = row0 + lane;
      const int lr = lane_of[row];
      float dl[3] = {0.f, 0.f, 0.f};
      if (lr >= 0) {
        float rgb[3];
        row_rgb(g, logit, q.aux + base * 4, row, rgb);
        const float weff = q.weff[base + row];
        const float g_per2 = __fmul_rn(cot[4 * RAYS + lr], 2.f);
        float a_s = 0.f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float g_rgb = cot[ch * RAYS + lr];
          a_s = __fadd_rn(a_s, __fmul_rn(rgb[ch], g_rgb));
          const float diff = __fsub_rn(rgb[ch], rays[(9 + ch) * RAYS + lr]);
          const float d_rgb =
              __fmul_rn(weff, __fadd_rn(g_rgb, __fmul_rn(g_per2, diff)));
          dl[ch] = __fmul_rn(__fmul_rn(d_rgb, rgb[ch]),
                             __fsub_rn(1.f, rgb[ch]));
          db3_acc[ch] = __fadd_rn(db3_acc[ch], dl[ch]);
        }
        o.a_buf[(size_t)q.ms[base + row] * g.n + ray0 + lr] = a_s;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        dl3[row * 4 + ch] = dl[ch];
        dlogit[row * KPAD + ch] = __float2bfloat16_rn(dl[ch]);
      }
    }
    __syncthreads();

    // 2. d_w3 += h2^T @ rnd(d_logit): a sum over the chunk's rows.
    for (int mt = warp; mt < D::NT && !no_mlp; mt += 4)
      rows_sum_product(dw3 + mt * 16 * KPAD, KPAD, h2 + mt * 16, D::LD,
                       dlogit, KPAD, 0, 1, 1, lp);
    __syncthreads();

    // 3. d_h2 = rnd(d_logit) @ w3^T where h2 > 0; b2's gradient from the
    // f32 values; rounded to bf16 over h2.
    rows_product<NT8, 1, true>(rows, dlogit + row0 * KPAD, KPAD, w3_s, KPAD,
                               lp, no_mlp);
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __nv_bfloat16* p =
            h2 + (row0 + lp.qr + 8 * half) * D::LD + j * 8 + lp.qc;
        const float2 act =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(p));
        const float x = act.x > 0.f ? rows[j][2 * half] : 0.f;
        const float y = act.y > 0.f ? rows[j][2 * half + 1] : 0.f;
        db2_acc[j][0] = __fadd_rn(db2_acc[j][0], x);
        db2_acc[j][1] = __fadd_rn(db2_acc[j][1], y);
        store_bf16x2(p, x, y);
      }
    __syncthreads();

    // 4. d_w2 += h1^T @ rnd(d_h2): a sum over the chunk's rows.
    for (int mt = warp; mt < D::NT && !no_mlp; mt += 4)
      rows_sum_product(dw2 + mt * 16 * D::LD, D::LD, h1 + mt * 16, D::LD, h2,
                       D::LD, 0, D::NT, 1, lp);
    __syncthreads();

    // 5. d_h1 = rnd(d_h2) @ w2^T where h1 > 0; its f32 values are added to
    // d_sh1 of the row's ray (the zero-filled output; the four lanes of a
    // tile row add 32 contiguous bytes); rounded to bf16 over h1.
    rows_product<NT8, W / 16, true>(rows, h2 + row0 * D::LD, D::LD, w2_s,
                                    D::LD, lp, no_mlp);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = lane_of[row0 + lp.qr + 8 * half];
      float* d_sh1 = o.d_sh1 + (size_t)(ray0 + max(lr, 0)) * W + lp.qc;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        __nv_bfloat16* p =
            h1 + (row0 + lp.qr + 8 * half) * D::LD + j * 8 + lp.qc;
        const float2 act =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(p));
        const float x = act.x > 0.f ? rows[j][2 * half] : 0.f;
        const float y = act.y > 0.f ? rows[j][2 * half + 1] : 0.f;
        if (lr >= 0 && x != 0.f && !no_scatter) atomicAdd(d_sh1 + j * 8, x);
        if (lr >= 0 && y != 0.f && !no_scatter)
          atomicAdd(d_sh1 + j * 8 + 1, y);
        store_bf16x2(p, x, y);
      }
    }
    __syncwarp();

    // 6. d_feat = rnd(d_h1) @ w1a^T, into the logit buffer.
    {
      float out[2][4];
      rows_product<2, W / 16, true>(out, h1 + row0 * D::LD, D::LD, w1a_s,
                                    D::LD, lp, no_mlp);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(logit + (row0 + lp.qr + 8 * half) * KPAD +
                                     j * 8 + lp.qc) =
              make_float2(out[j][2 * half], out[j][2 * half + 1]);
    }
    __syncthreads();

    // 7. d_w1a += feat^T @ rnd(d_h1), the column tiles dealt to the warps.
    if (!no_mlp)
      rows_sum_product(dw1a, D::LD, feat, KPAD, h1, D::LD, warp, D::NT, 4,
                       lp);

    // 8. the k0 cotangents of every row, one (row, tap) per thread and turn.
    for (int item = tid; item < CHUNK * 4 && !no_scatter; item += THREADS) {
      const int row = item >> 2;
      const int lr = lane_of[row];
      if (lr < 0) continue;
      const int ms = q.ms[base + row];
      Station st;
      Window win;
      if (!cell_window(g, ms / S_BLK, tile, win) ||
          !station_at(g, rays + lr, ms, st))
        continue;
      const Taps tp = make_taps(st.u, st.v, win);
      const int ta = item & 1, tb = (item >> 1) & 1;
      if (tp.wu[ta] == 0.f || tp.wv[tb] == 0.f) continue;
      const dvgo::SlabSplit sp = dvgo::slab_split(st.sidx, o.k);
      float* px = o.d_k0 + ((size_t)sp.z * plane +
                            (size_t)(tp.iu0 + ta) * g.gv + (tp.iv0 + tb)) *
                               k0c;
      for (int ch = 0; ch < k0c; ++ch) {
        const float gv_ = g.direct ? logit[row * KPAD + ch]
                          : ch < 3 ? dl3[row * 4 + ch]
                                   : logit[row * KPAD + ch - 3];
        if (gv_ != 0.f)
          dvgo::scatter_tap<true>(px + ch, plane * k0c, sp, tp.wu[ta],
                                  tp.wv[tb], gv_);
      }
    }
    __syncthreads();
  };

  // ---- phase 1: the forward march; gated samples go through the MLP, and T
  // at the start of every march block is kept for phase 2.
  const float* ray = rays + tid;
  float t_cum = 1.f;
  const int ms_end = march_rays(
      g, q, rays, tile, t_cum, run_chunk, [&](int mb, float t_in) {
        o.t_chk[(size_t)mb * g.n + ray0 + tid] = t_in;
      });

  // ---- phase 2: down each ray in reverse march order.
  if (tid < RAYS && !(g.mode & MODE_NO_PHASE2)) {
    const int r = ray0 + tid;
    const float interval = ray[8 * RAYS];
    const float ga_ainv = __fmul_rn(cot[3 * RAYS + tid], cot[5 * RAYS + tid]);
    float r_suf = 0.f;
    for (int mb = (ms_end - 1) / S_BLK; mb >= 0; --mb) {
      Window win;
      if (!cell_window(g, mb, tile, win)) continue;
      float t_in[S_BLK], a_[S_BLK], w_[S_BLK], om_[S_BLK], araw[S_BLK],
          dens[S_BLK], maskv[S_BLK], d_weff[S_BLK];
      unsigned occ = 0u, live = 0u, on = 0u;
      // Density and mask of the block's eight stations first (their loads
      // do not wait for T), then the recursion from the block's T.
#pragma unroll
      for (int jm = 0; jm < S_BLK; ++jm) {
        const int ms = mb * S_BLK + jm;
        Station st;
        dens[jm] = maskv[jm] = 0.f;
        // dL/dw_eff, read now with the slab taps and used below only where
        // phase 1 wrote it (w > thres); elsewhere the scratch is garbage.
        d_weff[jm] = o.a_buf[(size_t)ms * g.n + r];
        if (ms < ms_end && station_at(g, ray, ms, st) &&
            in_range(ray, st.t)) {
          float geo[2];
          tap_channels<2>(slab_of(g, st.sidx), g.gu, g.gv, g.c,
                          make_taps(st.u, st.v, win), geo);
          dens[jm] = geo[0], maskv[jm] = geo[1];
          on |= 1u << jm;
        }
      }
      float t_run = o.t_chk[(size_t)mb * g.n + r];
#pragma unroll
      for (int jm = 0; jm < S_BLK; ++jm) {
        t_in[jm] = t_run;
        a_[jm] = w_[jm] = araw[jm] = 0.f;
        om_[jm] = 1.f;
        if (t_run >= T_TERMINATE) live |= 1u << jm;
        // The forward skips a station once the ray has terminated; such a
        // station has a = 0 here as well.
        if (((on >> jm) & 1u) && t_run >= T_TERMINATE) {
          const Gate gt =
              gate(g, dens[jm], maskv[jm], true, interval, t_run);
          a_[jm] = gt.a, w_[jm] = gt.w, om_[jm] = gt.om;
          araw[jm] = gt.araw;
          if (gt.occ) occ |= 1u << jm;
          t_run = __fmul_rn(t_run, gt.om);
        }
      }
#pragma unroll
      for (int jm = S_BLK - 1; jm >= 0; --jm) {
        if (!((occ >> jm) & 1u)) continue;   // d_alpha is zero off occ
        const int ms = mb * S_BLK + jm;
        const bool lv = (live >> jm) & 1u;
        const float d_w = w_[jm] > g.thres ? d_weff[jm] : 0.f;
        const float a_term = lv ? ga_ainv : 0.f;
        const float inv_om = __fdiv_rn(1.f, fmaxf(om_[jm], T_EPS));
        const float d_alpha = __fsub_rn(
            lv ? __fmul_rn(d_w, t_in[jm]) : 0.f,
            __fmul_rn(__fadd_rn(r_suf, a_term), inv_om));
        const float d_dens = __fmul_rn(
            __fmul_rn(__fmul_rn(d_alpha, interval),
                      sigmoidf(__fadd_rn(dens[jm], g.act_shift))),
            __fsub_rn(1.f, araw[jm]));
        r_suf = __fadd_rn(r_suf, __fmul_rn(d_w, w_[jm]));
        if (d_dens == 0.f || (g.mode & MODE_NO_SCATTER)) continue;
        Station st;
        station_at(g, ray, ms, st);
        const Taps tp = make_taps(st.u, st.v, win);
        const dvgo::SlabSplit sp = dvgo::slab_split(st.sidx, o.k);
#pragma unroll
        for (int ta = 0; ta < 2; ++ta) {
          if (tp.wu[ta] == 0.f) continue;
#pragma unroll
          for (int tb = 0; tb < 2; ++tb) {
            if (tp.wv[tb] == 0.f) continue;
            dvgo::scatter_tap<true>(
                o.d_density + (size_t)sp.z * plane +
                    (size_t)(tp.iu0 + ta) * g.gv + (tp.iv0 + tb),
                plane, sp, tp.wu[ta], tp.wv[tb], d_dens);
          }
        }
      }
    }
  }

  // ---- the block's sums of the weight gradients, added by atomics.
  auto flush = [&](const float* src, int ld, float* dst, int n_rows,
                   int n_cols) {
    for (int i = tid; i < n_rows * n_cols; i += THREADS) {
      const float x = src[i / n_cols * ld + i % n_cols];
      if (x != 0.f) atomicAdd(dst + i, x);
    }
  };
  flush(shared_at<float>(lay.dw2), D::LD, o.d_w2, W, W);
  flush(shared_at<float>(lay.dw1a), D::LD, o.d_w1a, KPAD, W);
  flush(shared_at<float>(lay.dw3), KPAD, o.d_w3, W, KPAD);
  {
    const LanePos lp;
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = db2_acc[j][c];   // sum over the lanes that share qc
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lp.qr == 0 && x != 0.f) atomicAdd(o.d_b2 + j * 8 + lp.qc + c, x);
      }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float x = lane < 16 ? db3_acc[ch] : 0.f;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0 && x != 0.f) atomicAdd(o.d_b3 + ch, x);
  }
}

template <int W>
cudaError_t launch(const Geometry& g, const BwdOut& o, cudaStream_t st) {
  const BwdSmem<W> lay;
  cudaError_t err = cudaFuncSetAttribute(
      train_fused_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.total);
  if (err != cudaSuccess) return err;
  train_fused_bwd_kernel<W><<<g.n / RAYS, THREADS, lay.total, st>>>(g, o);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Inputs as dvgo_train_fused_fwd, plus cot [8, N] f32 rows (g_rgb r g b,
// g_ainv with the background term folded in, g_rgbper, alphainv_last, ...)
// and k (stations per voxel; S = k*(Gp-1)+1). Scratch of this launch: t_chk
// [s_pad/8, N], a_buf [s_pad, N] f32 (uninitialised). Outputs, f32:
// d_density [Gp, Gu, Gv], d_k0 [Gp, Gu, Gv, C-2], d_w1a [16, W], d_w2
// [W, W], d_b2 [W], d_w3 [W, 16], d_b3 [16] and d_sh1 [N, W], all ZERO-FILLED
// by the caller.
int dvgo_train_fused_bwd(const void* slabs, const float* rays16,
                         const float* cot, const float* sh1, const void* w1a,
                         const void* w2, const float* b2, const void* w3,
                         const float* b3, const int* uvb, float* t_chk,
                         float* a_buf, float* d_density, float* d_k0,
                         float* d_sh1, float* d_w1a, float* d_w2, float* d_b2,
                         float* d_w3, float* d_b3, int n, int s_real,
                         int s_pad, int gu, int gv, int c, int f, int width,
                         int direct, int desc, int nt, int windowed, int wu,
                         int wv, int k, float p0, float pstep,
                         float act_shift, float thres, float bg, int mode,
                         void* stream) {
  if (n < 1 || nt < 1 || n % nt != 0 || nt % RAYS != 0 || s_real < 1 ||
      s_pad < s_real || s_pad % S_BLK != 0 || f < 1 || f > KPAD || k < 1 ||
      (s_real - 1) % k != 0 || c != (direct ? 2 : 5) + f ||
      (windowed && uvb == nullptr))
    return cudaErrorInvalidValue;
  Geometry g;
  g.slabs = static_cast<const __nv_bfloat16*>(slabs);
  g.rays16 = rays16;
  g.sh1 = sh1;
  g.w1a = static_cast<const __nv_bfloat16*>(w1a);
  g.w2 = static_cast<const __nv_bfloat16*>(w2);
  g.b2 = b2;
  g.w3 = static_cast<const __nv_bfloat16*>(w3);
  g.b3 = b3;
  g.uvb = uvb;
  g.n = n, g.s_real = s_real, g.s_pad = s_pad, g.gu = gu, g.gv = gv;
  g.c = c, g.f = f, g.direct = direct, g.desc = desc, g.nt = nt;
  g.windowed = windowed, g.wu = wu, g.wv = wv;
  g.p0 = p0, g.pstep = pstep, g.act_shift = act_shift, g.thres = thres;
  g.bg = bg, g.mode = mode;
  BwdOut o;
  o.t_chk = t_chk, o.a_buf = a_buf, o.d_density = d_density, o.d_k0 = d_k0;
  o.d_sh1 = d_sh1, o.d_w1a = d_w1a, o.d_w2 = d_w2, o.d_b2 = d_b2;
  o.d_w3 = d_w3, o.d_b3 = d_b3, o.cot = cot, o.k = k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32: return static_cast<int>(launch<32>(g, o, st));
    case 64: return static_cast<int>(launch<64>(g, o, st));
    case 128: return static_cast<int>(launch<128>(g, o, st));
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
