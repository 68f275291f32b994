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
// again, and two products per layer backward) on the tensor cores.
// Design: persistent blocks of 512 threads take groups of 8 rays from a
// counter, one thread per (station, ray) pair of a 64-station march block
// (train_fused.cuh). Phase 1 marches a group forward exactly as
// train_fused_fwd.cu does, keeps T at the start of every window cell, and
// runs the MLP forward and backward on chunks of 64 gated samples with
// m16n8k16 tensor-core tiles, the bf16 weights in shared memory; the sixteen
// warps take one 16x16 output block each per turn. The row-wise products
// (d_h2, d_h1, d_feat) apply the ReLU masks and the bf16 rounding to the
// accumulators, the row blocks held in registers until every warp has read
// the activations they overwrite (two bf16 buffers: h1, h2). The sums over
// rows never leave the SM until the end, f32 in shared memory, each 16x16
// block read, added to and written back by the one warp that owns it (so
// no atomics; in registers, d_w2 alone would take 32 of the 128 a thread
// has at W = 128, and the kernel spilled): d_w2, d_w3, d_w1a, the bias
// gradients, and d_sh1 of the group's rays, which is a product too: the
// one-hot [ray, row] matrix of the chunk (built in registers) times d_h1,
// split into bf16 hi + lo parts so that the sum keeps f32 precision
// (|d_h1 - hi - lo| <= 2^-18 |d_h1|), stored once per group (the group
// owns its rays). The weight
// gradients reach device memory at the end by vector reductions. The k0
// cotangents are scattered per chunk, one red.global.add.v4.f32 per four
// channels of a tap. Phase 2 walks the group's march blocks in reverse with
// the forward's split: all 512 threads tap density and mask, read dL/dw_eff
// and compute what does not depend on T, 8 threads recompute the recursion
// from each cell's T and descend the stations with the suffix sum R, and
// every pair scatters its own d_dens. The order of the atomics varies from
// run to run, so sums differ in their last bits between runs.

#include "train_fused.cuh"

namespace {

using namespace dvgo_fused;

constexpr int COT_ROWS = 6;   // rows of cot the kernel reads
constexpr int SH_PAD = 4;     // row padding of the f32 sums in shared memory

__device__ unsigned g_next_group;   // the launch's counter of groups taken

struct BwdOut {
  float* t_chk;      // [s_pad / 8, N] scratch
  float* a_buf;      // [s_pad, N] scratch
  float* d_density;  // [Gp, Gu, Gv], zero-filled
  float* d_k0;       // [Gp, Gu, Gv, C - 2], zero-filled
  float* d_sh1;      // [N, W]
  float* d_w1a;      // [16, W], zero-filled
  float* d_w2;       // [W, W], zero-filled
  float* d_b2;       // [W], zero-filled
  float* d_w3;       // [W, 16], zero-filled
  float* d_b3;       // [16], zero-filled
  const float* cot;  // [8, N]
  int k;
};

template <int W>
struct BwdSmem {
  MarchSmem march;
  MlpSmem mlp;
  // f32 sums: dw2 [W][W], sh1_sum [16][W] (rows >= GROUP stay zero), dw3
  // [W][16], dw1a [16][W] (rows padded by SH_PAD); db2 [WARPS][16] and db3
  // [2][4] partial sums, one slot per warp.
  unsigned rays, cot, dw2, sh1_sum, dw3, dw1a, db2, db3, dl3, dlogit, group,
      total;
  __host__ __device__ BwdSmem() {
    using D = MlpDims<W>;
    Carver c;
    rays = c.take(sizeof(float) * RAY_ROWS * GROUP);
    cot = c.take(sizeof(float) * COT_ROWS * GROUP);
    march.carve(c);
    mlp.h1 = c.take(sizeof(__nv_bfloat16) * CHUNK * D::LD);
    mlp.h2 = c.take(sizeof(__nv_bfloat16) * CHUNK * D::LD);
    dw2 = c.take(sizeof(float) * W * (W + SH_PAD));
    sh1_sum = c.take(sizeof(float) * 16 * (W + SH_PAD));
    dw3 = c.take(sizeof(float) * W * (KPAD + SH_PAD));
    dw1a = c.take(sizeof(float) * KPAD * (W + SH_PAD));
    db2 = c.take(sizeof(float) * WARPS * 16);
    db3 = c.take(sizeof(float) * 2 * 4);
    mlp.logit = c.take(sizeof(float) * CHUNK * KPAD);
    dl3 = c.take(sizeof(float) * CHUNK * 4);
    dlogit = c.take(sizeof(__nv_bfloat16) * CHUNK * KPAD);
    group = c.take(sizeof(int));
    mlp.w1a = c.take(sizeof(__nv_bfloat16) * KPAD * D::LD);
    mlp.w2 = c.take(sizeof(__nv_bfloat16) * W * D::LD);
    mlp.w3 = c.take(sizeof(__nv_bfloat16) * W * KPAD);
    total = c.at;
  }
};

// Two bf16 ones or zeros, for the one-hot A fragments.
__device__ __forceinline__ unsigned onehot2(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}

// Block c <-> rows row0.., columns col0.. of a row-major f32 matrix in
// shared memory (row stride ld).
__device__ __forceinline__ void load_block(float (&c)[2][4], const float* p,
                                           int ld, const LanePos& lp) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = *reinterpret_cast<const float2*>(
          p + (lp.qr + 8 * half) * ld + t * 8 + lp.qc);
      c[t][2 * half] = v.x, c[t][2 * half + 1] = v.y;
    }
}

__device__ __forceinline__ void store_block(float* p, int ld,
                                            const float (&c)[2][4],
                                            const LanePos& lp) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(p + (lp.qr + 8 * half) * ld + t * 8 +
                                 lp.qc) =
          make_float2(c[t][2 * half], c[t][2 * half + 1]);
}

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
train_fused_bwd_kernel(Geometry g, BwdOut o) {
  using D = MlpDims<W>;
  // The 16x16 blocks of d_w2 [W, W], dealt to the warps.
  constexpr int W2_BLOCKS = D::NB * D::NB;
  constexpr int W2_PER = (W2_BLOCKS + WARPS - 1) / WARPS;
  constexpr int SH_LD = W + SH_PAD, W2_LD = SH_LD, W3_LD = KPAD + SH_PAD;
  const BwdSmem<W> lay;
  const MarchSmem& ms_ = lay.march;
  float* rays = shared_at<float>(lay.rays);
  float* cot = shared_at<float>(lay.cot);
  float* sh1_sum = shared_at<float>(lay.sh1_sum);
  float* dw2 = shared_at<float>(lay.dw2);
  float* dw3 = shared_at<float>(lay.dw3);
  float* dw1a = shared_at<float>(lay.dw1a);
  float* db2 = shared_at<float>(lay.db2);
  float* db3 = shared_at<float>(lay.db3);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0c = g.c - 2;
  const size_t plane = (size_t)g.gu * g.gv;
  const bool no_mlp = g.mode & MODE_NO_MLP;
  const bool no_scatter = g.mode & MODE_NO_SCATTER;
  const float fill = no_mlp ? SKIPPED_PRODUCT : 0.f;
  const LanePos lp;

  for (int i = tid; i < CHUNK * KPAD; i += THREADS)
    shared_at<__nv_bfloat16>(lay.dlogit)[i] = __float2bfloat16_rn(0.f);
  for (int i = tid; i < 16 * SH_LD; i += THREADS) sh1_sum[i] = 0.f;
  for (int i = tid; i < W * W2_LD; i += THREADS) dw2[i] = 0.f;
  for (int i = tid; i < W * W3_LD; i += THREADS) dw3[i] = 0.f;
  for (int i = tid; i < KPAD * SH_LD; i += THREADS) dw1a[i] = 0.f;
  for (int i = tid; i < WARPS * 16; i += THREADS) db2[i] = 0.f;
  if (tid < 8) db3[tid] = 0.f;
  load_weights<W>(g, lay.mlp);

  for (;;) {
    const int grp =
        next_group(&g_next_group, shared_at<int>(lay.group), g.n / GROUP);
    if (grp < 0) break;
    const int ray0 = grp * GROUP;
    const int tile = ray0 / g.nt;
    for (int i = tid; i < RAY_ROWS * GROUP; i += THREADS)
      rays[i] = g.rays16[(size_t)(i / GROUP) * g.n + ray0 + i % GROUP];
    for (int i = tid; i < COT_ROWS * GROUP; i += THREADS)
      cot[i] = o.cot[(size_t)(i / GROUP) * g.n + ray0 + i % GROUP];
    if (tid < GROUP) shared_at<float>(ms_.t_start)[tid] = 1.f;
    __syncthreads();

    // The MLP forward and backward on the chunk at `base`, block-wide.
    auto run_chunk = [&](int base) {
      const __nv_bfloat16* feat =
          shared_at<__nv_bfloat16>(ms_.feat) + base * KPAD;
      const int* lane_of = shared_at<int>(ms_.lane) + base;
      const int* ms_of = shared_at<int>(ms_.ms) + base;
      __nv_bfloat16* h1 = shared_at<__nv_bfloat16>(lay.mlp.h1);
      __nv_bfloat16* h2 = shared_at<__nv_bfloat16>(lay.mlp.h2);
      float* logit = shared_at<float>(lay.mlp.logit);
      float* dl3 = shared_at<float>(lay.dl3);
      __nv_bfloat16* dlogit = shared_at<__nv_bfloat16>(lay.dlogit);
      const __nv_bfloat16* w1a = shared_at<__nv_bfloat16>(lay.mlp.w1a);
      const __nv_bfloat16* w2 = shared_at<__nv_bfloat16>(lay.mlp.w2);
      const __nv_bfloat16* w3 = shared_at<__nv_bfloat16>(lay.mlp.w3);

      // 1. forward; per row: rgb, A -> a_buf, d_logit (b3's gradient from
      // the f32 values, summed over the warp).
      mlp_forward<W, CHUNK>(g, ms_, lay.mlp, base, ray0);
      if (tid < CHUNK) {
        const int row = tid;
        const int lr = lane_of[row];
        float dl[3] = {0.f, 0.f, 0.f};
        if (lr >= 0) {
          float rgb[3];
          row_rgb(g, logit, shared_at<float>(ms_.aux) + base * 4, row, rgb);
          const float weff = shared_at<float>(ms_.q_weff)[base + row];
          const float g_per2 = __fmul_rn(cot[4 * GROUP + lr], 2.f);
          float a_s = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float g_rgb = cot[ch * GROUP + lr];
            a_s = __fadd_rn(a_s, __fmul_rn(rgb[ch], g_rgb));
            const float diff =
                __fsub_rn(rgb[ch], rays[(9 + ch) * GROUP + lr]);
            const float d_rgb =
                __fmul_rn(weff, __fadd_rn(g_rgb, __fmul_rn(g_per2, diff)));
            dl[ch] = __fmul_rn(__fmul_rn(d_rgb, rgb[ch]),
                               __fsub_rn(1.f, rgb[ch]));
          }
          o.a_buf[(size_t)ms_of[row] * g.n + ray0 + lr] = a_s;
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          dl3[row * 4 + ch] = dl[ch];
          dlogit[row * KPAD + ch] = __float2bfloat16_rn(dl[ch]);
          float x = dl[ch];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, off);
          if (lane == 0) db3[warp * 4 + ch] += x;
        }
      }
      __syncthreads();

      // 2. d_w3 += h2^T @ rnd(d_logit); d_h2 = rnd(d_logit) @ w3^T, held
      // until every warp has read h2, then masked where h2 > 0 (b2's
      // gradient from the f32 values) and rounded to bf16 over h2.
      if (warp < D::NB && !no_mlp) {
        float c[2][4];
        float* p = dw3 + warp * 16 * W3_LD;
        load_block(c, p, W3_LD, lp);
        block_mma<CHUNK / 16, false, true>(c, h2 + warp * 16, D::LD, dlogit,
                                           KPAD, lp);
        store_block(p, W3_LD, c, lp);
      }
      float rows[D::PER_WARP][2][4];
#pragma unroll
      for (int i = 0; i < D::PER_WARP; ++i) {
        const int b = warp + i * WARPS;
        fill_block(rows[i], fill);
        if (b < D::ROW_BLOCKS && !no_mlp)
          block_mma<1, true, false>(rows[i], dlogit + b / D::NB * 16 * KPAD,
                                    KPAD, w3 + b % D::NB * 16 * KPAD, KPAD,
                                    lp);
      }
      __syncthreads();
      float db2_part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int i = 0; i < D::PER_WARP; ++i) {
        const int b = warp + i * WARPS;
        if (b >= D::ROW_BLOCKS) break;
        const int mt = b / D::NB, nt = b % D::NB;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            __nv_bfloat16* p = h2 + (mt * 16 + lp.qr + 8 * half) * D::LD +
                               nt * 16 + t * 8 + lp.qc;
            const float2 act =
                __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(p));
            const float x = act.x > 0.f ? rows[i][t][2 * half] : 0.f;
            const float y = act.y > 0.f ? rows[i][t][2 * half + 1] : 0.f;
            db2_part[t][0] = __fadd_rn(db2_part[t][0], x);
            db2_part[t][1] = __fadd_rn(db2_part[t][1], y);
            store_bf16x2(p, x, y);
          }
      }
      if (warp < D::ROW_BLOCKS) {   // this warp's columns, summed over rows
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float x = db2_part[t][cc];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              x += __shfl_xor_sync(0xffffffffu, x, off);
            if (lp.qr == 0) db2[warp * 16 + t * 8 + lp.qc + cc] += x;
          }
      }
      __syncthreads();

      // 3. d_w2 += h1^T @ rnd(d_h2); d_h1 = rnd(d_h2) @ w2^T, held until
      // every warp has read h1 and h2, then masked where h1 > 0 and split
      // into hi = rnd(d_h1) over h1 and lo = rnd(d_h1 - hi) over h2.
#pragma unroll 1   // unrolled, the loop's addresses spill at W = 128
      for (int i = 0; i < W2_PER; ++i) {
        const int b = warp + i * WARPS;
        if (b >= W2_BLOCKS || no_mlp) break;
        float c[2][4];
        float* p = dw2 + b / D::NB * 16 * W2_LD + b % D::NB * 16;
        load_block(c, p, W2_LD, lp);
        block_mma<CHUNK / 16, false, true>(c, h1 + b / D::NB * 16, D::LD,
                                           h2 + b % D::NB * 16, D::LD, lp);
        store_block(p, W2_LD, c, lp);
      }
#pragma unroll
      for (int i = 0; i < D::PER_WARP; ++i) {
        const int b = warp + i * WARPS;
        fill_block(rows[i], fill);
        if (b < D::ROW_BLOCKS && !no_mlp)
          block_mma<W / 16, true, false>(rows[i], h2 + b / D::NB * 16 * D::LD,
                                         D::LD, w2 + b % D::NB * 16 * D::LD,
                                         D::LD, lp);
      }
      __syncthreads();
      __nv_bfloat16* hi = h1;
      __nv_bfloat16* lo = h2;
#pragma unroll
      for (int i = 0; i < D::PER_WARP; ++i) {
        const int b = warp + i * WARPS;
        if (b >= D::ROW_BLOCKS) break;
        const int mt = b / D::NB, nt = b % D::NB;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int at = (mt * 16 + lp.qr + 8 * half) * D::LD + nt * 16 +
                           t * 8 + lp.qc;
            const float2 act = __bfloat1622float2(
                *reinterpret_cast<__nv_bfloat162*>(h1 + at));
            const float x = act.x > 0.f ? rows[i][t][2 * half] : 0.f;
            const float y = act.y > 0.f ? rows[i][t][2 * half + 1] : 0.f;
            const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
            const float2 hf = __bfloat1622float2(h);
            *reinterpret_cast<__nv_bfloat162*>(hi + at) = h;
            store_bf16x2(lo + at, __fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
          }
      }
      __syncthreads();

      // 4. d_w1a += feat^T @ rnd(d_h1) (warps from the top); d_sh1 of the
      // group += onehot^T @ (hi + lo) (warps from the bottom); d_feat =
      // rnd(d_h1) @ w1a^T into the logit buffer. Each sum block is read
      // and written back by the warp that owns it.
      if (warp >= WARPS - D::NB && !no_mlp) {
        const int nt = WARPS - 1 - warp;
        float c[2][4];
        float* p = dw1a + nt * 16;
        load_block(c, p, SH_LD, lp);
        block_mma<CHUNK / 16, false, true>(c, feat, KPAD, hi + nt * 16,
                                           D::LD, lp);
        store_block(p, SH_LD, c, lp);
      }
      if (warp < D::NB && !no_mlp) {
        const int col = warp * 16;
        float c[2][4];
        float* p = sh1_sum + col;
        load_block(c, p, SH_LD, lp);
#pragma unroll
        for (int kt = 0; kt < CHUNK / 16; ++kt) {
          const int* lk = lane_of + kt * 16 + lp.qc;
          const int l0 = lk[0], l1 = lk[1], l8 = lk[8], l9 = lk[9];
          // rows qr + 8 of the one-hot block are rays >= GROUP: zero
          const unsigned af[4] = {onehot2(l0 == lp.qr, l1 == lp.qr), 0u,
                                  onehot2(l8 == lp.qr, l9 == lp.qr), 0u};
          unsigned bf[4];
          const int at = (kt * 16 + lp.lm_r) * D::LD + col + lp.lm_c;
          ldsm_x4_t(bf, hi + at);
          mma_bf16(c[0], af, bf[0], bf[1]);
          mma_bf16(c[1], af, bf[2], bf[3]);
          ldsm_x4_t(bf, lo + at);
          mma_bf16(c[0], af, bf[0], bf[1]);
          mma_bf16(c[1], af, bf[2], bf[3]);
        }
        store_block(p, SH_LD, c, lp);
      }
      if (warp >= D::NB && warp < D::NB + CHUNK / 16) {
        const int mt = warp - D::NB;
        float c[2][4];
        fill_block(c, fill);
        if (!no_mlp)
          block_mma<W / 16, true, false>(c, hi + mt * 16 * D::LD, D::LD,
                                         w1a, D::LD, lp);
        store_block(logit + mt * 16 * KPAD, KPAD, c, lp);
      }
      __syncthreads();

      // 5. the k0 cotangents of every row: one (row, four channels) per
      // thread, over the four taps, a vector reduction per tap and grid
      // slab (one channel at a time where C - 2 is not a multiple of four).
      if (no_scatter) return;
      const bool vec = (k0c & 3) == 0;
      const int per = vec ? k0c / 4 : 1;
      for (int item = tid; item < CHUNK * per; item += THREADS) {
        const int row = item / per, q = item % per;
        const int lr = lane_of[row];
        if (lr < 0) continue;
        const int ms = ms_of[row];
        Station st;
        Window win;
        if (!cell_window(g, ms / S_BLK, tile, win) ||
            !station_at(g, rays + lr, ms, st))
          continue;
        const Taps tp = make_taps(st.u, st.v, win);
        const dvgo::SlabSplit sp = dvgo::slab_split(st.sidx, o.k);
        auto cot_of = [&](int ch) {
          return g.direct ? logit[row * KPAD + ch]
                 : ch < 3 ? dl3[row * 4 + ch]
                          : logit[row * KPAD + ch - 3];
        };
        float c4[4];
        if (vec) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c4[e] = cot_of(4 * q + e);
        }
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          const int ta = tap & 1, tb = tap >> 1;
          const float wu = tp.wu[ta], wv = tp.wv[tb];
          if (wu == 0.f || wv == 0.f) continue;
          float* px = o.d_k0 + ((size_t)sp.z * plane +
                                (size_t)(tp.iu0 + ta) * g.gv +
                                (tp.iv0 + tb)) * k0c;
          if (vec) {
            float lo4[4], hi4[4];
            bool any = false;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = __fmul_rn(wu, round_bf16(__fmul_rn(wv, c4[e])));
              lo4[e] = __fmul_rn(sp.f_lo, x);
              hi4[e] = __fmul_rn(sp.f_hi, x);
              any = any || x != 0.f;
            }
            if (!any) continue;
            dvgo::red_add<4>(px + 4 * q, lo4);
            if (sp.j > 0) dvgo::red_add<4>(px + plane * k0c + 4 * q, hi4);
          } else {
            for (int ch = 0; ch < k0c; ++ch) {
              const float gv_ = cot_of(ch);
              if (gv_ != 0.f)
                dvgo::scatter_tap<true>(px + ch, plane * k0c, sp, wu, wv,
                                        gv_);
            }
          }
        }
      }
    };

    // ---- phase 1: the forward march; gated samples go through the MLP,
    // and T at the start of every window cell is kept for phase 2.
    float t_cum = 1.f;
    const int mb_end = march_rays<CHUNK>(
        g, ms_, rays, tile, t_cum, run_chunk,
        [&](int cell, float t_in) {
          o.t_chk[(size_t)cell * g.n + ray0 + tid] = t_in;
        },
        [](int, bool) {});

    static_assert(sizeof(float) * (THREADS * 9 + MARCH / S_BLK * GROUP) <=
                      sizeof(__nv_bfloat16) * QCAP * KPAD,
                  "phase 2's pair arrays fit in the ring's features");
    // d_sh1 of the group's rays: stored (the group owns them), then zeroed
    // for the next group.
    for (int i = tid; i < GROUP * W; i += THREADS) {
      float* p = sh1_sum + i / W * SH_LD + i % W;
      o.d_sh1[(size_t)ray0 * W + i] = *p;
      *p = 0.f;
    }

    // ---- phase 2: down each ray in reverse march order, a march block at
    // a time: taps and what does not depend on T by pair, the recursion and
    // the suffix sum by ray, the density scatter by pair. Its pair arrays
    // take the place of the ring's features (the ring is empty now).
    if (!(g.mode & MODE_NO_PHASE2)) {
      constexpr int P2_ON = 1, P2_OCC = 2, P2_CELL = 4;   // pair flags
      const int r = tid % GROUP, j = tid / GROUP;
      const float* ray = rays + r;
      const float interval = ray[8 * GROUP];
      // (a, om, 1 / max(om, eps), sigmoid(dens + shift)) and (1 - araw,
      // dL/dw_eff, flags; then T entering the station, w) per pair; d_dens
      // per pair; T entering each window cell of the block per ray.
      float4* p2a = shared_at<float4>(ms_.feat);
      float4* p2b = p2a + THREADS;
      float* p_ddens = reinterpret_cast<float*>(p2b + THREADS);
      float* p_tcell = p_ddens + THREADS;
      const float ga_ainv =
          __fmul_rn(cot[3 * GROUP + r], cot[5 * GROUP + r]);
      float r_suf = 0.f;
      for (int mb = mb_end - 1; mb >= 0; --mb) {
        const int ms = mb * MARCH + j;
        Station st;
        Taps tp;
        Alpha al;
        al.araw = al.a = 0.f, al.om = 1.f, al.occ = false;
        float sig = 0.f, d_weff = 0.f;
        Window win;
        const bool cell = ms < g.s_pad && cell_window(g, ms / S_BLK, tile,
                                                      win);
        const bool on =
            cell && station_at(g, ray, ms, st) && in_range(ray, st.t);
        if (on) {
          tp = make_taps(st.u, st.v, win);
          float geo[2];
          tap_channels<2>(slab_of(g, st.sidx), g.gu, g.gv, g.c, tp, geo);
          al = alpha_of(g, geo[0], geo[1], interval);
          sig = sigmoidf(__fadd_rn(geo[0], g.act_shift));
          // dL/dw_eff, used below only where phase 1 wrote it (w > thres)
          d_weff = o.a_buf[(size_t)ms * g.n + ray0 + r];
        }
        if (cell && j % S_BLK == 0)
          p_tcell[j / S_BLK * GROUP + r] =
              o.t_chk[(size_t)(ms / S_BLK) * g.n + ray0 + r];
        p2a[tid] = make_float4(al.a, al.om,
                               __fdiv_rn(1.f, fmaxf(al.om, T_EPS)), sig);
        p2b[tid] = make_float4(
            __fsub_rn(1.f, al.araw), d_weff,
            __int_as_float((on ? P2_ON : 0) | (al.occ ? P2_OCC : 0) |
                           (cell ? P2_CELL : 0)),
            0.f);
        if (!__syncthreads_or(cell)) continue;   // every cell inactive
        if (tid < GROUP) {
          // The recursion from the T of each active cell (the forward skips
          // a station once the ray has terminated; such a station has a = 0
          // here too), then the stations in reverse; loads issue ahead of
          // the serial arithmetic, as in the forward.
          float t_run = 1.f;
          unsigned long long occ = 0ull, live = 0ull;
#pragma unroll 8
          for (int jj = 0; jj < MARCH; ++jj) {
            const int k = jj * GROUP + tid;
            const float4 pa = p2a[k];
            const int fl = __float_as_int(p2b[k].z);
            const float t_cell = p_tcell[jj / S_BLK * GROUP + tid];
            float t_in = 0.f, w = 0.f;
            if (fl & P2_CELL) {
              if (jj % S_BLK == 0) t_run = t_cell;
              t_in = t_run;
              if (t_run >= T_TERMINATE) live |= 1ull << jj;
              if ((fl & P2_ON) && t_run >= T_TERMINATE) {
                w = __fmul_rn(t_run, pa.x);
                if (fl & P2_OCC) occ |= 1ull << jj;
                t_run = __fmul_rn(t_run, pa.y);
              }
            }
            *reinterpret_cast<float2*>(&p2b[k].z) = make_float2(t_in, w);
          }
#pragma unroll 8
          for (int jj = MARCH - 1; jj >= 0; --jj) {
            const int k = jj * GROUP + tid;
            const float4 pa = p2a[k], pb = p2b[k];
            float d_dens = 0.f;
            if ((occ >> jj) & 1ull) {   // d_alpha is zero off occ
              const bool lv = (live >> jj) & 1ull;
              const float d_w = pb.w > g.thres ? pb.y : 0.f;
              const float a_term = lv ? ga_ainv : 0.f;
              const float d_alpha = __fsub_rn(
                  lv ? __fmul_rn(d_w, pb.z) : 0.f,
                  __fmul_rn(__fadd_rn(r_suf, a_term), pa.z));
              d_dens = __fmul_rn(
                  __fmul_rn(__fmul_rn(d_alpha, interval), pa.w), pb.x);
              r_suf = __fadd_rn(r_suf, __fmul_rn(d_w, pb.w));
            }
            p_ddens[k] = d_dens;
          }
        }
        __syncthreads();
        const float d_dens = p_ddens[tid];
        if (on && d_dens != 0.f && !no_scatter) {
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
  }

  // ---- the launch's sums, once, by reductions.
  __syncthreads();
  for (int i = tid; i < W * W / 4; i += THREADS) {
    const float* x = dw2 + i / (W / 4) * W2_LD + i % (W / 4) * 4;
    if (x[0] != 0.f || x[1] != 0.f || x[2] != 0.f || x[3] != 0.f)
      dvgo::red_add<4>(o.d_w2 + i * 4, x);
  }
  for (int i = tid; i < W * KPAD; i += THREADS) {
    const float x = dw3[i / KPAD * W3_LD + i % KPAD];
    if (x != 0.f) atomicAdd(o.d_w3 + i, x);
  }
  for (int i = tid; i < KPAD * W; i += THREADS) {
    const float x = dw1a[i / W * SH_LD + i % W];
    if (x != 0.f) atomicAdd(o.d_w1a + i, x);
  }
  if (tid < W) {   // b2: the warps whose row blocks cover column tid
    const int nt = tid / 16;
    float x = 0.f;
    for (int w = nt; w < min(WARPS, D::ROW_BLOCKS); w += D::NB)
      x += db2[w * 16 + tid % 16];
    if (x != 0.f) atomicAdd(o.d_b2 + tid, x);
  }
  if (tid < 3) {
    const float x = db3[tid] + db3[4 + tid];
    if (x != 0.f) atomicAdd(o.d_b3 + tid, x);
  }
}

template <int W>
cudaError_t launch(const Geometry& g, const BwdOut& o, cudaStream_t st) {
  const BwdSmem<W> lay;
  int blocks = 0;
  cudaError_t err = persistent_blocks(train_fused_bwd_kernel<W>, lay.total,
                                      g.n / GROUP, &blocks);
  if (err != cudaSuccess) return err;
  void* counter = nullptr;
  err = cudaGetSymbolAddress(&counter, g_next_group);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  train_fused_bwd_kernel<W><<<blocks, THREADS, lay.total, st>>>(g, o);
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
// by the caller. mode: a diagnostic form (train_fused.cuh), 0 for the
// kernel.
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
  if (n < 1 || nt < 1 || n % nt != 0 || nt % GROUP != 0 || s_real < 1 ||
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
