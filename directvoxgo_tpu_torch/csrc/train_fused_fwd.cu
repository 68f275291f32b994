// Fused train-step forward (kernel K-D): station sweep, alpha, live-gated
// transmittance, fast_color_thres gates, colour MLP and the per-ray sums the
// training loss reads, in one launch.
//
// Replaces: directvoxgo_tpu/ops/pallas_train_fused.py::train_fwd_pallas (the
// windowed and the full form).
//
// Per ray, stations are visited in march order (station ms at axis
// coordinate p0 + pstep*ms):
//   t = (p_s - op)/dp, u = fma(t, du, ou), v = fma(t, dv, ov)
//   vals = bilinear tap of the bf16 slab (u weights bf16, v weights f32)
//   alpha_raw = 1 - exp(-softplus(dens + act_shift) * interval)
//   a = alpha_raw where t in [t_lo, t_hi], t_hi > t_lo, mask > 0 and
//       alpha_raw > thres, else 0
//   live = T >= 1e-3;  w = T*a where live;  w_eff = w where w > thres
//   T <- T*(1 - a + 1e-10) where live and a > 0
//   rgb = sigmoid(MLP(k0 taps; sh1[ray]) [+ k0[:3] taps]) where w_eff > 0
//   rgb_marched = sum w_eff*rgb + T*bg, alphainv_last = T,
//   rgbper_sum = sum w_eff*|rgb - gt|^2
// With windows a cell (8-station block, ray tile) reads only its (wu, wv)
// window of the slabs, and a cell marked inactive is skipped.
//
// Bound on the H100: the bytes are small (the slab voxels the rays tap, the
// rays, sh1 and an [8, N] result); nothing of size [N, S] reaches device
// memory. The work is the MLP of the gated samples, bf16 products with f32
// sums, which is what the tensor cores compute; the TPU kernel ran it on
// every sample of a (block, tile) cell that held one gated sample, here it
// runs on the gated samples alone. What is left serial is the transmittance
// recursion of each ray, a few multiplications a station.
// Design (train_fused.cuh): persistent blocks of 512 threads take groups of
// 8 rays from a counter, one thread per (station, ray) pair of a 64-station
// march block: the taps of all 512 pairs are gathered at once, then 8
// threads run the recursion from shared memory, then the gated pairs are
// compacted into a ring by warp ballot. Whenever 64 samples wait, the sixteen
// warps run the three layers on them with m16n8k16 bf16 tensor-core tiles,
// one 16x16 output block per warp and turn (K padded from F to 16 with zeros,
// exact), the weights and the bf16 hidden activations in shared memory, bias,
// ReLU and rounding applied to the accumulators; the rows' shares of the ray
// sums are summed over each row warp by shuffles (no atomics). The MLP stays on
// mma.sync: in the first version's breakdown on the lego fine step it is a
// quarter of the kernel's time, and a chunk of 64 rows is a single wgmma
// tile. No residual is saved for the backward, which taps the slabs again
// (see train_fused_bwd.cu).

#include "train_fused.cuh"

namespace {

using namespace dvgo_fused;

__device__ unsigned g_next_group;   // the launch's counter of groups taken

// Samples per MLP pass: twice K-E's (which has no shared memory left for
// it), so that the barriers and latency chains of a pass spread over twice
// the rows.
constexpr int FWD_CHUNK = 2 * CHUNK;
constexpr int ROW_WARPS = FWD_CHUNK / 32;   // warps of the row epilogue

// One level of a reduce-scatter over the warp: terms [0, 2 HALF) of t
// become the sums over lanes l and l ^ HALF of the half that lane l keeps
// (the upper one where l & HALF), in t[0, HALF). After the levels 16 down to
// 1, lane l holds in t[0] the warp's sum of term l. Constant indices, so t
// stays in registers.
template <int HALF>
__device__ __forceinline__ void butterfly_level(float (&t)[32], int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? t[i] : t[i + HALF];
    const float keep = upper ? t[i + HALF] : t[i];
    t[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, HALF));
  }
}

template <int W>
struct FwdSmem {
  MarchSmem march;
  MlpSmem mlp;
  unsigned rays, acc, group, total;
  __host__ __device__ FwdSmem() {
    Carver c;
    rays = c.take(sizeof(float) * RAY_ROWS * GROUP);
    march.carve(c);
    mlp.h1 = mlp.h2 =
        c.take(sizeof(__nv_bfloat16) * FWD_CHUNK * MlpDims<W>::LD);
    mlp.logit = c.take(sizeof(float) * FWD_CHUNK * KPAD);
    acc = c.take(sizeof(float) * ROW_WARPS * GROUP * 4);   // slot per warp
    group = c.take(sizeof(int));
    mlp.w1a = c.take(sizeof(__nv_bfloat16) * KPAD * MlpDims<W>::LD);
    mlp.w2 = c.take(sizeof(__nv_bfloat16) * W * MlpDims<W>::LD);
    mlp.w3 = c.take(sizeof(__nv_bfloat16) * W * KPAD);
    total = c.at;
  }
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
train_fused_fwd_kernel(Geometry g, float* __restrict__ pack) {
  const FwdSmem<W> lay;
  float* rays = shared_at<float>(lay.rays);
  float* acc = shared_at<float>(lay.acc);
  const int tid = threadIdx.x;
  load_weights<W>(g, lay.mlp);

  for (;;) {
    const int grp =
        next_group(&g_next_group, shared_at<int>(lay.group), g.n / GROUP);
    if (grp < 0) break;
    const int ray0 = grp * GROUP;
    const int tile = ray0 / g.nt;
    for (int i = tid; i < RAY_ROWS * GROUP; i += THREADS)
      rays[i] = g.rays16[(size_t)(i / GROUP) * g.n + ray0 + i % GROUP];
    if (tid < ROW_WARPS * GROUP * 4) acc[tid] = 0.f;
    if (tid < GROUP) shared_at<float>(lay.march.t_start)[tid] = 1.f;
    __syncthreads();

    // The MLP on the chunk at `base`, and its rows' shares of the ray sums:
    // each of the row warps sums its rows' (ray, sum) terms over the
    // warp by a butterfly that leaves lane l with term l (ray l / 4, sum
    // l % 4), and adds it to its own slot; no atomics, no barrier.
    auto run_chunk = [&](int base) {
      mlp_forward<W, FWD_CHUNK>(g, lay.march, lay.mlp, base, ray0);
      if (tid < FWD_CHUNK) {
        const int row = tid, lane = tid & 31;
        const int lr = shared_at<int>(lay.march.lane)[base + row];
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (lr >= 0) {
          float rgb[3];
          row_rgb(g, shared_at<float>(lay.mlp.logit),
                  shared_at<float>(lay.march.aux) + base * 4, row, rgb);
          const float weff = shared_at<float>(lay.march.q_weff)[base + row];
          float per = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            v[ch] = __fmul_rn(weff, rgb[ch]);
            const float d = __fsub_rn(rgb[ch], rays[(9 + ch) * GROUP + lr]);
            per = __fadd_rn(per, __fmul_rn(d, d));
          }
          v[3] = __fmul_rn(weff, per);
        }
        float t[GROUP * 4];   // term r * 4 + k: v[k] where the row is ray r
#pragma unroll
        for (int i = 0; i < GROUP * 4; ++i) t[i] = lr == i / 4 ? v[i % 4] : 0.f;
        butterfly_level<16>(t, lane);
        butterfly_level<8>(t, lane);
        butterfly_level<4>(t, lane);
        butterfly_level<2>(t, lane);
        butterfly_level<1>(t, lane);
        acc[(tid >> 5) * 32 + lane] = __fadd_rn(acc[(tid >> 5) * 32 + lane],
                                                t[0]);
      }
    };

    float t_cum = 1.f;
    int n_gated = 0, sum1 = 0, sum2 = 0;   // the gates' fingerprint
    march_rays<FWD_CHUNK>(g, lay.march, rays, tile, t_cum, run_chunk,
               [](int, float) {},
               [&](int ms, bool on) {
                 const int m1 = on ? ms + 1 : 0;
                 n_gated += on, sum1 += m1, sum2 += m1 * m1;
               });
    if (tid < GROUP) {
      const int r = ray0 + tid;
      float sum[4] = {0.f, 0.f, 0.f, 0.f};   // over the row warps' slots
#pragma unroll
      for (int w = 0; w < ROW_WARPS; ++w)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sum[k] = __fadd_rn(sum[k], acc[w * 32 + tid * 4 + k]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        pack[(size_t)ch * g.n + r] =
            __fadd_rn(sum[ch], __fmul_rn(t_cum, g.bg));
      pack[(size_t)3 * g.n + r] = t_cum;
      pack[(size_t)4 * g.n + r] = sum[3];
      const bool fp = g.mode & MODE_GATES;
      pack[(size_t)5 * g.n + r] = fp ? (float)n_gated : 0.f;
      pack[(size_t)6 * g.n + r] = fp ? (float)sum1 : 0.f;
      pack[(size_t)7 * g.n + r] = fp ? (float)sum2 : 0.f;
    }
  }
}

template <int W>
cudaError_t launch(const Geometry& g, float* pack, cudaStream_t st) {
  const FwdSmem<W> lay;
  int blocks = 0;
  cudaError_t err = persistent_blocks(train_fused_fwd_kernel<W>, lay.total,
                                      g.n / GROUP, &blocks);
  if (err != cudaSuccess) return err;
  void* counter = nullptr;
  err = cudaGetSymbolAddress(&counter, g_next_group);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  train_fused_fwd_kernel<W><<<blocks, THREADS, lay.total, st>>>(g, pack);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// slabs [S, Gu, Gv, C] bf16 station slabs in slab order (channel 0 density,
// 1 mask, then k0); rays16 [16, N] f32 rows (op, ou, ov, dp != 0, du, dv,
// t_lo, t_hi, interval, gt r g b, ...), every dp of one sign; sh1 [N, W] f32
// (view half of layer 1 plus b1, per ray); w1a [16, W] bf16 (rows >= F
// zero), w2 [W, W] bf16, b2 [W] f32, w3 [W, 16] bf16 and b3 [16] f32
// (columns >= 3 zero), all [in, out]; uvb [s_pad/8, N/nt, 4] int32 window
// cells (u_base/16, v_base/8, active, 0) when windowed, with window extents
// (wu, wv); pack [8, N] f32 out. March station ms sits at p0 + pstep*ms and
// reads slab ms (s_pad - 1 - ms when desc). N must be a multiple of nt, and
// nt of the 8 rays of a group. mode: a diagnostic form (train_fused.cuh), 0
// for the kernel.
int dvgo_train_fused_fwd(const void* slabs, const float* rays16,
                         const float* sh1, const void* w1a, const void* w2,
                         const float* b2, const void* w3, const float* b3,
                         const int* uvb, float* pack, int n, int s_real,
                         int s_pad, int gu, int gv, int c, int f, int width,
                         int direct, int desc, int nt, int windowed, int wu,
                         int wv, float p0, float pstep, float act_shift,
                         float thres, float bg, int mode, void* stream) {
  if (n < 1 || nt < 1 || n % nt != 0 || nt % GROUP != 0 || s_real < 1 ||
      s_pad < s_real || s_pad % S_BLK != 0 || f < 1 || f > KPAD ||
      c != (direct ? 2 : 5) + f || (windowed && uvb == nullptr))
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 32: return static_cast<int>(launch<32>(g, pack, st));
    case 64: return static_cast<int>(launch<64>(g, pack, st));
    case 128: return static_cast<int>(launch<128>(g, pack, st));
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
