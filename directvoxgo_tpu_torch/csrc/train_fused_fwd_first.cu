// The first version of kernel K-D, kept beside its redesign
// (train_fused_fwd.cu) as the yardstick of its time; built only by
// chip_smoke.py, never loaded by the port. mode: see train_fused_first.cuh.
//
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
// runs on the gated samples alone. The march itself is a chain of dependent
// transmittance updates per ray and cannot spread over more threads than
// there are rays (8192 at lego width), so it is bound by latency, not by
// bytes or operations.
// Design: a block owns 64 rays and loops over all stations itself (nothing
// carries between blocks). One thread marches each ray with two-tap reads, as
// the sweep kernels do, all 14 channels of the four taps loaded at once
// (two warps hide no latency, so no load may wait for another). Gated samples
// are compacted into a ring in shared memory, and whenever 64 wait, four
// warps run the three layers on them, 16 rows each, with m16n8k16 bf16
// tensor-core tiles: K padded from F to 16 with zeros (exact), ldmatrix from
// shared memory, where the weights and the bf16 hidden activations sit, and
// bias, ReLU and rounding applied to the accumulators. The block leaves the
// station loop as soon as all its rays have terminated or passed t_hi. No
// residual is saved for the backward, which taps the slabs again (see
// train_fused_bwd.cu).

#include "train_fused_first.cuh"

namespace {

using namespace dvgo_fused;

template <int W>
struct FwdSmem {
  unsigned rays, q_feat, q_lane, q_ms, q_weff, q_aux, q_state, h1, h2,
      logit, acc, gates, w1a, w2, w3, total;
  __host__ __device__ FwdSmem() {
    Carver c;
    rays = c.take(sizeof(float) * RAY_ROWS * RAYS);
    q_feat = c.take(sizeof(__nv_bfloat16) * QCAP * KPAD);
    q_lane = c.take(sizeof(int) * QCAP);
    q_ms = c.take(sizeof(int) * QCAP);
    q_weff = c.take(sizeof(float) * QCAP);
    q_aux = c.take(sizeof(float) * QCAP * 4);
    q_state = c.take(sizeof(int) * 2);
    h1 = c.take(sizeof(__nv_bfloat16) * CHUNK * MlpDims<W>::LD);
    h2 = c.take(sizeof(__nv_bfloat16) * CHUNK * MlpDims<W>::LD);
    logit = c.take(sizeof(float) * CHUNK * KPAD);
    acc = c.take(sizeof(float) * RAYS * 4);
    gates = c.take(sizeof(int) * RAYS * 3);
    w1a = c.take(sizeof(__nv_bfloat16) * KPAD * MlpDims<W>::LD);
    w2 = c.take(sizeof(__nv_bfloat16) * W * MlpDims<W>::LD);
    w3 = c.take(sizeof(__nv_bfloat16) * W * KPAD);
    total = c.at;
  }
};

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
train_fused_fwd_kernel(Geometry g, float* __restrict__ pack) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<W> lay;
  float* rays = reinterpret_cast<float*>(smem + lay.rays);
  Queue q;
  q.feat = reinterpret_cast<__nv_bfloat16*>(smem + lay.q_feat);
  q.lane = reinterpret_cast<int*>(smem + lay.q_lane);
  q.ms = reinterpret_cast<int*>(smem + lay.q_ms);
  q.weff = reinterpret_cast<float*>(smem + lay.q_weff);
  q.aux = reinterpret_cast<float*>(smem + lay.q_aux);
  q.state = reinterpret_cast<int*>(smem + lay.q_state);
  float* logit = reinterpret_cast<float*>(smem + lay.logit);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  int* gates = reinterpret_cast<int*>(smem + lay.gates);
  MlpSmem mlp;
  mlp.feat = lay.q_feat, mlp.lane = lay.q_lane, mlp.h1 = lay.h1;
  mlp.h2 = lay.h2, mlp.logit = lay.logit;
  mlp.w1a = lay.w1a, mlp.w2 = lay.w2, mlp.w3 = lay.w3;

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * RAYS;
  const int tile = ray0 / g.nt;
  for (int i = tid; i < RAY_ROWS * RAYS; i += THREADS)
    rays[i] = g.rays16[(size_t)(i / RAYS) * g.n + ray0 + i % RAYS];
  for (int i = tid; i < RAYS * 4; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < RAYS * 3; i += THREADS) gates[i] = 0;
  if (tid < 2) q.state[tid] = 0;
  queue_pad(q, 0, 0);
  queue_pad(q, CHUNK, 0);
  load_weights<W>(g, mlp);
  __syncthreads();

  float t_cum = 1.f;

  // The MLP on the chunk at `base`, and its rows' shares of the ray sums.
  auto run_chunk = [&](int base) {
    mlp_forward_rows<W>(g, mlp, base, ray0);
    const int lane = tid & 31;
    if (lane < 16) {
      const int row = (tid >> 5) * 16 + lane;
      const int lr = q.lane[base + row];
      if (lr >= 0) {
        float rgb[3];
        row_rgb(g, logit, q.aux + base * 4, row, rgb);
        const float weff = q.weff[base + row];
        float per = 0.f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          atomicAdd(&acc[lr * 4 + ch], __fmul_rn(weff, rgb[ch]));
          const float d = __fsub_rn(rgb[ch], rays[(9 + ch) * RAYS + lr]);
          per = __fadd_rn(per, __fmul_rn(d, d));
        }
        atomicAdd(&acc[lr * 4 + 3], __fmul_rn(weff, per));
        if (g.mode & MODE_GATES) {
          const int m1 = q.ms[base + row] + 1;
          atomicAdd(&gates[lr * 3], 1);
          atomicAdd(&gates[lr * 3 + 1], m1);
          atomicAdd(&gates[lr * 3 + 2], m1 * m1);
        }
      }
    }
  };

  march_rays(g, q, rays, tile, t_cum, run_chunk, [](int, float) {});
  if (tid < RAYS) {
    const int r = ray0 + tid;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      pack[(size_t)ch * g.n + r] =
          __fadd_rn(acc[tid * 4 + ch], __fmul_rn(t_cum, g.bg));
    pack[(size_t)3 * g.n + r] = t_cum;
    pack[(size_t)4 * g.n + r] = acc[tid * 4 + 3];
#pragma unroll
    for (int row = 5; row < 8; ++row)
      pack[(size_t)row * g.n + r] =
          (g.mode & MODE_GATES) ? (float)gates[tid * 3 + row - 5] : 0.f;
  }
}

template <int W>
cudaError_t launch(const Geometry& g, float* pack, cudaStream_t st) {
  const FwdSmem<W> lay;
  cudaError_t err = cudaFuncSetAttribute(
      train_fused_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)lay.total);
  if (err != cudaSuccess) return err;
  train_fused_fwd_kernel<W><<<g.n / RAYS, THREADS, lay.total, st>>>(g, pack);
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
// nt of the 64 rays a block owns.
int dvgo_train_fused_fwd(const void* slabs, const float* rays16,
                         const float* sh1, const void* w1a, const void* w2,
                         const float* b2, const void* w3, const float* b3,
                         const int* uvb, float* pack, int n, int s_real,
                         int s_pad, int gu, int gv, int c, int f, int width,
                         int direct, int desc, int nt, int windowed, int wu,
                         int wv, float p0, float pstep, float act_shift,
                         float thres, float bg, int mode, void* stream) {
  if (n < 1 || nt < 1 || n % nt != 0 || nt % RAYS != 0 || s_real < 1 ||
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
