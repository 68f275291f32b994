// Per-op cost probe of the fused frame kernels' op classes (kernel K-G),
// redesigned for Hopper.
//
// Replaces: tools/probe_mosaic.py's pallas_call (build(), the probe of
// Mosaic op costs at the frame kernels' shapes). One launch runs G blocks;
// each block runs R reps of one op body, rep i reading its own weight
// slice (so no two reps can be merged or hoisted), and reduces every
// element of every rep's output into the block's digest, folded in f64 and
// written to partial[block]. The digest of the launch is the sum of the G
// partials. Per-op cost, as in the TPU probe: (t(G) - t_null(G)) / (G*R).
// On the card the G blocks run side by side on 132 SMs, so that figure is
// the op's cost at full occupancy, not one op's latency. The first version
// (csrc/probe_ops_first.cu: wmma fragments loaded straight from L2, reps
// the outer loop, scalar loads) is kept beside this one as its yardstick.
//
// Matmul classes (b12, b8geo, lead, mm, mmT, small, r3dot, r3f): wgmma
// from shared memory. A block is three warpgroups: one thread of the first
// streams operand tiles with TMA into shared memory, completing each on an
// mbarrier, and the other two warpgroups each issue m64nNk16 bf16 wgmmas
// on 64 rows of the A tile, with f32 accumulators in registers. Tiles sit
// in wgmma's swizzled layouts, as TMA writes them: 128-byte swizzle where
// the operand's contiguous extent holds whole 64-column atoms, else the
// 64-byte one (k = 160 is 5 atoms of 32, not a multiple of 64). K-major
// operands (A of every class but lead, B of small) and MN-major ones
// (lead's A, stored [k][m]; every other B, stored [k][n]) use the same
// copy, the transpose bits telling them apart. The operand without the rep
// index is held in shared memory across the reps (reps are the inner
// loop) and the rep-indexed one streams through a ring of 3-7 stages
// (ops/probe_ops.py's gemm_plan): r3dot / r3f and lead hold every rep's
// w[i] (128 / 16 KB) and stream tiles of x; mmT holds w and streams x[i];
// mm, small, b12 and b8geo hold x (one batch entry at a time, in a ring of
// two) and stream w[i] in n-tiles of 128 (b8geo 64: n = 320 is above
// wgmma's 256, and 64 leaves room for 7 stages). A step's wgmmas are
// unrolled (one instance per step shape), a consumer keeps one step's
// group in flight behind the next (wait_group 1) and chains the reps' and
// tiles' products in its accumulators as wgmma chains k-steps; at the end
// it sums them in f32 and folds that into the block's f64 digest. Every
// rep's full product runs on the tensor cores: no sum of the w[i], no row
// or column reduced before a product. Nothing is written per element.
//
// Elementwise classes: 16-byte loads (4 f32 or 8 bf16 a thread), reps the
// inner loop over a register-resident chunk of x, f32 sums per rep and one
// f64 fold: null x * 1.0001 (f32, __fmul_rn), vpu2d / vpu3d8 expf(x * w)
// (f32), acc bf16(x * w) (mul.rn.bf16x2 on packed pairs: the exact product
// rounded once to bf16, as __float2bfloat16_rn of the f32 product), whose
// products are summed in f32 by an mma.sync m16n8k16 against a tile of
// ones (each product counted 8 times, scaled by 1/8 in the fold).
//
// Bounds on the H100 (tools/probe_ops.py): the matmul classes by the bf16
// tensor rate (989 TFLOP/s; lead counts k = 12 of the 16 it runs, so it
// can reach 75% at most); acc by its packed bf16 multiplies (133.8 TFLOP/s);
// the exp classes by the special-function units (16 exps per SM per clock).
// What holds each class below its bound: the bytes a block must bring in
// per op under this loop order (the held operand / reps + one rep's slice,
// 46 KB for small up to 1.06 MB for r3dot / r3f), read from L2. The
// classes that stream w[i] (b12, b8geo, mm, mmT, small) are held by the
// L2-to-SM rate, r3dot / r3f and lead by the tensor cores; acc by its
// mma.sync reduction (8 tensor FMAs a product); vpu2d and vpu3d8 read
// w[i] whole in every block (64 / 512 KB), from L1 / L2.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;       // elementwise blocks
constexpr int GEMM_THREADS = 384;  // producer warpgroup + two consumers
constexpr int MAX_REPS = 8;
constexpr int MAX_STAGES = 8;
constexpr int MAX_HELD = 2;
constexpr int ACC_LOADS = 8;  // 16-byte loads a thread keeps in flight (acc)
// Dynamic shared memory a plan may take: the H100's 227 KB a block, less
// 1 KB for the static barriers and sums.
constexpr int SMEM_LIMIT = 232448 - 1024;

// Sum of v over the block; thread 0 writes it to *out.
template <int NT>
__device__ void block_sum_write(double v, double* out) {
  __shared__ double warp_sums[NT / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < NT / 32; ++i) s += warp_sums[i];
    *out = s;
  }
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One TMA copy of a box of the 2D tensor map at (c0, c1) to shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in a SW-byte swizzle (64 or
// 128: the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_64B / _128B): a
// tile of R rows is R x SW-byte atoms of SW / 2 columns side by side.
// K-major, SBO the 8 * SW bytes of 8 rows and LBO unused; MN-major, LBO
// the R * SW bytes of an atom and SBO the 8 * SW bytes of 8 k-rows.
template <int SW>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62;
}

// The descriptor strides of an operand tile of R rows in a SW-byte swizzle
// (MN: stored MN-major): the byte offset of k-step ks (16 deep) and of a
// 64-wide slab along M.
template <int SW, int MN>
struct TileGeom {
  uint32_t rows;
  __device__ uint32_t lbo() const { return MN ? rows * SW : 16u; }
  __device__ uint32_t sbo() const { return 8u * SW; }
  __device__ uint32_t kstep(int ks) const {
    return MN ? ks * 16u * SW
              : (ks / (SW / 32)) * rows * SW + (ks % (SW / 32)) * 32u;
  }
  __device__ uint32_t slab() const { return MN ? 128u * rows : 64u * SW; }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A * B, m64nNk16, bf16 in, f32 accumulators; TA / TB the transpose
// bits (1: the operand is MN-major in shared memory).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_any(float (&d)[N / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_n64<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n128<TA, TB>(d, da, db, scale_d);
}

// ------------------------------------------------------------ matmul body

// The loop of one block (ops/probe_ops.py's gemm_plan): for o < n_o, the
// held operand's slot o % h_slots takes n_h tiles from held_src(o, h);
// then for j < n_j one streamed tile from stream_src(o, j) runs the
// products of step (o, j). A tile of R global rows and C columns (bf16,
// row stride ld) is copied whole. The A tile spans mt rows (M) and the B
// tile n columns (N), both over k.
struct Plan {
  long long n_o, n_j, n_h, h_slots, stages, a_streamed, a_total, b_total;
  long long a_rows, a_cols, lda, b_rows, b_cols, ldb;
  long long s_so, s_jdiv, s_sj1, s_sj2, h_so, h_sh;
  long long mt, n, k, a_mn, b_mn, a_sw, b_sw;
};
constexpr int PLAN_LEN = sizeof(Plan) / sizeof(long long);

struct GemmArgs {
  CUtensorMap ta, tb;  // A and B as [total rows][ld], boxes of an atom x rows
  Plan p;
};

// Loads the rows x cols tile at element offset off of a [total][ld] operand
// with TMA, one box of sw / 2 columns (one swizzle atom) at a time.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         long long off, long long ld,
                                         int rows, int cols, int sw,
                                         uint32_t bar) {
  const int row0 = (int)(off / ld), col0 = (int)(off % ld);
  for (int a = 0; a < cols / (sw / 2); ++a)
    tma_load_2d(dst + a * rows * sw, map, col0 + a * (sw / 2), row0, bar);
}


template <int N, int TA, int TB, int KSTEPS, int NHB, int SLABS, int SA,
          int SB>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_probe(const __grid_constant__ GemmArgs args, double* partial) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 2 * MAX_HELD];
  const Plan& p = args.p;
  const int tid = threadIdx.x;
  const int a_bytes = (int)(p.a_rows * p.a_cols * 2);
  const int b_bytes = (int)(p.b_rows * p.b_cols * 2);
  const int s_bytes = p.a_streamed ? a_bytes : b_bytes;
  const int h_bytes = p.a_streamed ? b_bytes : a_bytes;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t held0 = base;
  const uint32_t ring0 = base + (uint32_t)(p.h_slots * p.n_h * h_bytes);
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  const uint32_t hfull0 = empty0 + 8 * MAX_STAGES;
  const uint32_t hempty0 = hfull0 + 8 * MAX_HELD;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);
    }
    for (int h = 0; h < p.h_slots; ++h) {
      mbar_init(hfull0 + 8 * h, 1);
      mbar_init(hempty0 + 8 * h, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int s_rows = (int)(p.a_streamed ? p.a_rows : p.b_rows);
  const int s_cols = (int)(p.a_streamed ? p.a_cols : p.b_cols);
  const int s_ld = (int)(p.a_streamed ? p.lda : p.ldb);
  const int h_rows = (int)(p.a_streamed ? p.b_rows : p.a_rows);
  const int h_cols = (int)(p.a_streamed ? p.b_cols : p.a_cols);
  const int h_ld = (int)(p.a_streamed ? p.ldb : p.lda);
  double total = 0.0;
  // The warpgroup's role, broadcast from lane 0 so that the compiler knows
  // it is uniform across the warpgroup (wgmma in a branch it cannot prove
  // uniform is serialized).
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (role == 0) {
    // Producer: one thread issues the held tiles of o, then the streamed
    // tiles of its steps, as TMA copies completing on the stage's barrier.
    if (tid == 0) {
      const CUtensorMap* s_map = p.a_streamed ? &args.ta : &args.tb;
      const CUtensorMap* h_map = p.a_streamed ? &args.tb : &args.ta;
      const int s_sw = p.a_streamed ? SA : SB, h_sw = p.a_streamed ? SB : SA;
      long long it = 0;
      for (long long o = 0; o < p.n_o; ++o) {
        const int hs = (int)(o % p.h_slots);
        mbar_wait(hempty0 + 8 * hs, (uint32_t)(((o / p.h_slots) & 1) ^ 1));
        mbar_expect_tx(hfull0 + 8 * hs, (uint32_t)(p.n_h * h_bytes));
        for (int h = 0; h < p.n_h; ++h)
          tma_tile(held0 + (uint32_t)((hs * p.n_h + h) * h_bytes), h_map,
                   o * p.h_so + h * p.h_sh, h_ld, h_rows, h_cols, h_sw,
                   hfull0 + 8 * hs);
        for (long long j = 0; j < p.n_j; ++j, ++it) {
          const int st = (int)(it % p.stages);
          mbar_wait(empty0 + 8 * st, (uint32_t)(((it / p.stages) & 1) ^ 1));
          mbar_expect_tx(full0 + 8 * st, (uint32_t)s_bytes);
          tma_tile(ring0 + (uint32_t)(st * s_bytes), s_map,
                   o * p.s_so + (j / p.s_jdiv) * p.s_sj1 +
                       (j % p.s_jdiv) * p.s_sj2,
                   s_ld, s_rows, s_cols, s_sw, full0 + 8 * st);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg takes the A tile's 64-row slabs wg, wg + 2,
    // ... (SLABS of them), each against NHB tiles of B, in KSTEPS k-steps:
    // a step's wgmmas are unrolled, so the accumulators stay in place and
    // the compiler inserts no waits of its own.
    const int wg = role - 1;
    const bool lane0 = (tid & 31) == 0;
    const TileGeom<SA, TA> ga{(uint32_t)p.a_rows};
    const TileGeom<SB, TB> gb{(uint32_t)p.b_rows};
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int scale = 0;
    long long it = 0;
    for (long long o = 0; o < p.n_o; ++o) {
      const int hs = (int)(o % p.h_slots);
      mbar_wait(hfull0 + 8 * hs, (uint32_t)((o / p.h_slots) & 1));
      const uint32_t held = held0 + (uint32_t)(hs * p.n_h * h_bytes);
      for (long long j = 0; j < p.n_j; ++j, ++it) {
        const int st = (int)(it % p.stages);
        mbar_wait(full0 + 8 * st, (uint32_t)((it / p.stages) & 1));
        const uint32_t stage = ring0 + (uint32_t)(st * s_bytes);
        const uint32_t a_tile = (p.a_streamed ? stage : held) + wg * ga.slab();
        const uint32_t b_tile = p.a_streamed ? held : stage;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
          for (int h = 0; h < NHB; ++h)
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
              const uint32_t a_at = a_tile + 2 * sl * ga.slab() + ga.kstep(ks);
              const uint32_t b_at = b_tile + h * b_bytes + gb.kstep(ks);
              wgmma_any<N, TA, TB>(
                  acc, gmma_desc<SA>(a_at, ga.lbo(), ga.sbo()),
                  gmma_desc<SB>(b_at, gb.lbo(), gb.sbo()), scale);
              scale = 1;
            }
        wgmma_commit();
        fence_acc(acc);
        // The previous step's products are done: hand its stage back (and
        // its held slot after the last step of its o).
        wgmma_wait<1>();
        fence_acc(acc);
        if (it > 0 && lane0) {
          mbar_arrive(empty0 + 8 * (uint32_t)((it - 1) % p.stages));
          if ((it - 1) % p.n_j == p.n_j - 1)
            mbar_arrive(hempty0 + 8 * (uint32_t)((it - 1) / p.n_j % p.h_slots));
        }
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sum += acc[i];
    total = (double)sum;
  }
  block_sum_write<GEMM_THREADS>(total, partial + blockIdx.x);
}

// ------------------------------------------------------- elementwise body

// KIND 0: f32 x[e] * 1.0001 (no w); 1: bf16(x[e] * w[r][e % period]) with
// bf16 x and w (period a power of two, a multiple of 8 dividing
// 8 * THREADS); 2: f32 exp(x[e] * w[r][e]).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
elem_probe(const void* __restrict__ x, const void* __restrict__ w, int n,
           long long w_rep, int period, int reps, double* partial) {
  const int t = threadIdx.x;
  float sum[MAX_REPS];
#pragma unroll
  for (int r = 0; r < MAX_REPS; ++r) sum[r] = 0.f;
  if constexpr (KIND == 0) {
    const float4* x4 = static_cast<const float4*>(x);
    for (int c = t; c < n / 4; c += THREADS) {
      const float4 v = x4[c];
#pragma unroll
      for (int r = 0; r < MAX_REPS; ++r)
        if (r < reps) {
          sum[r] += __fmul_rn(v.x, 1.0001f);
          sum[r] += __fmul_rn(v.y, 1.0001f);
          sum[r] += __fmul_rn(v.z, 1.0001f);
          sum[r] += __fmul_rn(v.w, 1.0001f);
        }
    }
  } else if constexpr (KIND == 2) {
    const float4* x4 = static_cast<const float4*>(x);
    const float4* w4 = static_cast<const float4*>(w);
    const long long w_rep4 = w_rep / 4;
#pragma unroll 2
    for (int c = t; c < n / 4; c += THREADS) {
      const float4 v = x4[c];
#pragma unroll
      for (int r = 0; r < MAX_REPS; ++r)
        if (r < reps) {
          const float4 u = w4[r * w_rep4 + c];
          sum[r] += expf(__fmul_rn(v.x, u.x));
          sum[r] += expf(__fmul_rn(v.y, u.y));
          sum[r] += expf(__fmul_rn(v.z, u.z));
          sum[r] += expf(__fmul_rn(v.w, u.w));
        }
    }
  } else {
    // Every chunk this thread reads starts at the same e % period, so each
    // rep's 8 weights stay in registers; the products of a chunk are the
    // A fragment of an m16n8k16 against ones, accumulated in f32 per rep.
    const uint4* x4 = static_cast<const uint4*>(x);
    const uint4* w4 = static_cast<const uint4*>(w);
    const int wc = t % (period / 8);
    uint4 wr[MAX_REPS];
    float d[MAX_REPS][4];
#pragma unroll
    for (int r = 0; r < MAX_REPS; ++r) {
      wr[r] = r < reps ? w4[r * (w_rep / 8) + wc] : make_uint4(0, 0, 0, 0);
      d[r][0] = d[r][1] = d[r][2] = d[r][3] = 0.f;
    }
    const uint32_t one2 = 0x3F803F80u;  // two bf16 1.0
    // Products of 16-byte chunk v against each rep's weights: the A
    // fragment of an m16n8k16 against ones, accumulated in f32 per rep.
    // Every rep slot runs (those past reps on zero weights, adding 0): a
    // branch on reps would put the warp-wide mma.sync under a condition the
    // compiler cannot prove uniform, and it then wraps each one in a
    // collective warp sync.
    auto chunk = [&](const uint4& v) {
#pragma unroll
      for (int r = 0; r < MAX_REPS; ++r) {
        uint32_t q0, q1, q2, q3;
        asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(q0) : "r"(v.x), "r"(wr[r].x));
        asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(q1) : "r"(v.y), "r"(wr[r].y));
        asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(q2) : "r"(v.z), "r"(wr[r].z));
        asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(q3) : "r"(v.w), "r"(wr[r].w));
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};"
            : "+f"(d[r][0]), "+f"(d[r][1]), "+f"(d[r][2]), "+f"(d[r][3])
            : "r"(q0), "r"(q1), "r"(q2), "r"(q3), "r"(one2), "r"(one2));
      }
    };
    // The loop's trip count is the block's, not the thread's, for the same
    // reason: chunks past the end load as zeros.
    const int nc = n / 8;
    for (int c0 = 0; c0 < nc; c0 += THREADS * ACC_LOADS) {
      uint4 v[ACC_LOADS];
#pragma unroll
      for (int u = 0; u < ACC_LOADS; ++u) {
        const int c = c0 + t + u * THREADS;
        v[u] = c < nc ? x4[c] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < ACC_LOADS; ++u) chunk(v[u]);
    }
#pragma unroll
    for (int r = 0; r < MAX_REPS; ++r)
      sum[r] = (d[r][0] + d[r][1]) + (d[r][2] + d[r][3]);
  }
  double total = 0.0;
#pragma unroll
  for (int r = 0; r < MAX_REPS; ++r) total += (double)sum[r];
  if constexpr (KIND == 1) total *= 0.125;  // each product counted 8 times
  block_sum_write<THREADS>(total, partial + blockIdx.x);
}

template <int N, int TA, int TB, int KSTEPS, int NHB, int SLABS, int SA,
          int SB>
int launch_gemm(const GemmArgs& args, double* partial, int g, int smem,
                cudaStream_t st) {
  auto kern = gemm_probe<N, TA, TB, KSTEPS, NHB, SLABS, SA, SB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<g, GEMM_THREADS, smem, st>>>(args, partial);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// The [total][ld] bf16 operand at ptr as a 2D tensor map with boxes of
// sw / 2 columns (sw bytes, the swizzle atom) by rows.
bool make_map(CUtensorMap* map, const void* ptr, long long total, long long ld,
              long long rows, int sw) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)total};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {(cuuint32_t)sw / 2, (cuuint32_t)rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Length of the plan dvgo_probe_gemm takes (the fields of Plan, in order).
int dvgo_probe_plan_len() { return PLAN_LEN; }

// a, b: bf16 operands (16-byte aligned); plan: PLAN_LEN values
// (ops/probe_ops.py's gemm_plan); partial [g] f64.
int dvgo_probe_gemm(const void* a, const void* b, double* partial,
                    const long long* plan, int n_plan, int g, void* stream) {
  if (n_plan != PLAN_LEN || g < 1) return (int)cudaErrorInvalidValue;
  GemmArgs args{};
  long long* f = reinterpret_cast<long long*>(&args.p);
  for (int i = 0; i < PLAN_LEN; ++i) f[i] = plan[i];
  const Plan& p = args.p;
  const long long a_bytes = p.a_rows * p.a_cols * 2;
  const long long b_bytes = p.b_rows * p.b_cols * 2;
  const long long smem =
      (p.a_streamed ? p.h_slots * p.n_h * b_bytes + p.stages * a_bytes
                    : p.h_slots * p.n_h * a_bytes + p.stages * b_bytes) +
      1024;
  if (p.n_o < 1 || p.n_j < 1 || p.n_h < 1 || p.h_slots < 1 ||
      p.h_slots > MAX_HELD || p.stages < 2 || p.stages > MAX_STAGES ||
      p.s_jdiv < 1 || p.k % 16 || p.k < 16 || p.mt % 128 ||
      p.a_cols % 32 || p.b_cols % 32 || p.a_rows % 8 || p.b_rows % 8 ||
      p.lda % 8 || p.ldb % 8 ||
      (p.a_mn ? (p.a_rows != p.k || p.a_cols != p.mt)
              : (p.a_rows != p.mt || p.a_cols != p.k)) ||
      (p.b_mn ? (p.b_rows != p.k || p.b_cols != p.n)
              : (p.b_rows != p.n || p.b_cols != p.k)) ||
      (!p.a_streamed && p.n_h != 1) || (p.n_o > 1 && p.h_slots < 2) ||
      p.a_rows > 256 || p.b_rows > 256 || smem > SMEM_LIMIT ||
      (p.a_sw != 64 && p.a_sw != 128) || (p.b_sw != 64 && p.b_sw != 128) ||
      p.a_cols % (p.a_sw / 2) || p.b_cols % (p.b_sw / 2))
    return (int)cudaErrorInvalidValue;
  const int sa = (int)p.a_sw, sb = (int)p.b_sw;
  if (!make_map(&args.ta, a, p.a_total, p.lda, p.a_rows, sa) ||
      !make_map(&args.tb, b, p.b_total, p.ldb, p.b_rows, sb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = (int)smem;
  const long long ks = p.k / 16, nhb = p.a_streamed ? p.n_h : 1,
                  slabs = p.mt / 128;
  // One instance per step shape and swizzle pair: r3dot / r3f; lead; mm,
  // mmT, b12; small; b8geo.
  const bool a128 = sa == 128, b128 = sb == 128;
  if (p.n == 128 && !p.a_mn && p.b_mn && ks == 8 && nhb == 4 && slabs == 1 &&
      a128 && b128)
    return launch_gemm<128, 0, 1, 8, 4, 1, 128, 128>(args, partial, g, s, st);
  if (p.n == 128 && p.a_mn && p.b_mn && ks == 1 && nhb == 4 && slabs == 8 &&
      a128 && b128)
    return launch_gemm<128, 1, 1, 1, 4, 8, 128, 128>(args, partial, g, s, st);
  if (p.n == 128 && !p.a_mn && p.b_mn && ks == 10 && nhb == 1 &&
      slabs == 1 && !a128 && b128)
    return launch_gemm<128, 0, 1, 10, 1, 1, 64, 128>(args, partial, g, s, st);
  if (p.n == 128 && !p.a_mn && !p.b_mn && ks == 10 && nhb == 1 &&
      slabs == 1 && !a128 && !b128)
    return launch_gemm<128, 0, 0, 10, 1, 1, 64, 64>(args, partial, g, s, st);
  if (p.n == 64 && !p.a_mn && p.b_mn && ks == 10 && nhb == 1 && slabs == 1 &&
      !a128 && b128)
    return launch_gemm<64, 0, 1, 10, 1, 1, 64, 128>(args, partial, g, s, st);
  return (int)cudaErrorInvalidValue;
}

// kind as elem_probe's KIND; x [n], w [reps][w_rep] (kind 1: period the
// length of its broadcast weight row); x and w 16-byte aligned; partial [g]
// f64.
int dvgo_probe_elem(int kind, const void* x, const void* w, double* partial,
                    int n, long long w_rep, int period, int g, int reps,
                    void* stream) {
  const int chunk = kind == 1 ? 8 : 4;
  if (n < 1 || n % chunk || w_rep % chunk || g < 1 || reps < 1 ||
      reps > MAX_REPS || period < 1 || (period & (period - 1)) ||
      (kind == 1 && (period % 8 || (8 * THREADS) % period)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      elem_probe<0><<<g, THREADS, 0, st>>>(x, w, n, w_rep, period, reps,
                                           partial);
      break;
    case 1:
      elem_probe<1><<<g, THREADS, 0, st>>>(x, w, n, w_rep, period, reps,
                                           partial);
      break;
    case 2:
      elem_probe<2><<<g, THREADS, 0, st>>>(x, w, n, w_rep, period, reps,
                                           partial);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
