// Per-op cost probe of the fused frame kernels' op classes (kernel K-G).
//
// Replaces: tools/probe_mosaic.py's pallas_call (build(), the probe of
// Mosaic op costs at the frame kernels' shapes). One launch runs G blocks;
// each block runs R reps of one op body, rep i reading its own weight
// slice (so no two reps can be merged or hoisted), and reduces every
// element of every rep's output into the block's digest: f32 sums per
// rep, folded in f64 and written to partial[block]. The digest of the
// launch is the sum of the G partials. Per-op cost, as in the TPU probe:
// (t(G) - t_null(G)) / (G * R). On the card the G blocks run side by side
// on 132 SMs, so that figure is the op's cost at full occupancy, not one
// op's latency.
//
// Op bodies:
//   matmul classes (b12, b8geo, lead, mm, mmT, small, r3dot, r3f): bf16
//     operands on wmma m16n16k16 fragments with f32 accumulation, each
//     warp one 16x16 output tile at a time, operands loaded straight from
//     device memory (the L2 cache holds every operand) in either layout;
//   elementwise classes: f32 x * 1.0001 (null), bf16(x * w) (acc, the
//     product rounded to bf16 as a bf16 multiply rounds it) and
//     f32 exp(x * w) (vpu2d, vpu3d8) on the f32 units.
// Bound on the H100: the matmul classes by the bf16 tensor rate (989
// TFLOP/s; each launch's operands are a few MB, read once), the
// elementwise ones by the f32 rate. The design is the simplest correct
// one: no shared-memory staging, no TMA, no wgmma; making it fast is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;

// Sum of v over the block; thread 0 writes it to *out.
__device__ void block_sum_write(double v, double* out) {
  __shared__ double warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) s += warp_sums[i];
    *out = s;
  }
}

// C[bi] = A[bi] @ B[bi] for bi < batch, every rep r at its own offsets.
// A is [m][k] row-major (lda >= k) or stored [k][m] (column-major, lda >=
// m); B is [k][n] row-major (ldb >= n) or stored [n][k] (column-major).
struct Gemm {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  long long a_bat, a_rep, b_bat, b_rep;
  int batch, m, n, k, lda, ldb;
};

template <class LA, class LB>
__global__ void __launch_bounds__(THREADS)
gemm_probe(Gemm p, int reps, double* partial) {
  constexpr bool a_row = std::is_same<LA, wmma::row_major>::value;
  constexpr bool b_row = std::is_same<LB, wmma::row_major>::value;
  const int warp = threadIdx.x >> 5;
  const int mt = p.m / 16, nt = p.n / 16;
  const int tiles = p.batch * mt * nt;
  double total = 0.0;
  for (int r = 0; r < reps; ++r) {
    float sum = 0.f;
    for (int t = warp; t < tiles; t += THREADS / 32) {
      const int bi = t / (mt * nt), rem = t - bi * mt * nt;
      const int i0 = rem / nt * 16, j0 = rem % nt * 16;
      const __nv_bfloat16* A = p.a + r * p.a_rep + bi * p.a_bat;
      const __nv_bfloat16* B = p.b + r * p.b_rep + bi * p.b_bat;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < p.k; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
        wmma::load_matrix_sync(
            fa, A + (a_row ? (size_t)i0 * p.lda + k0 : (size_t)k0 * p.lda + i0),
            p.lda);
        wmma::load_matrix_sync(
            fb, B + (b_row ? (size_t)k0 * p.ldb + j0 : (size_t)j0 * p.ldb + k0),
            p.ldb);
        wmma::mma_sync(c, fa, fb, c);
      }
#pragma unroll
      for (int e = 0; e < c.num_elements; ++e) sum += c.x[e];
    }
    total += sum;
  }
  block_sum_write(total, partial + blockIdx.x);
}

// KIND 0: f32 x[e] * 1.0001 (no w); 1: bf16(x[e] * w[r][e % period]) with
// bf16 x and w (period a power of two); 2: f32 exp(x[e] * w[r][e]).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
elem_probe(const void* x, const void* w, int n, long long w_rep, int period,
           int reps, double* partial) {
  double total = 0.0;
  for (int r = 0; r < reps; ++r) {
    float sum = 0.f;
    for (int e = threadIdx.x; e < n; e += THREADS) {
      if constexpr (KIND == 0) {
        sum += __fmul_rn(static_cast<const float*>(x)[e], 1.0001f);
      } else if constexpr (KIND == 1) {
        const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
        const __nv_bfloat16* wb =
            static_cast<const __nv_bfloat16*>(w) + r * w_rep;
        sum += __bfloat162float(__float2bfloat16_rn(
            __bfloat162float(xb[e]) * __bfloat162float(wb[e & (period - 1)])));
      } else {
        const float* wf = static_cast<const float*>(w) + r * w_rep;
        sum += expf(__fmul_rn(static_cast<const float*>(x)[e], wf[e]));
      }
    }
    total += sum;
  }
  block_sum_write(total, partial + blockIdx.x);
}

}  // namespace

extern "C" {

const char* dvgo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b: bf16 operands (32-byte aligned); partial [g] f64. m, n, k
// multiples of 16, lda and ldb of 8; a_col/b_col select the column-major
// layouts ([k][m] for A, [n][k] for B); both column-major is not taken.
int dvgo_probe_gemm(const void* a, const void* b, double* partial, int batch,
                    int m, int n, int k, long long a_bat, long long a_rep,
                    int lda, int a_col, long long b_bat, long long b_rep,
                    int ldb, int b_col, int g, int reps, void* stream) {
  if (m % 16 || n % 16 || k % 16 || lda % 8 || ldb % 8 || batch < 1 ||
      m < 16 || n < 16 || k < 16 || g < 1 || reps < 1 || (a_col && b_col))
    return (int)cudaErrorInvalidValue;
  Gemm p{static_cast<const __nv_bfloat16*>(a),
         static_cast<const __nv_bfloat16*>(b), a_bat, a_rep, b_bat, b_rep,
         batch, m, n, k, lda, ldb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_col)
    gemm_probe<wmma::col_major, wmma::row_major>
        <<<g, THREADS, 0, st>>>(p, reps, partial);
  else if (b_col)
    gemm_probe<wmma::row_major, wmma::col_major>
        <<<g, THREADS, 0, st>>>(p, reps, partial);
  else
    gemm_probe<wmma::row_major, wmma::row_major>
        <<<g, THREADS, 0, st>>>(p, reps, partial);
  return (int)cudaGetLastError();
}

// kind as elem_probe's KIND; x [n], w [reps][w_rep] (kind 1: period the
// length of its broadcast weight row); partial [g] f64.
int dvgo_probe_elem(int kind, const void* x, const void* w, double* partial,
                    int n, long long w_rep, int period, int g, int reps,
                    void* stream) {
  if (n < 1 || g < 1 || reps < 1 || period < 1 || (period & (period - 1)))
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
