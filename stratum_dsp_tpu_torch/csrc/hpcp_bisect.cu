// HPCP of a frame by the bisection peak pick and the harmonic sum, written by
// hand for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes the approximate top-K HPCP
// (stratum_dsp_tpu/features/chroma/extractor.py frames_to_hpcp) as XLA ops,
// which XLA fuses; the port's plain version (ops/hpcp.py:hpcp_bisect_plain)
// dispatches the same ops one by one: a 20-step bisection of 8 launches a
// step, ~35 more for the peak test, the weights, the product with the
// harmonic matrix and the L2 normalisation, ~196 launches a key STFT chunk,
// on a host that sets the pace of the whole pipeline. This kernel is all of
// it in one launch.
//
// What it computes, for each row (a frame of n bins, sel and raw rows of
// their own row strides, f32 or bf16 each):
//  1. peaks: bin k in the band [k_lo, k_hi) with sel[k] > sel[k - 1] and
//     sel[k] >= sel[k + 1], the row's edge bins repeated as neighbours;
//  2. the plain version's bisection for the K-th largest peak value, step
//     for step: hi = max(0, peaks), lo = 0, 20 times mid = 0.5 (lo + hi)
//     rounded to sel's type after each operation, and hi = mid where fewer
//     than k_top peaks are >= mid, else lo = mid. Every step compares the
//     same values against the same mids and counts exactly, so the peaks
//     kept (those >= lo) are the plain version's, ties included;
//  3. each kept bin's weight sqrt(max(raw, 0)) (powf with power where
//     use_sqrt is 0), rounded to raw's type, times its row of the [n, 12]
//     harmonic matrix (row / rows_per_mat picks the matrix, mat_stride
//     floats apart; 0 for one matrix), summed in f32;
//  4. l2_normalize_zero: the 12 sums over their L2 norm, or 0 where the norm
//     is at most 1e-10.
// Only the order of the sums in 3 and 4 differs from the plain version's
// (a product with cuBLAS): each lane sums its own kept bins in bin order,
// then the lanes' sums meet in a butterfly.
//
// What bounds it on this card: bytes. A default key chunk is 7320 rows of
// 931 f32 bins, 27.3 MB read once, ~8 us at 3.35 TB/s; the operations (two
// compares a bin for the peak test, one a bin and step for the bisection)
// take ~2 us at 67 TFLOP/s (ops/hpcp.py:hpcp_bisect_bound_ms).
//
// What the design does about it:
// * One warp a row. Each lane loads the bins lane, lane + 32, ... once
//   (coalesced; the neighbours' loads hit the same lines in L1), tests them
//   for peaks and keeps a peak's value, or -inf, in V registers (V a
//   template parameter: 2, 8, 32 or 64 values a lane, the least that holds
//   the row; bins past 32 * 64 are tested again from memory at each step).
// * A bisection step is V compares a lane and one warp-wide integer sum
//   (__reduce_add_sync): the row is read from device memory once, not 20
//   times, and the host launches nothing per step.
// * The harmonic matrix ([n, 12] f32, 45 KB) stays in L1 and L2: a lane
//   reads the rows of its kept bins only, some 24 of a frame's 931.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rows a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 20;  // the plain version's bisection steps
constexpr int kClasses = 12;
constexpr float kNormFloor = 1e-10f;  // l2_normalize_zero's
constexpr unsigned kAll = 0xffffffffu;
constexpr float kInf = __builtin_huge_valf();

struct Args {
  const void* sel;
  long long sel_stride;
  const void* raw;
  long long raw_stride;
  const float* matrix;
  long long mat_stride;
  int rows_per_mat;
  float* out;
  int rows, n, k_lo, k_hi, k_top;
  float power;
  int use_sqrt;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// a result of PyTorch's elementwise ops in the type T: computed in f32, then
// rounded to T
template <typename T>
__device__ __forceinline__ float in_type(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// sel[k] where bin k is a peak in the band, else -inf
template <typename S>
__device__ __forceinline__ float peak_value(const S* sel, int k, const Args& a) {
  const float s = load(sel + k);
  const float prev = load(sel + (k > 0 ? k - 1 : 0));
  const float next = load(sel + (k + 1 < a.n ? k + 1 : k));
  return k >= a.k_lo && k < a.k_hi && s > prev && s >= next ? s : -kInf;
}

template <int V, typename S, typename R>
__global__ void __launch_bounds__(kThreads) hpcp_bisect_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // a whole warp leaves together
  const S* sel = (const S*)a.sel + row * a.sel_stride;
  const int tail = 32 * V;  // bins from here on are read again at each step

  float val[V];
  float hi = 0.0f;  // amax of where(peak, sel, 0)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int k = lane + 32 * j;
    val[j] = k < a.n ? peak_value(sel, k, a) : -kInf;
    hi = fmaxf(hi, val[j]);
  }
  for (int k = tail + lane; k < a.n; k += 32) hi = fmaxf(hi, peak_value(sel, k, a));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) hi = fmaxf(hi, __shfl_xor_sync(kAll, hi, off));

  // the plain version's steps, in sel's type; -inf (no peak) is never >= mid
  // since mid >= 0
  float lo = 0.0f;
  for (int step = 0; step < kSteps; ++step) {
    const float mid = in_type<S>(__fmul_rn(0.5f, in_type<S>(__fadd_rn(lo, hi))));
    int count = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) count += val[j] >= mid;
    for (int k = tail + lane; k < a.n; k += 32) count += peak_value(sel, k, a) >= mid;
    count = __reduce_add_sync(kAll, count);
    if (count < a.k_top) {
      hi = mid;
    } else {
      lo = mid;
    }
  }

  // the kept peaks' weights times their rows of the harmonic matrix
  const R* raw = (const R*)a.raw + row * a.raw_stride;
  const float* mat = a.matrix + (row / a.rows_per_mat) * a.mat_stride;
  float acc[kClasses];
#pragma unroll
  for (int c = 0; c < kClasses; ++c) acc[c] = 0.0f;
  auto add = [&](int k) {
    const float r = load(raw + k);
    const float x = r < 0.0f ? 0.0f : r;  // clamp_min(0), NaN kept
    const float w = in_type<R>(a.use_sqrt ? __fsqrt_rn(x) : powf(x, a.power));
    const float* m = mat + (long long)k * kClasses;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) acc[c] = fmaf(w, __ldg(m + c), acc[c]);
  };
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (val[j] >= lo) add(lane + 32 * j);
  }
  for (int k = tail + lane; k < a.n; k += 32) {
    if (peak_value(sel, k, a) >= lo) add(k);
  }
  // a butterfly: every lane ends with the same sums (an IEEE add commutes)
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_xor_sync(kAll, acc[c], off);
  }
  float sq = 0.0f, mine = 0.0f;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    sq = fmaf(acc[c], acc[c], sq);
    mine = c == lane ? acc[c] : mine;
  }
  const float norm = __fsqrt_rn(sq);
  if (lane < kClasses) {
    a.out[row * kClasses + lane] = norm > kNormFloor ? __fdiv_rn(mine, fmaxf(norm, kNormFloor))
                                                     : 0.0f;
  }
}

template <typename S, typename R>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.rows + kWarps - 1) / kWarps);
  if (a.n <= 32 * 2) {
    hpcp_bisect_kernel<2, S, R><<<blocks, kThreads, 0, stream>>>(a);
  } else if (a.n <= 32 * 8) {
    hpcp_bisect_kernel<8, S, R><<<blocks, kThreads, 0, stream>>>(a);
  } else if (a.n <= 32 * 32) {
    hpcp_bisect_kernel<32, S, R><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    hpcp_bisect_kernel<64, S, R><<<blocks, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sel and raw: rows of n bins (element strides sel_stride, raw_stride), f32,
// or bf16 where *_bf16 is 1; matrix: f32 [n, 12] rows, one matrix for every
// rows_per_mat rows, mat_stride floats apart; out: f32 [rows, 12].
extern "C" int stratum_hpcp_bisect(const void* sel, long long sel_stride, int sel_bf16,
                                   const void* raw, long long raw_stride, int raw_bf16,
                                   const void* matrix, long long mat_stride, int rows_per_mat,
                                   void* out, int rows, int n, int k_lo, int k_hi, int k_top,
                                   float power, int use_sqrt, void* stream) {
  if (rows <= 0 || n <= 0 || rows_per_mat <= 0 || k_top <= 0 || sel == nullptr ||
      raw == nullptr || matrix == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{sel, sel_stride, raw, raw_stride, (const float*)matrix, mat_stride,
               rows_per_mat, (float*)out, rows, n, k_lo, k_hi, k_top, power, use_sqrt};
  const cudaStream_t s = (cudaStream_t)stream;
  if (sel_bf16) {
    return raw_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, s)
                    : launch<__nv_bfloat16, float>(a, s);
  }
  return raw_bf16 ? launch<float, __nv_bfloat16>(a, s) : launch<float, float>(a, s);
}
