// Windowed median along one axis, written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package takes these medians with jnp.sort
// (stratum_dsp_tpu/ops/masked.py and the chroma and HPSS modules), which XLA
// owns; the port's plain version sorts every unfolded window with
// torch.sort. Under the HPSS configs that sort was most of a batch: ten
// iterations of two 21-wide medians over a [16, 15500, 1025] spectrogram are
// 107 G window elements sorted a batch. This kernel selects instead of
// sorting.
//
// What it computes, for x viewed as [outer, n, inner] with the filtered axis
// in the middle, at every position i < n_valid[o] of row o: the values of
// the window [i - half, i + half] clipped to [0, n_valid[o]), sorted; cnt of
// them; the element cnt / 2 or, with average_even, 0.5f * (s[cnt/2] +
// s[m2]) with m2 = cnt/2 - 1 for an even count and cnt/2 for an odd one, as
// the plain version rounds it. Entries at i >= n_valid[o] are copied. Every
// output is a selection from the input or that one f32 mean of two, so the
// result is bit-equal to the sort (ties and zeros included; -0.0 and +0.0
// compare equal, so either may stand for the other). NaNs are not ordered.
//
// What bounds it on this card: the count says bytes. A call reads x once and
// writes the output once, 8 B a cell: 2.03 GB at [16, 15500, 1025], 0.61 ms
// at 3.35 TB/s (ops/masked.py:window_median_bound_ms, which also states the
// least operations: a binary-search insert and delete a cell). In fact the
// compare network below is about 4W compare, select, min and max
// instructions a cell (84 at W = 21), 25 G a call with the warm-ups, on a
// pipe that issues half the f32 rate: instruction issue bounds it, at
// 2.2-2.6 ms a call, 23-28% of the byte bound (against 283 ms for the sort).
//
// What the design does about it:
// * Each lane keeps its window sorted in W registers (W a template
//   parameter, every loop unrolled) and slides it one position a step:
//   the outgoing value is removed and the incoming one inserted with no
//   branch (W compare-selects, then W min / max pairs). In the interior the
//   median is register H; near an edge it is picked by W selects.
// * The work unit is a warp and a tile: 32 lanes by a segment of at most
//   kSegment positions and its 2 * half halo, staged in shared memory with
//   coalesced loads whatever the layout. With inner > 1 (a time-axis pass
//   over [B, F, K]) the lanes are 32 neighbouring columns of one row and
//   each load is a row of the tile; with inner == 1 (a pass along a
//   contiguous axis) the lanes are 32 rows and each load is a run of one
//   row. The tile's rows are 33 words apart, so neither the loads nor the
//   lanes' walks meet a bank conflict. Both layouts run as they lie in
//   memory: no transpose, no copy.
// * The tile doubles as the lane's ring of values and as its output: the
//   value that leaves the window at a step is read back from the tile, and
//   the step's output is written over it, so output i lands at tile row
//   i - p0 and the store is as coalesced as the load.
// * Segments along the filtered axis give the card enough warps (a
//   time-axis pass has only outer x inner = 16.4 k columns); each costs a
//   warm-up of 2 * half insertions, 17% at half 10 and kSegment 120. At
//   half 10 a block's four tiles take 74 KB, so three blocks (12 warps)
//   share an SM: measured at [16, 15500, 1025], 120 beat 128 (two blocks)
//   by 12% on the time axis, and 96, 64 or 256, and 1, 2, 3 or 8 warps a
//   block, were no faster.
// * A half above kMaxRegisterHalf takes a general path: one thread an
//   output, the rank of each window value counted against the others
//   (stable on ties), O(W^2) reads that L1 mostly serves.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <array>
#include <utility>

namespace {

constexpr int kWarps = 4;              // warps a block, each its own tile
constexpr int kThreads = 32 * kWarps;
constexpr int kSegment = 120;          // most outputs a warp computes along the axis
constexpr int kStride = 33;            // words between tile rows: 32 lanes + 1
constexpr int kMaxRegisterHalf = 32;   // wider windows take the general path
constexpr int kGeneralThreads = 256;
constexpr float kInf = __builtin_huge_valf();

struct Shape {
  int outer, n, inner;
  int seg;          // outputs a warp computes along the axis
  int segments;     // ceil(n / seg)
  int col_groups;   // ceil(inner / 32) with inner > 1
  long long tasks;  // warps: lane groups x segments
};

// Remove `old` (present in s) from the sorted window and insert v, no branch:
// t[k] = s[k] < old ? s[k] : s[k + 1] is the window without old (its first
// copy), and max(t[k - 1], min(t[k], v)) the k-th value with v inserted.
template <int W>
__device__ __forceinline__ void slide(float (&s)[W], float old, float v) {
  float prev = -kInf;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float next = k + 1 < W ? s[k + 1] : kInf;
    const float t = s[k] < old ? s[k] : next;
    s[k] = fmaxf(prev, fminf(t, v));
    prev = t;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// s[m] for an index known only at run time, without local memory
template <int W>
__device__ __forceinline__ float pick(const float (&s)[W], int m) {
  float r = s[0];
#pragma unroll
  for (int k = 1; k < W; ++k) r = k == m ? s[k] : r;
  return r;
}

template <int H>
__global__ void __launch_bounds__(kThreads) window_median_kernel(
    const float* __restrict__ x, const int* __restrict__ n_valid, float* __restrict__ out,
    Shape sh, int average_even) {
  constexpr int W = 2 * H + 1;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long task = (long long)blockIdx.x * kWarps + warp;
  if (task >= sh.tasks) return;
  const long long group = task / sh.segments;
  const int p0 = (int)(task % sh.segments) * sh.seg;
  const int len = min(sh.seg, sh.n - p0);
  const int rows = len + 2 * H + 1;   // a pad row of +inf, then positions p0 - H .. p0 + len + H - 1
  float* tile = smem + (size_t)warp * (sh.seg + 2 * H + 1) * kStride;
  const bool columns = sh.inner > 1;

  // this lane's row o, column c (columns layout), and valid count
  long long o;
  int c = 0, nv = 0;
  if (columns) {
    o = group / sh.col_groups;
    c = (int)(group % sh.col_groups) * 32 + lane;
    if (c < sh.inner) nv = n_valid ? n_valid[o] : sh.n;
  } else {
    o = group * 32 + lane;
    if (o < sh.outer) nv = n_valid ? n_valid[o] : sh.n;
  }
  nv = max(0, min(nv, sh.n));

  // stage: tile row t holds position p0 - H - 1 + t (+inf outside [0, n)),
  // every copy in flight at once
  if (columns) {
    const bool active = c < sh.inner;
    const float* src = x + o * sh.n * sh.inner + c;
    for (int t = 0; t < rows; ++t) {
      const int j = p0 - H - 1 + t;
      float* dst = tile + t * kStride + lane;
      if (t > 0 && active && j >= 0 && j < sh.n) {
        cp_async4(dst, src + (long long)j * sh.inner);
      } else {
        *dst = kInf;
      }
    }
  } else {
    for (int r = 0; r < 32; ++r) {
      const long long orow = group * 32 + r;
      const float* src = x + orow * sh.n;
      for (int t = lane; t < rows; t += 32) {
        const int j = p0 - H - 1 + t;
        float* dst = tile + t * kStride + r;
        if (t > 0 && orow < sh.outer && j >= 0 && j < sh.n) {
          cp_async4(dst, src + j);
        } else {
          *dst = kInf;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // walk: a step inserts position j = p0 - H + step (tile row step + 1);
  // from step 2H on it removes the value of tile row r0 = step - 2H and
  // writes the output of position p0 + r0 there
  float s[W];
#pragma unroll
  for (int k = 0; k < W; ++k) s[k] = kInf;
  float* col = tile + lane;
  const int steps = len + 2 * H;
  // the next step's two values are read before this step writes its output
  // (rows step + 2 and r0 + 1 are not the row it writes), so the shared
  // loads overlap the compare network
  float v = p0 - H < nv ? col[kStride] : kInf;
  float old = kInf;
  for (int step = 0; step < steps; ++step) {
    const int j = p0 - H + step;
    const int r0 = step - 2 * H;
    const float v_next = step + 1 < steps && j + 1 < nv ? col[(step + 2) * kStride] : kInf;
    const float old_next = r0 + 1 >= 0 && j + 1 - W < nv ? col[(r0 + 1) * kStride] : kInf;
    slide<W>(s, old, v);
    if (r0 >= 0) {
      const int q = p0 + r0;
      float res;
      if (q < nv) {
        const int cnt = min(q + H, nv - 1) - max(q - H, 0) + 1;
        float a, b;
        if (cnt == W) {
          a = b = s[H];
        } else {
          a = pick<W>(s, cnt >> 1);
          b = average_even && !(cnt & 1) ? pick<W>(s, (cnt >> 1) - 1) : a;
        }
        res = average_even ? __fmul_rn(0.5f, __fadd_rn(a, b)) : a;
      } else {
        res = col[(r0 + H + 1) * kStride];   // x at q as it came
      }
      col[r0 * kStride] = res;
    }
    v = v_next;
    old = old_next;
  }
  __syncwarp();

  // store tile rows [0, len): outputs p0 .. p0 + len - 1
  if (columns) {
    if (c < sh.inner) {
      float* dst = out + o * sh.n * sh.inner + c;
      for (int t = 0; t < len; ++t) dst[(long long)(p0 + t) * sh.inner] = tile[t * kStride + lane];
    }
  } else {
    for (int r = 0; r < 32; ++r) {
      const long long orow = group * 32 + r;
      if (orow >= sh.outer) break;
      float* dst = out + orow * sh.n + p0;
      for (int t = lane; t < len; t += 32) dst[t] = tile[t * kStride + r];
    }
  }
}

// One thread an output: the valid window's values ranked against each other
// (ties by position, as a stable sort orders them), for any half.
__global__ void __launch_bounds__(kGeneralThreads) window_median_general(
    const float* __restrict__ x, const int* __restrict__ n_valid, float* __restrict__ out,
    int outer, int n, int inner, int half, int average_even) {
  const long long idx = (long long)blockIdx.x * kGeneralThreads + threadIdx.x;
  if (idx >= (long long)outer * n * inner) return;
  const int i = (int)(idx % inner);
  const int q = (int)((idx / inner) % n);
  const long long o = idx / ((long long)n * inner);
  const int nv = max(0, min(n_valid ? n_valid[o] : n, n));
  if (q >= nv) {
    out[idx] = x[idx];
    return;
  }
  const float* col = x + o * n * inner + i;
  const int lo = max(q - half, 0), hi = min(q + half, nv - 1);
  const int cnt = hi - lo + 1;
  const int m = cnt >> 1;
  const int m2 = average_even && !(cnt & 1) ? m - 1 : m;
  float a = 0.f, b = 0.f;
  for (int k = lo; k <= hi; ++k) {
    const float vk = col[(long long)k * inner];
    int rank = 0;
    for (int l = lo; l <= hi; ++l) {
      const float vl = col[(long long)l * inner];
      rank += vl < vk || (vl == vk && l < k);
    }
    if (rank == m) a = vk;
    if (rank == m2) b = vk;
  }
  out[idx] = average_even ? __fmul_rn(0.5f, __fadd_rn(a, b)) : a;
}

using Launcher = int (*)(const float*, const int*, float*, const Shape&, int, cudaStream_t);

template <int H>
int launch(const float* x, const int* n_valid, float* out, const Shape& sh, int average_even,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * (size_t)(sh.seg + 2 * H + 1) * kStride;
  cudaError_t err = cudaFuncSetAttribute(window_median_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (sh.tasks + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  window_median_kernel<H><<<(unsigned)blocks, kThreads, smem, stream>>>(x, n_valid, out, sh,
                                                                        average_even);
  return (int)cudaGetLastError();
}

template <int... Hs>
constexpr std::array<Launcher, sizeof...(Hs)> launchers(std::integer_sequence<int, Hs...>) {
  return {&launch<Hs>...};
}

constexpr auto kLaunchers = launchers(std::make_integer_sequence<int, kMaxRegisterHalf + 1>{});

}  // namespace

// x and out [outer, n, inner] f32 contiguous; n_valid [outer] int32 or null
// (every row valid to n). Launches on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int stratum_window_median(const void* x, const void* n_valid, void* out, int outer,
                                     int n, int inner, int half, int average_even,
                                     void* stream) {
  if (outer <= 0 || n <= 0 || inner <= 0 || half < 0 || x == nullptr || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xf = (const float*)x;
  const int* nv = (const int*)n_valid;
  float* of = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (half > kMaxRegisterHalf) {
    const long long blocks = ((long long)outer * n * inner + kGeneralThreads - 1) / kGeneralThreads;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    window_median_general<<<(unsigned)blocks, kGeneralThreads, 0, s>>>(xf, nv, of, outer, n,
                                                                        inner, half, average_even);
    return (int)cudaGetLastError();
  }
  Shape sh;
  sh.outer = outer;
  sh.n = n;
  sh.inner = inner;
  sh.segments = (n + kSegment - 1) / kSegment;
  sh.seg = (n + sh.segments - 1) / sh.segments;
  sh.col_groups = (inner + 31) / 32;
  const long long groups = inner > 1 ? (long long)outer * sh.col_groups : (outer + 31LL) / 32;
  sh.tasks = groups * sh.segments;
  return kLaunchers[half](xf, nv, of, sh, average_even, s);
}
