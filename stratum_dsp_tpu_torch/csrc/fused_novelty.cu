// Fused BPM novelty reducer over one STFT chunk, written by hand for Hopper
// (sm_90a).
//
// Replaces: stratum_dsp_tpu/ops/novelty_pallas.py:fused_novelty_features
// (Pallas body _make_kernel), the TPU form of the streamed reducer in
// features/period/novelty.py:make_bpm_reducer.
//
// What it computes, per track and frame f of the chunk spec [B, C, K] (the
// two frames before the chunk come from prev2 [B, 2, K]):
//   log1p of the magnitudes;
//   SuperFlux sqrt(sum max(0, log[f] - maxfilt(log[f-s]))^2) per band, at
//     stride s = 1 and s = 2, the +-sf_k frequency max filter clamped at the
//     edges of the band it is summed over;
//   band energy sum x^2 and HFC sum k*x^2 per band;
//   log-mel: the dot of log[f] with each mel filter over its nonzero range;
//   onset flux sqrt(sum max(0, x[f]/max_k x[f] - x[f-1]/max_k x[f-1])^2).
// The output is the TPU kernel's packed [B, C, 128] f32 layout: cols [0, nb)
// stride-1 SuperFlux, [nb, 2nb) stride-2, [2nb, 4nb) (energy, hfc) per band,
// [4nb, 4nb+nm) mel, 4nb+nm onset flux, every other column 0. Band 0 is the
// full band [0, K); bands 1.. are disjoint sub-bands.
//
// What bounds it on this card: bytes, by the count; instructions, in fact.
// One chunk of the main path reads 40 x 256 x 1025 x 4 B ~ 42 MB and writes
// ~5 MB: 14.2 us at 3.35 TB/s. Counted at the least the function needs (one
// max filter per row, every elementary function one operation) it is ~34 f32
// operations per bin and frame, 5.2 us at the SIMT units' 67 TFLOP/s
// (ops/novelty.py:bound_ms). The instruction stream is several times that
// count: the IEEE log1pf alone is ~25 instructions and each IEEE division of
// the onset flux ~10, so the kernel ends up limited by instruction throughput, a
// few times above its byte bound. Tensor cores are no tool here: the sums
// are held to 1e-5 of their largest value, which TF32's 10-bit mantissa does
// not give, and the max filters and log1p are not products. Built without
// --use_fast_math: log1pf, sqrtf and the division stay IEEE.
//
// What the design does about it:
// * One block per (track, tile of frames); the unit of work inside it is a
//   warp and a row. There is no block barrier per frame: two per tile.
// * Phase 1, a warp per row of the tile and of its two halo rows: the warp
//   starts the asynchronous copy (cp.async) of every row it owns into the
//   row's slot of shared memory before it touches the first, so a whole tile
//   is in flight at once. A row is 4 K + 4 bytes, so only every fourth row
//   of [B, C, 1025] is 16-byte aligned in device memory: those are copied 16
//   bytes a lane, the others 4 bytes a lane. Every slot is 16-byte aligned
//   with four zeros before and after the row, so that everything after the
//   copy works on groups of four bins with 16-byte shared-memory accesses,
//   and the max filter needs no clamping (log1p >= 0, so a zero changes no
//   maximum). When a row has landed the warp replaces it in place by its
//   log1p and takes, on the way, the row maximum and the band energies and
//   HFCs; a word of four band bytes says which sub-band each bin of a group
//   adds to, and almost every group lies in one band. The mel dots follow,
//   a lane per filter (a long filter cut in pieces), weights packed by
//   range in shared memory.
// * Phase 2, a warp per frame: with sf_k = 4 the 9-wide maxima of four
//   neighbouring bins come from the 12 values of three 16-byte loads in 15
//   max operations (a generic radius walks its window). The filter is
//   computed once, for the full band; the few bins within sf_k of a
//   sub-band's edge, whose own window is clamped to the band, then trade
//   the full band's term for their own. The onset flux reads the raw rows f
//   and f-1 again from L2 (the base variant only) rather than keeping a
//   second copy of the tile in shared memory, which would halve the blocks
//   per SM.
// * Every sum is a per-lane partial, then a warp reduction that folds eight
//   sums into one butterfly (9 shuffles for 8 sums): a fixed order, no
//   atomics, deterministic.
// * A frame's 128 output columns are assembled in shared memory and leave
//   as one 512-byte store per warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// limits, mirrored by ops/novelty.py (KERNEL_MAX_*)
constexpr int kMaxBins = 2048;
constexpr int kMaxBands = 4;
constexpr int kMaxMels = 128;
constexpr int kMaxEdges = 256;
constexpr int kMaxMelTasks = 512;
constexpr int kMaxMelRounds = 8;
constexpr int kMaxMelPacked = 4096;
constexpr int kCols = 128;
constexpr int kPad = 4;  // zeros before and after a row in its slot
constexpr float kEps = 1e-10f;
constexpr int kStride2 = 1, kOnsetFlag = 2, kMel = 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most `pending` of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else if (pending == 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

// One warp copies the n floats of a row to dst (16-byte aligned): 16 bytes a
// lane when the source is 16-byte aligned too, else 4 bytes a lane.
__device__ __forceinline__ void warp_copy_row_async(float* dst, const float* src, int n, int lane) {
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    for (int q = lane; q < (n >> 2); q += 32) cp_async16(dst + 4 * q, src + 4 * q);
    done = n & ~3;
  }
  for (int i = done + lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// Eight sums over the warp in one butterfly: on return v[0] of lane l is the
// warp's total of the caller's v[l >> 2]. The first three steps halve the
// number of values each lane carries, the last two finish the sums.
__device__ __forceinline__ void warp_sum8(float (&v)[8], int lane) {
#pragma unroll
  for (int n = 4, o = 16; n >= 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[i] : v[i + n];
      const float keep = up ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// max of row[lo..hi], lo <= hi
__device__ __forceinline__ float window_max(const float* row, int lo, int hi) {
  float m = row[lo];
  for (int i = lo + 1; i <= hi; ++i) m = fmaxf(m, row[i]);
  return m;
}

// The 9-wide maxima of four neighbouring bins from the 12 values around
// them (a = bins -4..-1, b = the four bins, c = bins +4..+7): 15 maxima.
__device__ __forceinline__ float4 window_max4(float4 a, float4 b, float4 c) {
  const float core = fmaxf(fmaxf(fmaxf(a.w, b.x), fmaxf(b.y, b.z)), fmaxf(b.w, c.x));
  const float l = fmaxf(a.y, a.z), r = fmaxf(c.y, c.z);
  return make_float4(fmaxf(core, fmaxf(a.x, l)), fmaxf(core, fmaxf(l, c.y)),
                     fmaxf(core, fmaxf(a.z, r)), fmaxf(core, fmaxf(r, c.w)));
}

// sums[0] += the four values' total; sums[q] += the values of the bins in
// sub-band q, read from the group's four band bytes
__device__ __forceinline__ void add_by_band(float (&sums)[8], int base, uint32_t bands, float v0,
                                            float v1, float v2, float v3) {
  const float total = (v0 + v1) + (v2 + v3);
  sums[base] += total;
  const uint32_t first = bands & 0xffu;
  if (bands == first * 0x01010101u) {  // one band for all four bins (or none)
#pragma unroll
    for (int q = 1; q < kMaxBands; ++q) sums[base + q] += first == q ? total : 0.f;
  } else {
#pragma unroll
    for (int q = 1; q < kMaxBands; ++q) {
      sums[base + q] += ((first == q ? v0 : 0.f) + (((bands >> 8) & 0xffu) == q ? v1 : 0.f)) +
                        ((((bands >> 16) & 0xffu) == q ? v2 : 0.f) + ((bands >> 24) == q ? v3 : 0.f));
    }
  }
}

struct Layout {  // the block's dynamic shared memory, in floats from its start
  int ks, rows, out, mel_w, rowmax, bands, edges, tasks, total;
};
__host__ __device__ inline Layout layout(int k, int tile, int n_pack, int n_edge, int n_task) {
  Layout l;
  const int k4 = (k + 3) & ~3;
  l.ks = k4 + 2 * kPad;
  l.rows = 0;
  l.out = l.rows + (tile + 2) * l.ks;
  l.mel_w = l.out + tile * kCols;
  l.rowmax = l.mel_w + ((n_pack + 3) & ~3);
  l.bands = l.rowmax + ((tile + 2 + 3) & ~3);
  l.edges = l.bands + k4 / 4;
  l.tasks = l.edges + 4 * n_edge;
  l.total = l.tasks + 4 * n_task;
  return l;
}

// FIXED4: the max-filter radius sf_k is 4, the window of four neighbouring
// bins is the 12 values of three 16-byte loads.
template <bool FIXED4>
__global__ void fused_novelty_kernel(
    const float* __restrict__ spec,        // [B, C, K]
    const float* __restrict__ prev2,       // [B, 2, K] the two frames before the chunk
    const uint32_t* __restrict__ bin_band,  // [ceil(K/4)] a byte a bin: its sub-band, 0 for none
    const int* __restrict__ edges,         // [n_edge, 4] (bin, lo, hi, band): sub-band windows
    const int* __restrict__ mel_tasks,     // [n_task, 4] (lo, hi, offset into mel_pack, column)
    const float* __restrict__ mel_pack,    // [n_pack] filter weights, each over its range
    float* __restrict__ out,               // [B, C, 128]
    int c, int k, int nb, int nm, int n_edge, int n_task, int n_pack, int sf_k, int tile,
    int flags, const int* __restrict__ mel_rounds, int n_rounds) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(k, tile, n_pack, n_edge, n_task);
  float* out_s = smem + lay.out;                       // [tile, 128]
  float* mel_w = smem + lay.mel_w;                     // [n_pack]
  float* rowmax = smem + lay.rowmax;                   // [tile + 2]
  uint32_t* bands_s = (uint32_t*)(smem + lay.bands);   // [ceil(K/4)]
  int* edges_s = (int*)(smem + lay.edges);             // [n_edge, 4]
  int* tasks_s = (int*)(smem + lay.tasks);             // [n_task, 4]
  __shared__ int rounds_s[kMaxMelRounds + 1];

  const bool stride2 = flags & kStride2, onset = flags & kOnsetFlag, use_mel = flags & kMel;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile;
  const int nf = min(tile, c - f0);
  const int nr = nf + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int ng = (k + 3) >> 2;  // groups of four bins

  // row g of the extended chunk: g < 0 are the frames of prev2
  auto row_ptr = [&](int g) -> const float* {
    return g < 0 ? prev2 + ((size_t)b * 2 + (g + 2)) * k : spec + ((size_t)b * c + g) * k;
  };
  // tile row r (frame f0 - 2 + r) in shared memory, bin 0 first; kPad zeros
  // lie before it and at least kPad after it
  auto slot = [&](int r) -> float* { return smem + lay.rows + r * lay.ks + kPad; };

  // every row this warp owns goes in flight, one copy group a row
  int groups = 0;
  for (int r = warp; r < nr; r += nw, ++groups) {
    float* row = slot(r);
    if (lane < kPad) row[lane - kPad] = 0.f;
    for (int i = k + lane; i < lay.ks - kPad; i += 32) row[i] = 0.f;
    warp_copy_row_async(row, row_ptr(f0 - 2 + r), k, lane);
    cp_async_commit();
  }
  for (int i = tid; i < ng; i += blockDim.x) bands_s[i] = bin_band[i];
  for (int i = tid; i < 4 * n_edge; i += blockDim.x) edges_s[i] = edges[i];
  if (use_mel) {
    for (int i = tid; i < n_pack; i += blockDim.x) mel_w[i] = mel_pack[i];
    for (int i = tid; i < 4 * n_task; i += blockDim.x) tasks_s[i] = mel_tasks[i];
    if (tid <= n_rounds) rounds_s[tid] = mel_rounds[tid];
  }
  __syncthreads();

  // phase 1: a warp per row
  int done = 0;
  for (int r = warp; r < nr; r += nw, ++done) {
    cp_async_wait(groups - 1 - done);
    __syncwarp();
    float* row = slot(r);
    float4* row4 = reinterpret_cast<float4*>(row);
    float* orow = out_s + (r - 2) * kCols;
    if (r >= 2) {
#pragma unroll
      for (int q = 0; q < kCols / 32; ++q) orow[lane + 32 * q] = 0.f;
    }
    float mx = -INFINITY;
    float sums[8];  // energy per band, then HFC per band
#pragma unroll
    for (int q = 0; q < 8; ++q) sums[q] = 0.f;
#pragma unroll 2
    for (int g = lane; g < ng; g += 32) {
      const float4 x = row4[g];  // bins past K are 0
      row4[g] = make_float4(log1pf(fmaxf(x.x, 0.f)), log1pf(fmaxf(x.y, 0.f)),
                            log1pf(fmaxf(x.z, 0.f)), log1pf(fmaxf(x.w, 0.f)));
      const int k0 = 4 * g;
      mx = fmaxf(mx, x.x);
      if (k0 + 1 < k) mx = fmaxf(mx, x.y);
      if (k0 + 2 < k) mx = fmaxf(mx, x.z);
      if (k0 + 3 < k) mx = fmaxf(mx, x.w);
      const float e0 = x.x * x.x, e1 = x.y * x.y, e2 = x.z * x.z, e3 = x.w * x.w;
      const float kf = (float)k0;
      const uint32_t bands = bands_s[g];
      add_by_band(sums, 0, bands, e0, e1, e2, e3);
      add_by_band(sums, kMaxBands, bands, e0 * kf, e1 * (kf + 1.f), e2 * (kf + 2.f),
                  e3 * (kf + 3.f));
    }
    mx = warp_max(mx);
    if (lane == 0) rowmax[r] = mx;
    __syncwarp();  // the log row and the zeroed output row are complete
    if (r < 2) continue;
    warp_sum8(sums, lane);
    if ((lane & 3) == 0) {
      const int band = (lane >> 2) & 3, is_hfc = lane >> 4;
      if (band < nb) orow[2 * nb + 2 * band + is_hfc] = sums[0];
    }
    if (use_mel) {
      // a lane per task (a filter, or a piece of a long one); the pieces
      // after a filter's first come in later rounds and add to its column
      for (int round = 0; round < n_rounds; ++round) {
        for (int t = rounds_s[round] + lane; t < rounds_s[round + 1]; t += 32) {
          const int lo = tasks_s[4 * t], hi = tasks_s[4 * t + 1];
          const float* w = mel_w + tasks_s[4 * t + 2] - lo;
          float dot = 0.f;
          for (int kk = lo; kk < hi; ++kk) dot += row[kk] * w[kk];
          float* dst = orow + tasks_s[4 * t + 3];
          *dst = round ? *dst + dot : dot;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // phase 2: a warp per frame
  for (int i = warp; i < nf; i += nw) {
    const float* lcur = slot(i + 2);
    const float* lp1 = slot(i + 1);
    const float* lp2 = slot(i);
    float sums[8];  // SuperFlux per band at stride 1, then at stride 2
#pragma unroll
    for (int q = 0; q < 8; ++q) sums[q] = 0.f;
    for (int g = lane; g < ng; g += 32) {
      const float4 lc = reinterpret_cast<const float4*>(lcur)[g];
      const uint32_t bands = bands_s[g];
      const int k0 = 4 * g;
      // bins past K: lc is 0 and the filter is >= 0, so they add nothing
      auto flux = [&](const float* prev, int base) {
        float4 m;
        if (FIXED4) {
          const float4* p4 = reinterpret_cast<const float4*>(prev - kPad);
          m = window_max4(p4[g], p4[g + 1], p4[g + 2]);
        } else {
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = min(k0 + j, k - 1);
            w[j] = window_max(prev, max(kk - sf_k, 0), min(kk + sf_k, k - 1));
          }
          m = make_float4(w[0], w[1], w[2], w[3]);
        }
        const float d0 = fmaxf(lc.x - m.x, 0.f), d1 = fmaxf(lc.y - m.y, 0.f);
        const float d2 = fmaxf(lc.z - m.z, 0.f), d3 = fmaxf(lc.w - m.w, 0.f);
        add_by_band(sums, base, bands, d0 * d0, d1 * d1, d2 * d2, d3 * d3);
      };
      flux(lp1, 0);
      if (stride2) flux(lp2, kMaxBands);
    }
    // within sf_k bins of its edges a sub-band's filter is clamped to the
    // band: those bins trade the full band's term for their own
    for (int e = lane; e < n_edge; e += 32) {
      const int kk = edges_s[4 * e], lo = edges_s[4 * e + 1], hi = edges_s[4 * e + 2];
      const int band = edges_s[4 * e + 3];
      const int flo = max(kk - sf_k, 0), fhi = min(kk + sf_k, k - 1);
      const float lc = lcur[kk];
      auto trade = [&](const float* prev) {
        const float df = fmaxf(lc - window_max(prev, flo, fhi), 0.f);
        const float ds = fmaxf(lc - window_max(prev, lo, hi), 0.f);
        return ds * ds - df * df;
      };
      const float t1 = trade(lp1), t2 = stride2 ? trade(lp2) : 0.f;
#pragma unroll
      for (int q = 1; q < kMaxBands; ++q) {
        sums[q] += band == q ? t1 : 0.f;
        sums[kMaxBands + q] += band == q ? t2 : 0.f;
      }
    }
    float on = 0.f;
    if (onset) {
      const float* xcur = row_ptr(f0 + i);
      const float* xprev = row_ptr(f0 + i - 1);
      const float cmax = rowmax[i + 2], pmax = rowmax[i + 1];
      const float cden = fmaxf(cmax, kEps), pden = fmaxf(pmax, kEps);
#pragma unroll 4
      for (int kk = lane; kk < k; kk += 32) {
        const float cn = cmax > kEps ? __ldg(xcur + kk) / cden : 0.f;
        const float pn = pmax > kEps ? __ldg(xprev + kk) / pden : 0.f;
        const float d = fmaxf(cn - pn, 0.f);
        on += d * d;
      }
    }
    warp_sum8(sums, lane);
    on = warp_sum(on);
    float* orow = out_s + i * kCols;
    if ((lane & 3) == 0) {
      const int band = (lane >> 2) & 3, two = lane >> 4;
      if (band < nb && (stride2 || !two)) orow[two * nb + band] = sqrtf(fmaxf(sums[0], 0.f));
    }
    if (lane == 0 && onset) orow[4 * nb + nm] = sqrtf(on);
    __syncwarp();
    reinterpret_cast<float4*>(out + ((size_t)b * c + f0 + i) * kCols)[lane] =
        reinterpret_cast<const float4*>(orow)[lane];
  }
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.
extern "C" int stratum_fused_novelty_smem(int k, int tile, int n_pack, int n_edge, int n_task) {
  return (int)sizeof(float) * layout(k, tile, n_pack, n_edge, n_task).total;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success). flags:
// 1 = stride-2 SuperFlux, 2 = onset flux, 4 = mel. `threads` a block, a
// multiple of 32; `tile` frames a block. mel_rounds [n_rounds + 1]: the
// tasks of round i are [mel_rounds[i], mel_rounds[i + 1]).
extern "C" int stratum_fused_novelty(const void* spec, const void* prev2, const void* bin_band,
                                     const void* edges, const void* mel_tasks,
                                     const void* mel_rounds, const void* mel_pack, void* out,
                                     int batch, int c, int k, int nb, int nm, int n_edge,
                                     int n_task, int n_rounds, int n_pack, int sf_k, int tile,
                                     int threads, int flags, void* stream) {
  const bool mel = flags & kMel;
  if (!mel) n_task = n_rounds = n_pack = 0;
  if (batch <= 0 || c <= 0 || k <= 0 || k > kMaxBins || nb < 1 || nb > kMaxBands || nm < 0 ||
      nm > kMaxMels || 4 * nb + nm + 1 > kCols || n_edge < 0 || n_edge > kMaxEdges ||
      n_task < 0 || n_task > kMaxMelTasks || n_rounds < 0 || n_rounds > kMaxMelRounds ||
      n_pack < 0 || n_pack > kMaxMelPacked || sf_k < 1 || tile < 1 || threads < 32 ||
      threads > 1024 || threads % 32 || batch > 65535 || bin_band == nullptr ||
      (n_edge && edges == nullptr) ||
      (mel && (mel_pack == nullptr || mel_tasks == nullptr || mel_rounds == nullptr)) ||
      (((uintptr_t)spec | (uintptr_t)prev2) & 3) || ((uintptr_t)out & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * (size_t)layout(k, tile, n_pack, n_edge, n_task).total;
  auto kernel = sf_k == 4 ? fused_novelty_kernel<true> : fused_novelty_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + tile - 1) / tile, batch);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)spec, (const float*)prev2, (const uint32_t*)bin_band, (const int*)edges,
      (const int*)mel_tasks, (const float*)mel_pack, (float*)out, c, k, nb, nm, n_edge, n_task,
      n_pack, sf_k, tile, flags, (const int*)mel_rounds, n_rounds);
  return (int)cudaGetLastError();
}
