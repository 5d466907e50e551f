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
// What bounds it on this card: memory bandwidth. One chunk of the main path
// reads 40 x 256 x 1025 x 4 B ~ 42 MB and writes ~5 MB (the plain PyTorch
// version makes about 15 full [B, C, K] passes per chunk), while the
// arithmetic is ~60 flops per bin.
//
// What the design does about it: the chunk is read once. One block per
// (track, tile of frames) walks its frames in order; each thread owns a fixed
// set of bins. The log1p of the previous frame sits in shared memory (a
// two-row ring), so the max filter reads its neighbours there; the filtered
// previous row stays in registers and is the next frame's stride-2 filter.
// The raw previous row is kept normalized in registers for the onset flux,
// whose row max is taken first. The 4+4+8 band sums and the onset sum are
// per-thread partials, reduced per warp with shuffles and across warps in a
// fixed order (deterministic; it differs from the reference's matmul order by
// f32 rounding). Each bin's clamped max filter is computed directly over
// [max(s, k-sf_k), min(e-1, k+sf_k)] for the full band and its sub-band.
// Built without --use_fast_math: log1pf, sqrtf and the division stay IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// limits, mirrored by ops/novelty.py (KERNEL_MAX_*)
constexpr int kMaxBinsPerThread = 8;  // K <= 2048
constexpr int kMaxBands = 4;
constexpr int kMaxMels = 128;
constexpr int kCols = 128;
// per-thread partial sums: stride-1 SuperFlux, stride-2 SuperFlux, energy,
// HFC (kMaxBands each), then the onset flux
constexpr int kSums = 4 * kMaxBands + 1;
constexpr int kOnset = 4 * kMaxBands;
constexpr float kEps = 1e-10f;
constexpr int kStride2 = 1, kOnsetFlag = 2, kMel = 4;

__device__ __forceinline__ float window_max(const float* row, int k, int r, int lo, int hi) {
  const int a = max(lo, k - r), b = min(hi - 1, k + r);
  float m = row[a];
  for (int i = a + 1; i <= b; ++i) m = fmaxf(m, row[i]);
  return m;
}

// Max over the block; every thread gets it. Starts with a barrier's worth of
// visibility: shared-memory writes before the call are visible after it.
__device__ __forceinline__ float block_max(float v, float* wmax) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = wmax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w]);
  return m;
}

__global__ void __launch_bounds__(kThreads) fused_novelty_kernel(
    const float* __restrict__ spec,     // [B, C, K]
    const float* __restrict__ prev2,    // [B, 2, K] the two frames before the chunk
    const int* __restrict__ bands,      // [nb, 2] (start, end); band 0 = [0, K)
    const float* __restrict__ mel_w,    // [nm, K] one filter per row
    const int* __restrict__ mel_rng,    // [nm, 2] nonzero range [lo, hi) of each filter
    float* __restrict__ out,            // [B, C, 128]
    int c, int k, int nb, int nm, int sf_k, int tile, int flags) {
  extern __shared__ float smem[];
  float* ring = smem;                      // [2, K] log1p rows
  float* mel_out = ring + 2 * k;           // [nm]
  float* part = mel_out + kMaxMels;        // [kWarps, kSums]
  float* wmax = part + kWarps * kSums;      // [kWarps]
  __shared__ int sband[2 * kMaxBands];
  __shared__ int smel[2 * kMaxMels];

  const bool stride2 = flags & kStride2, onset = flags & kOnsetFlag, use_mel = flags & kMel;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile;
  const int nf = min(tile, c - f0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 2 * nb) sband[tid] = bands[tid];
  if (use_mel) {
    for (int i = tid; i < 2 * nm; i += kThreads) smel[i] = mel_rng[i];
  }
  __syncthreads();

  // the sub-band (1..nb-1) of each owned bin, 0 for none
  int sub[kMaxBinsPerThread];
#pragma unroll
  for (int j = 0; j < kMaxBinsPerThread; ++j) {
    const int kk = tid + j * kThreads;
    sub[j] = 0;
    for (int q = 1; q < nb; ++q) {
      if (kk >= sband[2 * q] && kk < sband[2 * q + 1]) sub[j] = q;
    }
  }
  // row g of the extended chunk: g < 0 are the frames of prev2
  auto row_ptr = [&](int g) -> const float* {
    return g < 0 ? prev2 + ((size_t)b * 2 + (g + 2)) * k : spec + ((size_t)b * c + g) * k;
  };

  float lc[kMaxBinsPerThread];   // log1p of the current frame
  float pn[kMaxBinsPerThread];   // previous frame normalized by its row max
  float pf2[kMaxBinsPerThread];  // full-band filter of frame f-2
  float ps2[kMaxBinsPerThread];  // sub-band filter of frame f-2

  // frames f0-2 and f0-1: ring rows 0 and 1
  {
    const float* r2 = row_ptr(f0 - 2);
    const float* r1 = row_ptr(f0 - 1);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxBinsPerThread; ++j) {
      const int kk = tid + j * kThreads;
      pn[j] = 0.f;
      if (kk < k) {
        ring[kk] = log1pf(fmaxf(r2[kk], 0.f));
        const float x = r1[kk];
        ring[k + kk] = log1pf(fmaxf(x, 0.f));
        pn[j] = x;
        mx = fmaxf(mx, x);
      }
    }
    const float pmax = block_max(mx, wmax);
#pragma unroll
    for (int j = 0; j < kMaxBinsPerThread; ++j) {
      const int kk = tid + j * kThreads;
      pn[j] = pmax > kEps ? pn[j] / fmaxf(pmax, kEps) : 0.f;
      pf2[j] = ps2[j] = 0.f;
      if (stride2 && kk < k) {
        pf2[j] = window_max(ring, kk, sf_k, 0, k);
        if (sub[j]) ps2[j] = window_max(ring, kk, sf_k, sband[2 * sub[j]], sband[2 * sub[j] + 1]);
      }
    }
    __syncthreads();  // frame 0 overwrites ring row 0 and wmax
  }

  for (int i = 0; i < nf; ++i) {
    const float* rc = row_ptr(f0 + i);
    float* lcur = ring + (i & 1) * k;           // overwrites frame f-2, kept in pf2/ps2
    const float* lprev = ring + ((i + 1) & 1) * k;
    float xc[kMaxBinsPerThread];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxBinsPerThread; ++j) {
      const int kk = tid + j * kThreads;
      xc[j] = lc[j] = 0.f;
      if (kk < k) {
        xc[j] = rc[kk];
        lc[j] = log1pf(fmaxf(xc[j], 0.f));
        lcur[kk] = lc[j];
        mx = fmaxf(mx, xc[j]);
      }
    }
    const float cmax = block_max(mx, wmax);  // barrier: lcur complete

    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxBinsPerThread; ++j) {
      const int kk = tid + j * kThreads;
      if (kk >= k) continue;
      const int sb = sub[j];
      const int s = sband[2 * sb], e = sband[2 * sb + 1];
      const float pf1 = window_max(lprev, kk, sf_k, 0, k);
      const float ps1 = sb ? window_max(lprev, kk, sf_k, s, e) : 0.f;
      const float d1f = fmaxf(lc[j] - pf1, 0.f);
      const float d1s = fmaxf(lc[j] - ps1, 0.f);
      const float x2 = xc[j] * xc[j];
      const float h = x2 * (float)kk;
      acc[0] += d1f * d1f;
      acc[2 * kMaxBands] += x2;
      acc[3 * kMaxBands] += h;
      float d2f = 0.f, d2s = 0.f;
      if (stride2) {
        d2f = fmaxf(lc[j] - pf2[j], 0.f);
        d2s = fmaxf(lc[j] - ps2[j], 0.f);
        acc[kMaxBands] += d2f * d2f;
        pf2[j] = pf1;
        ps2[j] = ps1;
      }
#pragma unroll
      for (int q = 1; q < kMaxBands; ++q) {
        if (sb == q) {
          acc[q] += d1s * d1s;
          acc[kMaxBands + q] += d2s * d2s;
          acc[2 * kMaxBands + q] += x2;
          acc[3 * kMaxBands + q] += h;
        }
      }
      if (onset) {
        const float cn = cmax > kEps ? xc[j] / fmaxf(cmax, kEps) : 0.f;
        const float d = fmaxf(cn - pn[j], 0.f);
        acc[kOnset] += d * d;
        pn[j] = cn;
      }
    }
    if (use_mel) {
      for (int m = warp; m < nm; m += kWarps) {
        float sacc = 0.f;
        for (int kk = smel[2 * m] + lane; kk < smel[2 * m + 1]; kk += 32) {
          sacc += lcur[kk] * mel_w[(size_t)m * k + kk];
        }
        for (int o = 16; o; o >>= 1) sacc += __shfl_xor_sync(0xffffffffu, sacc, o);
        if (lane == 0) mel_out[m] = sacc;
      }
    }
#pragma unroll
    for (int q = 0; q < kSums; ++q) {
      float v = acc[q];
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) part[warp * kSums + q] = v;
    }
    __syncthreads();  // partials and mel complete; also ends the reads of lprev

    if (tid < kCols) {
      const int col = tid;
      auto total = [&](int q) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[w * kSums + q];
        return sum;
      };
      float v = 0.f;
      if (col < nb) {
        v = sqrtf(fmaxf(total(col), 0.f));
      } else if (col < 2 * nb) {
        v = stride2 ? sqrtf(fmaxf(total(kMaxBands + col - nb), 0.f)) : 0.f;
      } else if (col < 4 * nb) {
        const int q = col - 2 * nb;
        v = total(((q & 1) ? 3 : 2) * kMaxBands + (q >> 1));
      } else if (col < 4 * nb + nm) {
        v = use_mel ? mel_out[col - 4 * nb] : 0.f;
      } else if (col == 4 * nb + nm) {
        v = onset ? sqrtf(total(kOnset)) : 0.f;
      }
      out[((size_t)b * c + f0 + i) * kCols + col] = v;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). flags:
// 1 = stride-2 SuperFlux, 2 = onset flux, 4 = mel.
extern "C" int stratum_fused_novelty(const void* spec, const void* prev2, const void* bands,
                                     const void* mel_w, const void* mel_rng, void* out,
                                     int batch, int c, int k, int nb, int nm, int sf_k, int tile,
                                     int flags, void* stream) {
  if (batch <= 0 || c <= 0 || k <= 0 || k > kThreads * kMaxBinsPerThread || nb < 1 ||
      nb > kMaxBands || nm < 0 || nm > kMaxMels || 4 * nb + nm + 1 > kCols || sf_k < 1 ||
      tile < 1 || batch > 65535 || ((flags & kMel) && (mel_w == nullptr || mel_rng == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (2 * (size_t)k + kMaxMels + kWarps * kSums + kWarps) * sizeof(float);
  const dim3 grid((c + tile - 1) / tile, batch);
  fused_novelty_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)spec, (const float*)prev2, (const int*)bands, (const float*)mel_w,
      (const int*)mel_rng, (float*)out, c, k, nb, nm, sf_k, tile, flags);
  return (int)cudaGetLastError();
}
