// Stage 2 of the polyphase 8192/512 key STFT, written by hand for Hopper
// (sm_90a).
//
// Replaces: stratum_dsp_tpu/ops/polyphase_pallas.py:polyphase_stage2
// (Pallas body _make_kernel, tables _twiddle_tables / _box_weights).
//
// What it computes, per track b, output frame f < ext and bin k < keep:
//   C[j, k] = e^{-2 pi i k j / R} * Bd[j, k]        (f32, then rounded to bf16)
//   S[f, k] = sum_{j=f}^{f+R-1} C[j, k]             (f32 accumulate, ascending j)
//   W[f, k] = 0.5 S[k] - 0.25 (e^{-i phi} S[k-1] + e^{+i phi} S[k+1]),
//             phi = 2 pi (f mod R) / R, S[-1] = conj S[1]
//   out     = bf16(|W[f, k]|)
// with the same rounding points as the TPU kernel: bd arrives bf16, the
// twiddle runs in f32, C is rounded to bf16, S stays f32 and is summed afresh
// for every frame in ascending row order (a sliding add-and-subtract sum
// would round differently), the mix and the magnitude run in f32 and the
// output is rounded to bf16. Every f32 product and sum uses the _rn
// intrinsics, so nvcc does not contract them into FMAs that the reference
// (and the plain PyTorch version) does not have: the kernel is bit-equal to
// the plain version.
//
// What bounds it on this card: bytes. One chunk of the main path reads
// 40 x 240 x 2048 bf16 (39 MB) and writes 40 x 216 x 931 bf16 (16 MB): ~17 us
// at 3.35 TB/s, against ~7 us for its ~56 f32 operations per output at the
// SIMT units' 67 TFLOP/s. The TPU kernel's banded 0/1 MXU product is a TPU
// idiom; a 16-term sum needs no tensor core.
//
// What the design does about it:
// * The unit of work is a warp, and no warp waits for another: there is no
//   barrier in the frame loop. A thread owns two adjacent S columns, loaded
//   as one bf16x2 word per half (a warp asks for a full 128-byte line per
//   instruction); the k-1 / k+1 neighbours of the mix are the thread's own
//   other column or the neighbouring lane's, by __shfl_up_sync /
//   __shfl_down_sync. A warp covers 64 S columns and writes the 62 inside;
//   its two edge columns are computed twice.
// * R is a template parameter and frame tiles start at multiples of R, so
//   the row loop is unrolled over j mod R: the last R twiddled rows sit in
//   registers (a ring whose slot is a constant), every `mod R` is a constant
//   or a mask, and the R-term sum reads registers only.
// * Rows in flight: each thread keeps the words of the next D rows in
//   registers, loaded D rows ahead of their use, so D loads a thread are on
//   their way while a row is processed.
// * Frame tiles are short enough for more warps than the card has slots;
//   the R-1 halo rows a tile reads again come from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpCols = 64;               // S columns a warp holds
constexpr int kWarpOut = kWarpCols - 2;     // output bins a warp writes
constexpr int kBlockOut = kWarps * kWarpOut;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// |0.5 S - 0.25 (e^{-i phi} S[k-1] + e^{+i phi} S[k+1])| from S = (sre, sim),
// S[k-1] = (mre, mim), S[k+1] = (pre, pim), e^{i phi} = (cp, sp)
__device__ __forceinline__ __nv_bfloat16 mix(float sre, float sim, float mre, float mim, float pre,
                                             float pim, float cp, float sp) {
  const float are = __fadd_rn(__fmul_rn(__fadd_rn(mre, pre), cp), __fmul_rn(__fsub_rn(mim, pim), sp));
  const float aim = __fadd_rn(__fmul_rn(__fadd_rn(mim, pim), cp), __fmul_rn(__fsub_rn(pre, mre), sp));
  const float wre = __fsub_rn(__fmul_rn(0.5f, sre), __fmul_rn(0.25f, are));
  const float wim = __fsub_rn(__fmul_rn(0.5f, sim), __fmul_rn(0.25f, aim));
  return __float2bfloat16_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(wre, wre), __fmul_rn(wim, wim))));
}

// R: frames per hop-block ratio, a power of two; D: rows loaded ahead, a
// divisor of R. Frame tiles (ft) are multiples of R.
template <int R, int D>
__global__ void __launch_bounds__(kThreads) polyphase_stage2_kernel(
    const __nv_bfloat16* __restrict__ bd,  // [B, EBP, 2*KP]: re | im halves
    const float* __restrict__ tables,      // [4, R]: cos, -sin, cos phi, sin phi
    __nv_bfloat16* __restrict__ out,       // [B, ext, keep]
    int ebp, int kp, int ext, int keep, int ft) {
  static_assert((R & (R - 1)) == 0 && R % D == 0, "R a power of two, D a divisor of R");
  __shared__ float2 tw[R];  // twiddle (cos, -sin) of 2 pi m / R
  __shared__ float2 ph[R];  // mix phase (cos phi, sin phi) of frame class m
  if (threadIdx.x < R) {
    tw[threadIdx.x] = make_float2(tables[threadIdx.x], tables[R + threadIdx.x]);
    ph[threadIdx.x] = make_float2(tables[2 * R + threadIdx.x], tables[3 * R + threadIdx.x]);
  }
  __syncthreads();  // the only barrier: once a block, before the frame loop

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's S columns start at an even column, so every bf16x2 word is
  // aligned; its outputs are the 62 columns after the first
  const int s0 = (blockIdx.x * kWarps + warp) * kWarpOut - 2;
  if (s0 + 1 >= keep) return;
  const int c0 = s0 + 2 * lane;  // this thread's columns are c0 and c0 + 1
  const bool pair_ok = c0 >= 0 && c0 < kp;
  const int kc0 = c0 & (R - 1), kc1 = (c0 + 1) & (R - 1);
  const bool out0 = lane > 0 && c0 >= 0 && c0 < keep;
  const bool out1 = lane < 31 && c0 + 1 >= 0 && c0 + 1 < keep;

  const int b = blockIdx.z;
  const int f0 = blockIdx.y * ft;
  const int f_end = min(f0 + ft, ext);
  const int j_end = f_end + R - 1;  // rows [f0, j_end) feed frames [f0, f_end)
  const size_t row_words = (size_t)kp;  // a row is 2*KP bf16 = KP words
  const uint32_t* base =
      reinterpret_cast<const uint32_t*>(bd + (size_t)b * ebp * 2 * kp + (pair_ok ? c0 : 0));
  const size_t im_words = (size_t)kp / 2;
  __nv_bfloat16* orow = out + (size_t)b * ext * keep;

  auto load = [&](int j, uint32_t& re, uint32_t& im) {
    re = im = 0u;
    if (pair_ok && j < j_end) {
      re = __ldg(base + (size_t)j * row_words);
      im = __ldg(base + (size_t)j * row_words + im_words);
    }
  };
  uint32_t pre_re[D], pre_im[D];
#pragma unroll
  for (int d = 0; d < D; ++d) load(f0 + d, pre_re[d], pre_im[d]);

  // the last R twiddled rows of both columns; slot = row mod R
  float cre0[R], cim0[R], cre1[R], cim1[R];
  for (int j0 = f0; j0 < j_end; j0 += R) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = j0 + i;  // j mod R == i: tiles start at multiples of R
      if (j >= j_end) break;
      const uint32_t ure = pre_re[i % D], uim = pre_im[i % D];
      load(j + D, pre_re[i % D], pre_im[i % D]);
      // twiddle e^{-2 pi i k j / R} (class (j mod R)(k mod R) mod R), C -> bf16
      const float2 t0 = tw[(i * kc0) & (R - 1)], t1 = tw[(i * kc1) & (R - 1)];
      const float bre0 = __uint_as_float(ure << 16), bre1 = __uint_as_float(ure & 0xffff0000u);
      const float bim0 = __uint_as_float(uim << 16), bim1 = __uint_as_float(uim & 0xffff0000u);
      cre0[i] = bf16_round(__fsub_rn(__fmul_rn(bre0, t0.x), __fmul_rn(bim0, t0.y)));
      cim0[i] = bf16_round(__fadd_rn(__fmul_rn(bre0, t0.y), __fmul_rn(bim0, t0.x)));
      cre1[i] = bf16_round(__fsub_rn(__fmul_rn(bre1, t1.x), __fmul_rn(bim1, t1.y)));
      cim1[i] = bf16_round(__fadd_rn(__fmul_rn(bre1, t1.y), __fmul_rn(bim1, t1.x)));

      const int f = j - R + 1;
      if (f < f0) continue;  // the ring is still filling (uniform across the block)
      // rows f .. f+R-1 in ascending order: slots i+1, i+2, ... (mod R)
      float sre0 = 0.f, sim0 = 0.f, sre1 = 0.f, sim1 = 0.f;
#pragma unroll
      for (int t = 1; t <= R; ++t) {
        sre0 = __fadd_rn(sre0, cre0[(i + t) % R]);
        sim0 = __fadd_rn(sim0, cim0[(i + t) % R]);
        sre1 = __fadd_rn(sre1, cre1[(i + t) % R]);
        sim1 = __fadd_rn(sim1, cim1[(i + t) % R]);
      }
      // column c0's left neighbour is lane-1's c0+1; c0+1's right is lane+1's c0
      float lre = __shfl_up_sync(0xffffffffu, sre1, 1), lim = __shfl_up_sync(0xffffffffu, sim1, 1);
      const float rre = __shfl_down_sync(0xffffffffu, sre0, 1);
      const float rim = __shfl_down_sync(0xffffffffu, sim0, 1);
      if (c0 == 0) {  // S[-1] = conj S[1]
        lre = sre1;
        lim = -sim1;
      }
      const float2 p = ph[(i + 1) % R];  // f mod R
      if (out0) orow[(size_t)f * keep + c0] = mix(sre0, sim0, lre, lim, sre1, sim1, p.x, p.y);
      if (out1) orow[(size_t)f * keep + c0 + 1] = mix(sre1, sim1, sre0, sim0, rre, rim, p.x, p.y);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). `r` must
// be 16 and `ft` (frames a block) a multiple of it.
extern "C" int stratum_polyphase_stage2(const void* bd, const void* tables, void* out,
                                        int batch, int ebp, int kp, int r, int ext,
                                        int keep, int ft, void* stream) {
  if (batch <= 0 || batch > 65535 || ext <= 0 || keep <= 0 || ft <= 0 || r != 16 || ft % r ||
      kp % 2 || keep >= kp || ebp < ext + r - 1 || ((uintptr_t)bd & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((keep + kBlockOut - 1) / kBlockOut, (ext + ft - 1) / ft, batch);
  polyphase_stage2_kernel<16, 8><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)bd, (const float*)tables, (__nv_bfloat16*)out, ebp, kp, ext, keep,
      ft);
  return (int)cudaGetLastError();
}
