// 5-state HMM Viterbi decode, written by hand for Hopper (sm_90a).
//
// Replaces: stratum_dsp_tpu/ops/viterbi_pallas.py:viterbi_decode (Pallas body
// _viterbi_kernel), the TPU form of the decode in features/beat/hmm.py
// track_beats (hmm.rs:308-375).
//
// What it computes, per track: v_0[s] = 0.2 * em[0]; for t >= 1 and each
// state s, the candidates v_{t-1}[p] * trans[p][s] over the nonzero
// transitions p in {s-1, s, s+1}, taken in ascending p with a strict `>`
// from (0, state 0); v_t[s] = best * em[t] and the backpointer is the
// winning p. The final state is the first maximum of v_{T-1}; the states
// follow by backtracking. Multiplicative f32, exactly as the reference: only
// correctly rounded multiplies (no add, so no FMA question), and the library
// is built without flush-to-zero, because on long runs of small emissions
// the probabilities underflow through denormals to 0 and the ties that
// follow decide the path.
//
// What bounds it on this card: latency. The forward pass is ~T = 1023
// dependent steps per track of a few multiplies and compares; the whole
// batch is ~40 x 1024 x 4 B of input.
//
// What the design does about it: one warp per track, so a step needs no
// barrier. The warp stages the track's emissions in shared memory with
// coalesced loads; lanes 0-4 own one state each and read their neighbours'
// probabilities with __shfl_up_sync / __shfl_down_sync; the backpointers go
// to shared memory as uint8 [T, 5]. Lane 0 picks the final state and
// backtracks from shared memory, and the warp writes the states back with
// coalesced stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStates = 5;
constexpr int kSmemBytes = 48 * 1024;
// shared bytes per frame: the emission (then the decoded state) and 5 backpointers
constexpr int kBytesPerFrame = 4 + kStates;

__global__ void __launch_bounds__(32) viterbi_kernel(
    const float* __restrict__ em,     // [B, T] state-independent emissions
    const float* __restrict__ trans,  // [5, 5] row-normalized transitions
    int* __restrict__ states,         // [B, T] decoded states
    int t_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sem = reinterpret_cast<float*>(smem);                  // [T]
  int* sst = reinterpret_cast<int*>(smem);                      // [T], after the forward pass
  uint8_t* bp = smem + (size_t)t_total * sizeof(float);         // [T, 5]
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* row = em + (size_t)b * t_total;
  for (int i = lane; i < t_total; i += 32) sem[i] = row[i];
  __syncwarp();

  // lanes 5..31 shadow state 0; their values are never read
  const int s = lane < kStates ? lane : 0;
  const float w_lo = s > 0 ? trans[(s - 1) * kStates + s] : 0.f;
  const float w_mid = trans[s * kStates + s];
  const float w_hi = s < kStates - 1 ? trans[(s + 1) * kStates + s] : 0.f;
  float v = __fmul_rn(0.2f, sem[0]);
  for (int t = 1; t < t_total; ++t) {
    const float up = __shfl_up_sync(0xffffffffu, v, 1);    // state s-1
    const float dn = __shfl_down_sync(0xffffffffu, v, 1);  // state s+1
    float best = 0.f;
    int arg = 0;
    if (s > 0) {
      const float p = __fmul_rn(up, w_lo);
      if (p > best) { best = p; arg = s - 1; }
    }
    {
      const float p = __fmul_rn(v, w_mid);
      if (p > best) { best = p; arg = s; }
    }
    if (s < kStates - 1) {
      const float p = __fmul_rn(dn, w_hi);
      if (p > best) { best = p; arg = s + 1; }
    }
    if (lane < kStates) bp[t * kStates + lane] = (uint8_t)arg;
    v = __fmul_rn(best, sem[t]);
  }
  float vs[kStates];
#pragma unroll
  for (int q = 0; q < kStates; ++q) vs[q] = __shfl_sync(0xffffffffu, v, q);
  __syncwarp();  // every lane is done with sem and bp is complete
  if (lane == 0) {
    float best = vs[0];
    int st = 0;
#pragma unroll
    for (int q = 1; q < kStates; ++q) {
      if (vs[q] > best) { best = vs[q]; st = q; }
    }
    sst[t_total - 1] = st;
    for (int t = t_total - 1; t >= 1; --t) {
      st = bp[t * kStates + st];
      sst[t - 1] = st;
    }
  }
  __syncwarp();
  int* orow = states + (size_t)b * t_total;
  for (int i = lane; i < t_total; i += 32) orow[i] = sst[i];
}

}  // namespace

// Largest T the kernel takes: T * 9 bytes of shared memory within 48 KB.
extern "C" int stratum_viterbi_max_frames() { return kSmemBytes / kBytesPerFrame; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int stratum_viterbi_decode(const void* em, const void* trans, void* states, int batch,
                                      int t_total, void* stream) {
  if (batch <= 0 || t_total <= 0 || t_total > stratum_viterbi_max_frames()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)t_total * kBytesPerFrame;
  viterbi_kernel<<<batch, 32, smem, (cudaStream_t)stream>>>(
      (const float*)em, (const float*)trans, (int*)states, t_total);
  return (int)cudaGetLastError();
}
