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
// What bounds it on this card: latency. The batch is ~40 x 1024 x 4 B each
// way, so the byte bound is a fraction of a microsecond. The forward pass is
// a chain that no reassociation shortens exactly (f32 products round), and
// under it stands the launch itself.
//
// What the design does about it, one warp per track:
//  * Forward: lane 0 holds the probabilities in registers, with no shuffle
//    and no barrier in a step. The transition table is mirror-symmetric
//    (trans[p][s] == trans[4-p][4-s], which the wrapper checks), the prior is
//    uniform and the emissions do not depend on the state, so v_t[s] ==
//    v_t[4-s] bit for bit at every frame: states 3 and 4 take the maxima of
//    the same products as states 1 and 0. The chain therefore carries three
//    values, and a step is 10 multiplies and 7 maxima (the winning value of
//    a strict `>` chain from 0 is the maximum of the candidates and 0),
//    eight frames a round with their emissions loaded ahead. It writes v_t
//    to shared memory and leaves the backpointers to the second phase.
//  * It ends early, exactly: once the probabilities are all 0 they stay 0,
//    every later backpointer is state 0 and so is every state from the last
//    walked frame on. The two phases below then work on the walked frames
//    only, and the rest of the row is written as 0. (Products round to
//    nearest, so only a factor below 1/2 a frame leaves the smallest
//    denormal: rows of emissions near 1 never end early.)
//  * Backpointers: every frame's five backpointers depend on v_{t-1} only,
//    so the 32 lanes compute them in parallel from the stored v with the
//    reference's compare chain and pack them, 3 bits a state, into one
//    16-bit word a frame.
//  * Backtrack: a frame's backpointers are a map {0..4} -> {0..4}, and
//    composing maps is exact and associative. Each lane composes the maps of
//    its run of frames, a 5-step shuffle scan composes the runs from the
//    last frame down, and each lane replays its run from its entry state:
//    ~100 dependent steps in place of T - 1 dependent shared-memory loads.
//  * Emissions come in and states go out through shared memory with
//    coalesced accesses.

#include <cuda_runtime.h>
#include <stdint.h>

// Built with -DSTRATUM_PROBE (scripts/torch_port_bench.py probe), lane 0 of
// each block stamps the SM's clock at the phase boundaries of viterbi_kernel
// (see downbeat_mask.cu). Without the flag STAMP is nothing.
#ifdef STRATUM_PROBE
__device__ long long g_probe_viterbi[64][8];
#define STAMP(k) \
  if (threadIdx.x == 0) g_probe_viterbi[blockIdx.x & 63][k] = clock64();
extern "C" int stratum_probe_viterbi(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe_viterbi, sizeof(g_probe_viterbi));
}
#else
#define STAMP(k)
#endif

namespace {

constexpr int kStates = 5;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 227 * 1024;
// shared bytes per frame: v_t[0..2] in a float4, the emission (later the
// decoded state), the packed backpointers
constexpr int kBytesPerFrame = 16 + 4 + 2;
// the identity map, state s in bits [3s, 3s + 3)
constexpr unsigned kIdentity = 0u | (1u << 3) | (2u << 6) | (3u << 9) | (4u << 12);

__device__ __forceinline__ unsigned apply_map(unsigned map, unsigned s) {
  return (map >> (3u * s)) & 7u;
}

// x -> f(g(x))
__device__ __forceinline__ unsigned compose(unsigned f, unsigned g) {
  unsigned out = 0;
#pragma unroll
  for (unsigned s = 0; s < kStates; ++s) out |= apply_map(f, apply_map(g, s)) << (3u * s);
  return out;
}

// The backtrack by one warp. `bp[t]` maps the state at frame t to the state
// at frame t - 1 (t in 1..T-1; bp[0] is not read); `final_state` is the
// state at frame T - 1. Writes the states of frames 0..T-1 to `sst`.
__device__ void backtrack_scan(const uint16_t* bp, int t_total, unsigned final_state, int* sst,
                               int lane) {
  // lane L owns frames [L * run, (L + 1) * run); an odd run keeps the lanes'
  // shared-memory accesses in different banks. Maps of frames >= T are the
  // identity, so the state "at" any such frame is the final state.
  const int run = ((t_total + 31) >> 5) | 1;
  const int lo = lane * run;
  unsigned f = kIdentity;  // state at frame lo + run  ->  state at frame lo
  for (int t = lo + 1; t <= lo + run; ++t) {
    if (t < t_total) f = compose(f, bp[t]);
  }
  // suffix scan: g = f_L o f_{L+1} o ... o f_31
  unsigned g = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned other = __shfl_down_sync(kFull, g, d);
    if (lane + d < 32) g = compose(g, other);
  }
  const unsigned above = __shfl_down_sync(kFull, g, 1);
  unsigned s = lane == 31 ? final_state : apply_map(above, final_state);  // at frame lo + run
  for (int t = lo + run; t > lo; --t) {
    if (t < t_total) s = apply_map(bp[t], s);
    if (t - 1 < t_total) sst[t - 1] = (int)s;
  }
}

__global__ void __launch_bounds__(32) viterbi_kernel(
    const float* __restrict__ em,     // [B, T] state-independent emissions
    const float* __restrict__ trans,  // [5, 5] row-normalized transitions
    int* __restrict__ states,         // [B, T] decoded states
    int t_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sv = reinterpret_cast<float4*>(smem);                   // [T] v_t of states 0..2
  float* sem = reinterpret_cast<float*>(sv + t_total);            // [T]
  int* sst = reinterpret_cast<int*>(sem);                         // [T], after the forward pass
  uint16_t* bp = reinterpret_cast<uint16_t*>(sem + t_total);      // [T]
  const int b = blockIdx.x, lane = threadIdx.x;
  STAMP(0)
  const float* row = em + (size_t)b * t_total;
  for (int i = lane; i < t_total; i += 32) sem[i] = row[i];
  // w_lo[s] = trans[s-1][s], w_mid[s] = trans[s][s], w_hi[s] = trans[s+1][s]
  float w_lo[kStates], w_mid[kStates], w_hi[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    w_lo[s] = s > 0 ? trans[(s - 1) * kStates + s] : 0.f;
    w_mid[s] = trans[s * kStates + s];
    w_hi[s] = s < kStates - 1 ? trans[(s + 1) * kStates + s] : 0.f;
  }
  __syncwarp();
  STAMP(1)  // staged

  // forward, lane 0: frames [0, stored) get their v_t written
  int stored = 0;
  unsigned final_state = 0;
  if (lane == 0) {
    float v0 = __fmul_rn(0.2f, sem[0]), v1 = v0, v2 = v0;  // v_t[3] == v1, v_t[4] == v0
    auto step = [&](int t, float e) {
      const float n0 = fmaxf(fmaxf(__fmul_rn(v0, w_mid[0]), __fmul_rn(v1, w_hi[0])), 0.f);
      const float n1 = fmaxf(fmaxf(__fmul_rn(v0, w_lo[1]), __fmul_rn(v1, w_mid[1])),
                             fmaxf(__fmul_rn(v2, w_hi[1]), 0.f));
      // state 2's third candidate, v_t[3] * trans[3][2], is its first again
      const float n2 = fmaxf(fmaxf(__fmul_rn(v1, w_lo[2]), __fmul_rn(v2, w_mid[2])), 0.f);
      v0 = __fmul_rn(n0, e);
      v1 = __fmul_rn(n1, e);
      v2 = __fmul_rn(n2, e);
      sv[t] = make_float4(v0, v1, v2, 0.f);
    };
    sv[0] = make_float4(v0, v1, v2, 0.f);
    int t = 1;
    for (; t < t_total && (t & 7) != 0; ++t) step(t, sem[t]);
    // eight frames a round, their emissions loaded ahead of the chain
    bool live = true;
    for (; live && t + 8 <= t_total; t += 8) {
      const float4 ea = *reinterpret_cast<const float4*>(sem + t);
      const float4 eb = *reinterpret_cast<const float4*>(sem + t + 4);
      step(t, ea.x);
      step(t + 1, ea.y);
      step(t + 2, ea.z);
      step(t + 3, ea.w);
      step(t + 4, eb.x);
      step(t + 5, eb.y);
      step(t + 6, eb.z);
      step(t + 7, eb.w);
      // all at 0: no later product is above 0, so every later backpointer
      // and the final state are state 0
      live = v0 != 0.f || v1 != 0.f || v2 != 0.f;
    }
    if (live) {
      for (; t < t_total; ++t) step(t, sem[t]);
    }
    stored = t;
    // the first maximum of (v0, v1, v2, v1, v0)
    float top = v0;
    if (v1 > top) { top = v1; final_state = 1; }
    if (v2 > top) final_state = 2;
  }
  stored = __shfl_sync(kFull, stored, 0);
  final_state = __shfl_sync(kFull, final_state, 0);
  __syncwarp();  // v_t is complete
  STAMP(2)  // forward

  // Frames [stored, T) follow all-zero probabilities: their backpointers
  // all point to state 0 and the final state is 0, so the states of frames
  // stored - 1 .. T - 1 are 0 and the decode of frames [0, stored) is a
  // decode that ends in `final_state` (0 in that case) at frame stored - 1.

  // backpointers, all lanes: frame t from v_{t-1}
  for (int t = 1 + lane; t < stored; t += 32) {
    const float4 q = sv[t - 1];
    const float p[kStates] = {q.x, q.y, q.z, q.y, q.x};
    unsigned packed = 0;
#pragma unroll
    for (int s = 0; s < kStates; ++s) {
      float top = 0.f;
      unsigned arg = 0;
      if (s > 0) {
        const float c = __fmul_rn(p[s - 1], w_lo[s]);
        if (c > top) { top = c; arg = s - 1; }
      }
      {
        const float c = __fmul_rn(p[s], w_mid[s]);
        if (c > top) { top = c; arg = s; }
      }
      if (s < kStates - 1) {
        const float c = __fmul_rn(p[s + 1], w_hi[s]);
        if (c > top) { top = c; arg = s + 1; }
      }
      packed |= arg << (3u * s);
    }
    bp[t] = (uint16_t)packed;
  }
  __syncwarp();  // bp is complete, and every lane is done with sem
  STAMP(3)  // backpointers

  backtrack_scan(bp, stored, final_state, sst, lane);
  __syncwarp();
  STAMP(4)  // backtrack
  int* orow = states + (size_t)b * t_total;
  for (int i = lane; i < t_total; i += 32) orow[i] = i < stored ? sst[i] : 0;
  STAMP(5)  // written out
}

// The backtrack alone, on given packed backpointers: what the tests hold
// against a plain backtrack on maps that real emissions cannot produce.
__global__ void __launch_bounds__(32) backtrack_kernel(
    const uint16_t* __restrict__ packed,   // [B, T]
    const int* __restrict__ final_states,  // [B]
    int* __restrict__ states,              // [B, T]
    int t_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sst = reinterpret_cast<int*>(smem);                        // [T]
  uint16_t* bp = reinterpret_cast<uint16_t*>(sst + t_total);      // [T]
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < t_total; i += 32) bp[i] = packed[(size_t)b * t_total + i];
  __syncwarp();
  backtrack_scan(bp, t_total, (unsigned)final_states[b], sst, lane);
  __syncwarp();
  for (int i = lane; i < t_total; i += 32) states[(size_t)b * t_total + i] = sst[i];
}

}  // namespace

// Largest T the kernels take: T * 22 bytes of shared memory within 227 KB.
extern "C" int stratum_viterbi_max_frames() { return kMaxSmemBytes / kBytesPerFrame; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int stratum_viterbi_decode(const void* em, const void* trans, void* states, int batch,
                                      int t_total, void* stream) {
  if (batch <= 0 || t_total <= 0 || t_total > stratum_viterbi_max_frames()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)t_total * kBytesPerFrame;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  viterbi_kernel<<<batch, 32, smem, (cudaStream_t)stream>>>(
      (const float*)em, (const float*)trans, (int*)states, t_total);
  return (int)cudaGetLastError();
}

// The backtrack of `stratum_viterbi_decode` on packed backpointers [B, T]
// (uint16, state s of frame t in bits [3s, 3s + 3)) and final states [B].
extern "C" int stratum_viterbi_backtrack(const void* packed, const void* final_states,
                                         void* states, int batch, int t_total, void* stream) {
  if (batch <= 0 || t_total <= 0 || (size_t)t_total * 6 > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  backtrack_kernel<<<batch, 32, (size_t)t_total * 6, (cudaStream_t)stream>>>(
      (const uint16_t*)packed, (const int*)final_states, (int*)states, t_total);
  return (int)cudaGetLastError();
}
