// Greedy downbeat walk, written by hand for Hopper (sm_90a).
//
// Replaces: stratum_dsp_tpu/ops/downbeats_pallas.py:downbeat_mask (Pallas
// body _downbeat_kernel), the TPU form of features/beat/grid.py
// detect_downbeats.
//
// What it computes, per track: over the compacted ascending beat times, the
// first valid beat is a downbeat, and a later beat is one iff
// |t - (last_downbeat + bar)| <= 0.1 * bar. The expressions keep the order of
// the reference scan (tol = bar * 0.1f, fabsf(t - (last + bar)) <= tol) with
// no FMA contraction, so the mask is bit-exact against it.
//
// What bounds it on this card: latency. A batch is a few hundred KB, so the
// byte bound is a fraction of a microsecond; what takes time is the walk's
// dependent chain, and under it the launch itself.
//
// What the design does about it: the test of a slot depends on the walk only
// through `last`, and `last` changes only at a downbeat. So the next downbeat
// is the first later valid slot that passes the test against the current
// `last`, and the walk splits into a part that is parallel and a chain that
// is short. One block of sixteen warps per track:
//  1. the warps stage the first n_beats times into shared memory with
//     coalesced loads;
//  2. windows of 32 slots are shared out over the warps. For its window a
//     warp computes, for each slot i as if it were the last downbeat, the
//     first later slot of the window that passes the test against it (the
//     very same three roundings on (t_j, t_i), 31 shuffles), and then, by
//     pointer doubling over these successors (5 rounds of two shuffles,
//     exact integer work), the set of all slots of the window that the walk
//     marks once it has marked slot i, and with it `last + bar` for the
//     highest slot of that set: what the walk looks for after this window;
//  3. warp 0 walks window by window, each lane holding its own slot's time,
//     set and `last + bar` in registers, loaded one window ahead: the lanes
//     test the window's 32 slots against the last downbeat and vote, and the
//     first that passes hands its set and the next target to all lanes by
//     two shuffles. The chain is one vote and one shuffle per window of 32
//     slots, bounded by n_beats, instead of one step per slot of the row,
//     with no shared-memory load on it. The other warps zero the slots past
//     n_beats.
// Nothing relies on the times being sorted: every window up to n_beats is
// scanned, and a window's successors are looked for in the whole window.

#include <cuda_runtime.h>
#include <stdint.h>

// Built with -DSTRATUM_PROBE (scripts/torch_port_bench.py probe), thread 0 of
// each block stamps the SM's clock at the phase boundaries: a timer around the
// launch cannot tell the phases of a kernel that is bound by latency apart,
// and the stamps need no profiler. Without the flag STAMP is nothing.
#ifdef STRATUM_PROBE
__device__ long long g_probe_downbeat[64][8];
#define STAMP(k) \
  if (threadIdx.x == 0) g_probe_downbeat[blockIdx.x & 63][k] = clock64();
extern "C" int stratum_probe_downbeat(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe_downbeat, sizeof(g_probe_downbeat));
}
#else
#define STAMP(k)
#endif

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 227 * 1024;
// shared bytes per slot: its time, its set, and last + bar after its set
constexpr int kBytesPerSlot = 12;

__global__ void __launch_bounds__(kThreads) downbeat_mask_kernel(
    const float* __restrict__ times,    // [B, N] compacted ascending
    const int* __restrict__ n_beats,    // [B]
    const float* __restrict__ bar,      // [B] bar length in seconds
    uint8_t* __restrict__ out,          // [B, N] 0/1
    int n) {
  extern __shared__ float st[];                              // [N] times
  unsigned* marks = reinterpret_cast<unsigned*>(st + n);     // [N] sets of step 2
  float* after = reinterpret_cast<float*>(marks + n);        // [N] last + bar after that set
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  STAMP(0)
  const int nb = max(0, min(n_beats[b], n));
  const int windows = (nb + 31) >> 5;            // windows that hold a valid slot
  const int walked = min(n, windows << 5);       // slots the walking warp writes
  const float* row = times + (size_t)b * n;
  uint8_t* orow = out + (size_t)b * n;
  const float bb = bar[b];
  const float tol = __fmul_rn(bb, 0.1f);
  for (int i = tid; i < walked; i += kThreads) st[i] = row[i];
  __syncthreads();
  STAMP(1)  // staged

  for (int w = warp; w < windows; w += kWarps) {
    const int idx = (w << 5) + lane;
    const float t = idx < walked ? st[idx] : 0.f;
    const float target = __fadd_rn(t, bb);       // last + bar, were this slot the last downbeat
    // the slots a successor may be: valid (below n_beats) and later than this one
    const int valid = nb - (w << 5);
    const unsigned may = (valid >= 32 ? kFull : (1u << valid) - 1u) & ~((2u << lane) - 1u);
    unsigned later = 0;                          // the later slots that pass against this one
#pragma unroll
    for (int j = 1; j < 32; ++j) {
      const float tj = __shfl_sync(kFull, t, j);
      if (fabsf(__fsub_rn(tj, target)) <= tol) later |= 1u << j;
    }
    later &= may;
    // next: the first of them, the downbeat after this one (32: none in this
    // window); set: the slots marked from this one on, doubled five times
    int next = later != 0 ? __ffs(later) - 1 : 32;
    unsigned set = 1u << lane;
#pragma unroll
    for (int round = 0; round < 5; ++round) {
      const unsigned set_there = __shfl_sync(kFull, set, next & 31);
      const int next_there = __shfl_sync(kFull, next, next & 31);
      if (next < 32) {
        set |= set_there;
        next = next_there;
      }
    }
    // the set holds this slot itself, so it has a highest slot: the last
    // downbeat once the walk has marked the set
    const float t_top = __shfl_sync(kFull, t, 31 - __clz(set));
    if (idx < walked) {
      marks[idx] = set;
      after[idx] = __fadd_rn(t_top, bb);
    }
  }
  __syncthreads();
  STAMP(2)  // successor sets
  if (warp != 0) {
    // no slot at or past n_beats is a downbeat
    for (int i = walked + tid - 32; i < n; i += kThreads - 32) orow[i] = 0;
    return;
  }
  if (windows == 0) return;

  // Slot 0 is valid here: it is the first downbeat, window 0 is its set, and
  // the walk goes on from the target after that set. From window 1 on every
  // slot lies past the last downbeat, which is in an earlier window, so the
  // vote needs no comparison of slots.
  if (lane < n) orow[lane] = (marks[0] >> lane) & 1u;
  float target = after[0];                       // last + bar
  float t = 0.f, my_after = 0.f;                 // this lane's slot of window 1
  unsigned my_set = 0;
  if (32 + lane < walked) {
    t = st[32 + lane];
    my_set = marks[32 + lane];
    my_after = after[32 + lane];
  }
  for (int w = 1; w < windows; ++w) {
    const int idx = (w << 5) + lane;
    float t_next = 0.f, after_next = 0.f;
    unsigned set_next = 0;
    if (idx + 32 < walked) {
      t_next = st[idx + 32];
      set_next = marks[idx + 32];
      after_next = after[idx + 32];
    }
    // the first slot of this window that passes against the last downbeat
    // hands its set and the target after it to every lane (some lane's,
    // unused, where none passes)
    const unsigned votes = __ballot_sync(kFull, idx < nb && fabsf(__fsub_rn(t, target)) <= tol);
    const int first = __ffs(votes) - 1;
    const unsigned set_there = __shfl_sync(kFull, my_set, first & 31);
    const float after_there = __shfl_sync(kFull, my_after, first & 31);
    const unsigned set = votes != 0 ? set_there : 0u;
    target = votes != 0 ? after_there : target;
    if (idx < n) orow[idx] = (set >> lane) & 1u;
    t = t_next;
    my_set = set_next;
    my_after = after_next;
  }
  STAMP(3)  // walk
}

}  // namespace

// Largest N the kernel takes: N * 12 bytes of shared memory within 227 KB.
extern "C" int stratum_downbeat_max_slots() { return kMaxSmemBytes / kBytesPerSlot; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int stratum_downbeat_mask(const void* times, const void* n_beats, const void* bar,
                                     void* out, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n > stratum_downbeat_max_slots()) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)n * kBytesPerSlot;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        downbeat_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  downbeat_mask_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)times, (const int*)n_beats, (const float*)bar, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
