// Magnitudes of the direct windowed DFT of a chunk of STFT frames, written by
// hand for Hopper (sm_90a): bf16 operands on the tensor cores, f32 sums.
//
// Replaces no TPU kernel. The JAX package leaves the direct windowed DFT
// (stratum_dsp_tpu/ops/stft.py stft_magnitude_chunk) to XLA's matmul. The
// port's plain version (ops/stft.py:stft_magnitude_plain) unfolds the frames,
// rounds them to bf16, upcasts both operands to f32 because PyTorch's bf16
// matmul returns bf16, multiplies them with cuBLAS's SIMT f32 kernels, and
// takes the magnitude and the frame mask in five more passes over device
// memory. The product of two bf16 numbers is exact in f32, so a bf16 MMA with
// f32 accumulators forms the same products; only the order of the f32 sums
// differs.
//
// What it computes, for each row b and chunk frame f < n_frames:
//   frame[k]  = bf16_rn(x[b * row_stride + f * hop + k]), k < n (0 past avail)
//   re, im    = sum_k frame[k] * basis[2 j][k], sum_k frame[k] * basis[2 j + 1][k]
//   out[b, f, j] = sqrt(re * re + im * im) (each operation rounded to nearest)
// for bins j < keep, and 0 where frame0 + f lies outside [0, counts[b]).
// basis is the plain version's bf16 [n, 2 keep] cos | sin table (the window
// folded in) as columns: column 2 j is bin j's cos column, 2 j + 1 its sin
// column, so that one thread's accumulator pair of an MMA holds re and im of
// one (frame, bin); zero columns pad 2 keep to cols, a multiple of 8. It is
// stored in the order the kernel streams it (ops/stft.py:mma_basis): the
// whole 256-column tiles as [tile][k-slab][256][32], one contiguous 16 KB
// slab a step, then the ragged last tile's columns as [k-slab][rows][32];
// row r's four 16-byte chunks c at c ^ ((r >> 1) & 3).
//
// What bounds it on this card: the tensor cores. A default chunk is 40 rows
// x 256 frames of 2048 samples against 2050 columns, 86 GFLOP, 87 us at the
// 989 TFLOP/s of dense bf16; its bytes (the rows' samples read once, the
// magnitudes written once, 11 + 42 MB) take 16 us at 3.35 TB/s
// (ops/stft.py:stft_magnitude_bound_ms). With 128 frames a block the basis is
// re-read from L2 every 128 frames, and a k-slab costs a barrier and an
// mbarrier wait beside its MMAs: the kernel reaches about a fifth of the
// bound (PERF.md section 6, row S).
//
// What the design does about it:
// * A block owns BM = 32 MI consecutive frames of one row (MI = 4, 2 or 1,
//   chosen by plan among those whose samples fit in shared memory). The
//   frames overlap, so the block loads their span of samples once,
//   (BM - 1) hop + n of them, rounds
//   them to bf16 and keeps them in shared memory; every k-slab of A is then
//   an ldmatrix at row address f hop + k. The unfolded frames never exist.
//   kPad bf16 are left free after every hop samples, so that the rows of an
//   8 x 8 ldmatrix tile, hop + kPad apart, fall in eight different banks.
// * B streams through a ring of kStages slabs of [256 columns][32 k] in
//   shared memory over the flattened sequence of (column tile, k-slab) steps
//   of the block's columns, so loads run ahead across column tiles too. A
//   slab is contiguous in the table, its 16-byte chunks already XOR-swizzled
//   (conflict-free for ldmatrix), so one thread fetches it with one bulk copy
//   (cp.async.bulk, the copy engine), completing on the stage's mbarrier:
//   1024 16-byte cp.async a slab left the SM's requests, not its MMAs, to set
//   the pace.
// * Fragments are loaded one k16 half ahead of the MMAs that use them.
// * The ragged last column tile (the Nyquist bin of the full spectrum) does
//   not take a whole tile's steps: where its table fits in the stages it is
//   one bulk copy and a K split over the eight warps (tail_tile).
// * Eight warps, 2 x 4, each a (16 MI) x 64 tile of mma.sync.m16n8k16 with
//   f32 accumulators in registers. The epilogue takes the magnitudes and the
//   frame mask in registers and stores f32 straight to device memory.
// * The work follows the frames that count: an m16 tile of frames outside
//   [0, counts[b]) or past n_frames issues no MMA, and a block with none left
//   writes zeros and loads nothing (chunks past a row's end, short rows).
// * The launcher fills the card from the shapes it is given (plan): the
//   frame tile (128, 64 or 32 frames) and the split of a row's columns into
//   groups of whole 256-column tiles, the ragged last tile (the Nyquist bin)
//   with the last group, that a model of waves times work a block says is
//   quickest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kBN = 64 * kWarpsN;  // basis columns a tile: 128 bins
constexpr int kBK = 32;            // k a slab
constexpr int kStages = 4;
constexpr int kStageBytes = kBN * kBK * 2;
constexpr int kPad = 8;  // bf16 left free after every hop samples of the span
constexpr int kMaxSmem = 232448;
constexpr int kSpanAlign = 128;

struct Args {
  const float* x;
  long long row_stride;
  long long avail;  // samples readable from a row's start
  const __nv_bfloat16* basis;
  int cols;  // the basis columns that are computed: 2 keep rounded up to 8
  const long long* counts;
  long long frame0;
  float* out;
  int n_frames, n, hop, keep;
  int tiles, tiles_per_group;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void* smem_generic(uint32_t addr) {
  return __cvta_shared_to_generic(addr);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16) into shared memory, completing
// on the mbarrier `bar`, which is told to expect them.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ inline long long span_len(int bm, int n, int hop) {
  return (long long)(bm - 1) * hop + n;
}

__host__ __device__ inline long long span_phys(long long i, int hop) { return i + kPad * (i / hop); }

__host__ __device__ inline long long span_bytes(int bm, int n, int hop) {
  const long long len = span_phys(span_len(bm, n, hop) - 1, hop) + 1;
  return (2 * len + kSpanAlign - 1) / kSpanAlign * kSpanAlign;
}

// Shared memory of a block: the span, the stages, an mbarrier a stage and
// one for the ragged tile.
__host__ __device__ inline long long smem_bytes(int bm, int n, int hop) {
  return span_bytes(bm, n, hop) + (long long)kStages * kStageBytes + 8 * (kStages + 1);
}

// The table offset (in bf16) and the rows of slab kb of column tile `tile`:
// whole tiles hold 256 rows a slab; the ragged last tile, after them, its
// live rows only.
__device__ __forceinline__ long long slab_offset(const Args& a, int tile, int kb, int nk,
                                                 int* rows) {
  const int whole = a.cols / kBN;
  *rows = tile < whole ? kBN : a.cols - whole * kBN;
  return ((long long)min(tile, whole) * nk * kBN + (long long)kb * *rows) * kBK;
}

// Slab `step` of the block's flattened (tile, k-slab) sequence into its
// stage: one bulk copy (thread 0 only).
__device__ __forceinline__ void load_b(const Args& a, uint32_t stages, uint32_t bars, int t_begin,
                                       int nk, int step) {
  int rows;
  const long long off = slab_offset(a, t_begin + step / nk, step % nk, nk, &rows);
  const int st = step % kStages;
  bulk_load(stages + (uint32_t)(st * kStageBytes), a.basis + off, (uint32_t)(rows * kBK * 2),
            bars + 8u * st);
}

// i / hop for 0 <= i < 2^17 and 16 <= hop < 2^13: exact, since i hop < 2^32.
__device__ __forceinline__ int div_hop(int i, unsigned magic) { return (int)__umulhi(i, magic); }

// The block's span of samples, rounded to bf16, into shared memory: sample i
// at i + kPad (i / hop); past avail zeros. From a 16-byte aligned row (hop
// and len are multiples of 16) four samples a float4 load and an 8-byte
// store; else one sample at a time from the aligned chunks around it.
__device__ __forceinline__ void load_span(const Args& a, __nv_bfloat16* span, int b, int f0,
                                          int len, unsigned magic) {
  const float* src = a.x + (long long)b * a.row_stride + (long long)f0 * a.hop;
  const long long lim = a.avail - (long long)f0 * a.hop;
  const int d = (int)(((uintptr_t)src >> 2) & 3);
  const float4* al = reinterpret_cast<const float4*>(src - d);
  const int chunks = (len + d + 3) >> 2;
  constexpr int kUnroll = 8;
  for (int c0 = threadIdx.x; c0 < chunks; c0 += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = (c < chunks && 4LL * c - d < lim) ? __ldcs(al + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c >= chunks) continue;
      float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4LL * c - d + q >= lim) e[q] = 0.f;
      }
      if (d == 0) {
        const int i = 4 * c;
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(e[0], e[1]);
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(e[2], e[3]);
        uint2 w;
        w.x = *reinterpret_cast<const uint32_t*>(&lo2);
        w.y = *reinterpret_cast<const uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(span + i + kPad * div_hop(i, magic)) = w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * c - d + q;
          if (i >= 0 && i < len) span[i + kPad * div_hop(i, magic)] = __float2bfloat16_rn(e[q]);
        }
      }
    }
  }
}

// The ragged last column tile (tail_rows columns, a multiple of 8, whose
// [nk][tail_rows][32] table fits in the stages) of the block's BM frames:
// one bulk copy, then warp w sums the k-slabs w, w + 8, ... of every m16 tile
// and n8 tile, and the eight partial sums meet in shared memory in warp
// order. The ragged tile is the Nyquist bin of the full spectrum (8
// columns); on the main loop's path it would take a whole tile's steps.
template <int MI>
__device__ __forceinline__ void tail_tile(const Args& a, int nk, int whole, int tail_rows, int f0,
                                       int lo, int hi, uint32_t span_s, uint32_t stages,
                                       uint32_t bars, unsigned magic) {
  constexpr int MT = 2 * MI;  // m16 tiles of the block
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t bar = bars + 8u * kStages;
  __syncthreads();  // every warp is done with the stages
  if (threadIdx.x == 0) {
    bulk_load(stages, a.basis + (long long)whole * nk * kBN * kBK,
              (uint32_t)(tail_rows * a.n * 2), bar);
  }
  mbar_wait(bar, 0);
  const int t8 = tail_rows / 8;
  unsigned live = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (lo < hi && f0 + mt * 16 < hi && f0 + mt * 16 + 16 > lo) live |= 1u << mt;
  }
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = span_s + 2u * (uint32_t)(a_row * (a.hop + kPad) + (lane >> 4) * 8);
  const uint32_t a_mt = 2u * 16u * (uint32_t)(a.hop + kPad);
  // after the sums, the stages hold the partial sums [warp][BM][16] f32
  float* part = reinterpret_cast<float*>(smem_generic(stages));
  for (int j0 = 0; j0 < t8; j0 += 2) {
    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
    for (int kb = warp; kb < nk; kb += kWarps) {
      uint32_t bq[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = min(j0 + j, t8 - 1) * 8 + (lane & 7), c = lane >> 3;
        ldmatrix_x4(stages + (uint32_t)((kb * tail_rows + r) * kBK * 2 + ((c ^ ((r >> 1) & 3)) << 4)),
                    bq[j][0], bq[j][1], bq[j][2], bq[j][3]);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k = kb * kBK + ks * 16;
        const uint32_t a_k = a_lane + 2u * (uint32_t)(k + kPad * div_hop(k, magic));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!((live >> mt) & 1)) continue;
          uint32_t af[4];
          ldmatrix_x4(a_k + mt * a_mt, af[0], af[1], af[2], af[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j0 + j < t8) mma_bf16(acc[mt][j], af, bq[j][2 * ks], bq[j][2 * ks + 1]);
          }
        }
      }
    }
    __syncthreads();  // the table is read: the stages take the partial sums
    const int w = min(t8 - j0, 2) * 8;  // columns in this round
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int fr = mt * 16 + (lane >> 2) + 8 * (q >> 1), col = j * 8 + 2 * (lane & 3) + (q & 1);
          if (col < w) part[(warp * (MT * 16) + fr) * 16 + col] = acc[mt][j][q];
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < MT * 16 * (w / 2); idx += kThreads) {
      const int fr = idx / (w / 2), pair = idx % (w / 2);
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        re = __fadd_rn(re, part[(ww * (MT * 16) + fr) * 16 + 2 * pair]);
        im = __fadd_rn(im, part[(ww * (MT * 16) + fr) * 16 + 2 * pair + 1]);
      }
      const int f = f0 + fr, bin = whole * (kBN / 2) + j0 * 4 + pair;
      if (f < a.n_frames && bin < a.keep) {
        const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
        __stcs(a.out + ((long long)blockIdx.z * a.n_frames + f) * a.keep + bin,
               (f >= lo && f < hi) ? mag : 0.f);
      }
    }
    if (j0 + 2 < t8) {  // the next round reads the table again
      __syncthreads();
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_load(stages, a.basis + (long long)whole * nk * kBN * kBK,
                  (uint32_t)(tail_rows * a.n * 2), bar);
      }
      mbar_wait(bar, (uint32_t)(((j0 + 2) / 2) & 1));
    }
  }
}

template <int MI>
__global__ void __launch_bounds__(kThreads, 1) stft_magnitude_kernel(const Args a) {
  constexpr int BM = 16 * MI * kWarpsM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int b = blockIdx.z, f0 = blockIdx.y * BM;
  const int groups = gridDim.x;
  const int t_begin = blockIdx.x * a.tiles_per_group;
  const int t_end = blockIdx.x == groups - 1 ? a.tiles : t_begin + a.tiles_per_group;

  // the chunk's frames that count: [lo, hi)
  const long long cnt = a.counts[b];
  const int lo = (int)min(max(-a.frame0, 0LL), (long long)a.n_frames);
  const int hi = (int)min(max(cnt - a.frame0, 0LL), (long long)a.n_frames);
  const bool block_live = lo < hi && f0 < hi && f0 + BM > lo;
  const int wrow = wm * 16 * MI;  // the warp's first frame in the block
  unsigned live = 0;              // the warp's m16 tiles that hold a frame that counts
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r0 = f0 + wrow + mi * 16;
    if (lo < hi && r0 < hi && r0 + 16 > lo) live |= 1u << mi;
  }

  float acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  const int g = lane >> 2, tq = lane & 3;
  float* out_row = a.out + (long long)b * a.n_frames * a.keep;
  auto epilogue = [&](int tile) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int bin = tile * (kBN / 2) + wn * 32 + ni * 4 + tq;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = f0 + wrow + mi * 16 + g + 8 * h;
          if (f < a.n_frames && bin < a.keep) {
            const float re = acc[mi][ni][2 * h], im = acc[mi][ni][2 * h + 1];
            const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
            __stcs(out_row + (long long)f * a.keep + bin, (f >= lo && f < hi) ? mag : 0.f);
          }
          acc[mi][ni][2 * h] = 0.f;
          acc[mi][ni][2 * h + 1] = 0.f;
        }
      }
    }
  };

  if (!block_live) {  // uniform: nothing to compute, zeros to write
    for (int tile = t_begin; tile < t_end; ++tile) epilogue(tile);
    return;
  }

  const long long sbytes = span_bytes(BM, a.n, a.hop);
  const uint32_t span_s = smem_addr(smem);
  const uint32_t stages = smem_addr(smem + sbytes);
  const uint32_t bars = stages + (uint32_t)(kStages * kStageBytes);  // one mbarrier a stage
  const int nk = a.n / kBK;
  // the ragged last tile, where this group has it and its whole table fits
  // in the stages: one bulk copy and a K split over the warps after the loop
  const int whole = a.cols / kBN, tail_rows = a.cols - whole * kBN;
  const bool fast_tail = t_end > whole && tail_rows > 0 &&
                         (long long)tail_rows * a.n * 2 <= (long long)kStages * kStageBytes;
  const int steps = ((fast_tail ? whole : t_end) - t_begin) * nk;
  const unsigned magic = 0xffffffffu / (unsigned)a.hop + 1u;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st <= kStages; ++st) mbar_init(bars + 8u * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      if (j < steps) load_b(a, stages, bars, t_begin, nk, j);
    }
  }
  load_span(a, reinterpret_cast<__nv_bfloat16*>(smem), b, f0, (int)span_len(BM, a.n, a.hop),
            magic);
  __syncthreads();  // the span and the barriers' set-up

  // per lane: the byte address of its ldmatrix row of A at k = 0 for mi = 0,
  // and the byte offsets of its ldmatrix rows of B in a stage (by k16 and pair)
  const int a_frame = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = span_s + 2u * (uint32_t)(a_frame * (a.hop + kPad) + (lane >> 4) * 8);
  const uint32_t a_mi = 2u * 16u * (uint32_t)(a.hop + kPad);
  uint32_t b_off[kBK / 16][4];
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = wn * 64 + (2 * p + (lane >> 4)) * 8 + (lane & 7);
      const int c = ks * 2 + ((lane >> 3) & 1);
      b_off[ks][p] = (uint32_t)(r * (kBK * 2) + ((c ^ ((r >> 1) & 3)) << 4));
    }

  // fragments of two k16 halves of a slab, loaded one half ahead of the MMAs
  uint32_t af[2][MI][4], bf[2][8][2];
  auto load_frags = [&](auto buf, uint32_t stage, int kb) {
    constexpr int ks = decltype(buf)::value;
    const int k = kb * kBK + ks * 16;
    const uint32_t a_k = a_lane + 2u * (uint32_t)(k + kPad * div_hop(k, magic));
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      ldmatrix_x4(a_k + mi * a_mi, af[ks][mi][0], af[ks][mi][1], af[ks][mi][2], af[ks][mi][3]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      ldmatrix_x4(stage + b_off[ks][p], bf[ks][2 * p][0], bf[ks][2 * p][1], bf[ks][2 * p + 1][0],
                  bf[ks][2 * p + 1][1]);
    }
  };
  auto mmas = [&](auto buf, bool full, int n8) {
    constexpr int ks = decltype(buf)::value;
    if (full) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], af[ks][mi], bf[ks][ni][0], bf[ks][ni][1]);
    } else {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          if (((live >> mi) & 1) && ni < n8) {
            mma_bf16(acc[mi][ni], af[ks][mi], bf[ks][ni][0], bf[ks][ni][1]);
          }
    }
  };
  using K0 = std::integral_constant<int, 0>;
  using K1 = std::integral_constant<int, 1>;
  static_assert(kBK == 32, "two k16 halves a slab");

  if (steps > 0) {
    mbar_wait(bars, 0);
    load_frags(K0{}, stages, 0);
  }
  int tile = t_begin, kb = 0;
  for (int s = 0; s < steps; ++s) {
    const uint32_t stage = stages + (uint32_t)((s % kStages) * kStageBytes);
    const int n8 = min(max((a.cols - (tile * kBN + wn * 64)) >> 3, 0), 8);
    const bool full = live == (1u << MI) - 1 && n8 == 8;
    load_frags(K1{}, stage, kb);  // the last read of this stage
    mmas(K0{}, full, n8);
    __syncthreads();  // every warp is done with slab s: its stage takes slab s + kStages
    if (threadIdx.x == 0 && s + kStages < steps) load_b(a, stages, bars, t_begin, nk, s + kStages);
    const int next_kb = kb + 1 == nk ? 0 : kb + 1;
    if (s + 1 < steps) {
      const int st = (s + 1) % kStages;
      mbar_wait(bars + 8u * st, (uint32_t)(((s + 1) / kStages) & 1));
      load_frags(K0{}, stages + (uint32_t)(st * kStageBytes), next_kb);
    }
    mmas(K1{}, full, n8);
    if (next_kb == 0) epilogue(tile++);
    kb = next_kb;
  }
  if (fast_tail) tail_tile<MI>(a, nk, whole, tail_rows, f0, lo, hi, span_s, stages, bars, magic);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <int MI>
int launch(Args a, int rows, int groups, cudaStream_t stream) {
  constexpr int BM = 16 * MI * kWarpsM;
  const int smem = (int)smem_bytes(BM, a.n, a.hop);
  const cudaError_t err = cudaFuncSetAttribute(
      stft_magnitude_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  a.tiles_per_group = a.cols / kBN / groups;
  const dim3 grid((unsigned)groups, (unsigned)((a.n_frames + BM - 1) / BM), (unsigned)rows);
  stft_magnitude_kernel<MI><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The frame tile and the column groups for a call, from a model of its time:
// waves of blocks times a block's work, a 256-column tile costing as much as
// max(MI, 3) (below MI = 4 the basis stream, not the MMAs, sets a slab's
// pace) and the span's load 0.15 MI. Tiles whose span does not fit are
// skipped, and so is a tile of which half would still hold the chunk. Groups
// divide the whole tiles; the ragged last tile goes with the last group.
struct Plan {
  int bm, groups;
};

Plan plan(int n, int hop, int n_frames, int rows, int cols) {
  const int whole = cols / kBN;
  const double sms = (double)sm_count();
  Plan best{16 * kWarpsM, 1};
  double best_cost = 1e300;
  for (int mi = 4; mi >= 1; mi >>= 1) {
    const int bm = 16 * mi * kWarpsM;
    if (smem_bytes(bm, n, hop) > kMaxSmem) continue;
    if (mi > 1 && bm / 2 >= n_frames) continue;
    const double m_tiles = (double)((n_frames + bm - 1) / bm);
    for (int gc = 1; gc <= (whole > 1 ? whole : 1); ++gc) {
      if (whole > 1 && whole % gc) continue;
      const double tiles = whole > 0 ? (double)whole / gc : 0.25;
      const double cost = std::ceil(m_tiles * rows * gc / sms) *
                          (tiles * (mi > 3 ? mi : 3) + 0.15 * mi);
      if (cost < best_cost) {
        best_cost = cost;
        best = Plan{bm, gc};
      }
    }
  }
  return best;
}

}  // namespace

// Whether frames of n samples at hop fit the kernel: 1 where 32 of them fit
// in shared memory, else 0.
extern "C" int stratum_stft_magnitude_fits(int n, int hop) {
  return smem_bytes(16 * kWarpsM, n, hop) <= kMaxSmem;
}

// x: f32 rows (row_stride floats apart, avail samples readable a row), frame
// f of the chunk at sample f * hop; basis: bf16 [tiles][n / 32][256][32] (see
// above), cols = 2 keep rounded up to 8; counts: int64 [rows]; out: f32
// [rows, n_frames, keep]. n a multiple of 32, hop of 16.
extern "C" int stratum_stft_magnitude(const void* x, long long row_stride, long long avail,
                                      const void* basis, const void* counts, long long frame0,
                                      void* out, int rows, int n_frames, int n, int hop,
                                      int keep, void* stream) {
  const int cols = (2 * keep + 7) / 8 * 8;
  if (x == nullptr || basis == nullptr || counts == nullptr || out == nullptr || rows <= 0 ||
      n_frames <= 0 || n <= 0 || n % kBK || hop <= 0 || hop % 16 || keep <= 0 ||
      !stratum_stft_magnitude_fits(n, hop)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{(const float*)x, row_stride, avail, (const __nv_bfloat16*)basis, cols,
         (const long long*)counts, frame0, (float*)out, n_frames, n, hop, keep,
         (cols + kBN - 1) / kBN, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  const Plan p = plan(n, hop, n_frames, rows, cols);
  switch (p.bm) {
    case 128:
      return launch<4>(a, rows, p.groups, s);
    case 64:
      return launch<2>(a, rows, p.groups, s);
    default:
      return launch<1>(a, rows, p.groups, s);
  }
}
