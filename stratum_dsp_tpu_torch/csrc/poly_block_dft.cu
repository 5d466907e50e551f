// Stage 1 of the polyphase key STFT: the DFT of every hop block of a chunk,
// written by hand for Hopper (sm_90a): bf16 operands on the tensor cores, f32
// sums, bf16 results in stage 2's layout.
//
// Replaces no TPU kernel. The JAX package leaves stage 1
// (stratum_dsp_tpu/ops/stft.py polyphase_chunk_magnitudes) to XLA's matmul.
// The port's plain version (ops/stft.py:poly_block_dft_plain) slices the
// blocks, rounds them to bf16 and upcasts both operands to f32 because
// PyTorch's bf16 matmul returns bf16, multiplies them with cuBLAS's SIMT f32
// kernels, and casts the f32 product to bf16 for stage 2: five launches, and
// the f32 product written and read again. The product of two bf16 numbers is
// exact in f32, so a bf16 MMA with f32 accumulators forms the same products;
// only the order of the f32 sums differs.
//
// What it computes, for row b, block j < ebp and column c < cols = 2 kp:
//   x[j, m]     = bf16_rn(samples[b * row_stride + j * hop + m]), m < hop
//   bd[b, j, c] = bf16_rn(sum_m x[j, m] * basis[m, c])
// basis is the plain version's bf16 [hop, 2 kp] table (_poly_block_basis):
// column k < kp is cos(2 pi (m k mod n) / n), column kp + k its -sin, on the
// n-point grid. It is stored in the order the kernel streams it
// (ops/stft.py:poly_block_table): [column tile][k-slab][256 columns][64 k],
// one contiguous 32 KB slab a step, column r's eight 16-byte chunks c at
// c ^ (r & 7). The columns keep the plain table's order: stage 2 wants a
// bin's re and im kp apart, so a thread's accumulator pair is two adjacent
// columns of bd, stored as one 32-bit word.
//
// What bounds it on this card: neither roof alone. A default chunk, 40 rows of
// 240 blocks of 512 samples against 2048 columns, is 20.1 GFLOP, 20 us at the
// 989 TFLOP/s of dense bf16, against 59 MB (the f32 samples read once, 20 MB;
// the bf16 bd written once, 39 MB), 18 us at 3.35 TB/s: it sits at the ridge
// (ops/stft.py:poly_block_dft_bound_ms). With k only hop = 512 deep, a tile of
// 128 blocks x 256 columns is 34 MFLOP of MMAs against 256 KB of f32 samples
// to load and round, so the samples' load, not only the MMAs, sets a block's
// pace.
//
// What the design does about it:
// * A block owns BM = 32 MI consecutive blocks of one row (MI = 4, 2 or 1,
//   chosen by plan). It loads their BM hop samples once, rounds them to bf16
//   and keeps them in shared memory, hop + kPad apart, so that the rows of
//   an 8 x 8 ldmatrix tile fall in eight different banks. No blocks tensor
//   and no bf16 copy of the samples exists in device memory.
// * Blocks are persistent, one an SM: the work is the sequence of items
//   (row, block tile, column tile), column tiles innermost, and each block
//   takes a contiguous run of it. A block keeps its span of samples over the
//   column tiles of its run and loads a new one only where the run crosses
//   into the next block tile, at most twice at the main path's shapes; the
//   card is filled however few rows there are.
// * B streams through a ring of kStages slabs of [256 columns][64 k] over the
//   flattened (item, k-slab) steps of the block's run, so loads run ahead
//   across items and across a reload of the samples. A slab is contiguous in
//   the table, its chunks already XOR-swizzled (conflict-free for ldmatrix),
//   so one thread fetches it with one bulk copy (cp.async.bulk) completing on
//   the stage's mbarrier. 64 k a slab halve the barriers a tile takes against
//   32.
// * Fragments are loaded one k16 step ahead of the MMAs that use them.
// * Eight warps, 2 x 4, each a (16 MI) x 64 tile of mma.sync.m16n8k16 with
//   f32 accumulators in registers; an m16 tile past the row's last block
//   issues no MMA. The epilogue rounds each accumulator pair to a bf16 pair
//   and stores it straight into bd [rows, ebp, cols], where stage 2 reads it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kBN = 64 * kWarpsN;  // columns a tile
constexpr int kBK = 64;            // k a slab: 128-byte rows of eight 16-byte chunks
constexpr int kStages = 3;
constexpr int kStageBytes = kBN * kBK * 2;
constexpr int kPad = 8;  // bf16 left free after every hop samples of the span
constexpr int kMaxSmem = 232448;
constexpr int kSpanAlign = 128;

struct Args {
  const float* x;  // row 0's first block
  long long row_stride;
  long long avail;  // samples readable from a row's first block: ebp hop
  const __nv_bfloat16* basis;
  __nv_bfloat16* out;  // [rows, ebp, cols]
  int ebp, hop, cols;
  int rows, tiles, m_tiles;  // column tiles: cols / 256; block tiles a row
  long long items;           // rows x m_tiles x tiles
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

__host__ __device__ inline long long span_phys(long long i, int hop) { return i + kPad * (i / hop); }

__host__ __device__ inline long long span_bytes(int bm, int hop) {
  const long long len = span_phys((long long)bm * hop - 1, hop) + 1;
  return (2 * len + kSpanAlign - 1) / kSpanAlign * kSpanAlign;
}

// Shared memory of a block: the span, the stages, an mbarrier a stage.
__host__ __device__ inline long long smem_bytes(int bm, int hop) {
  return span_bytes(bm, hop) + (long long)kStages * kStageBytes + 8 * kStages;
}

// Slab `step` of the block's flattened (item, k-slab) sequence, from item i0
// on, into its stage: one bulk copy (thread 0 only).
__device__ __forceinline__ void load_b(const Args& a, uint32_t stages, uint32_t bars,
                                       long long i0, int nk, int step) {
  const int tile = (int)((i0 + step / nk) % a.tiles);
  const long long off = ((long long)tile * nk + step % nk) * (kBN * kBK);
  const int st = step % kStages;
  bulk_load(stages + (uint32_t)(st * kStageBytes), a.basis + off, (uint32_t)kStageBytes,
            bars + 8u * st);
}

// i / hop for 0 <= i < 2^17 and 64 <= hop < 2^13: exact, since i hop < 2^32.
__device__ __forceinline__ int div_hop(int i, unsigned magic) { return (int)__umulhi(i, magic); }

// The samples of blocks [m0, m0 + BM) of row b, rounded to bf16, into shared
// memory: sample i at i + kPad (i / hop); past the row's last block zeros.
// From a 16-byte aligned row (hop and len are multiples of 16) four samples a
// float4 load and an 8-byte store; else one sample at a time from the aligned
// chunks around it.
__device__ __forceinline__ void load_span(const Args& a, __nv_bfloat16* span, int b, int m0,
                                          int len, unsigned magic) {
  const float* src = a.x + (long long)b * a.row_stride + (long long)m0 * a.hop;
  const long long lim = a.avail - (long long)m0 * a.hop;
  const int d = (int)(((uintptr_t)src >> 2) & 3);
  const float4* al = reinterpret_cast<const float4*>(src - d);
  const int chunks = (len + d + 3) >> 2;
  constexpr int kUnroll = 8;
  for (int c0 = threadIdx.x; c0 < chunks; c0 += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = (c < chunks && 4LL * c - d < lim) ? __ldg(al + c) : make_float4(0.f, 0.f, 0.f, 0.f);
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

template <int MI>
__global__ void __launch_bounds__(kThreads, 1) poly_block_dft_kernel(const Args a) {
  constexpr int BM = 16 * MI * kWarpsM;
  extern __shared__ __align__(128) unsigned char smem[];
  // the block's run of items: [i0, i1)
  const long long i0 = a.items * blockIdx.x / gridDim.x;
  const long long i1 = a.items * (blockIdx.x + 1) / gridDim.x;
  if (i0 >= i1) return;  // uniform
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = wm * 16 * MI;  // the warp's first block in the tile
  const int nk = a.hop / kBK;
  const int steps = (int)(i1 - i0) * nk;
  const uint32_t span_s = smem_addr(smem);
  const uint32_t stages = smem_addr(smem + span_bytes(BM, a.hop));
  const uint32_t bars = stages + (uint32_t)(kStages * kStageBytes);  // one mbarrier a stage
  const unsigned magic = 0xffffffffu / (unsigned)a.hop + 1u;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8u * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      if (j < steps) load_b(a, stages, bars, i0, nk, j);
    }
  }

  float acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // per lane: the byte address of its ldmatrix row of A at k = 0 for mi = 0,
  // and of its ldmatrix rows of B in a stage: row by pair p, chunk by k16 step
  const int a_row = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = span_s + 2u * (uint32_t)(a_row * (a.hop + kPad) + (lane >> 4) * 8);
  const uint32_t a_mi = 2u * 16u * (uint32_t)(a.hop + kPad);
  uint32_t b_row[4], b_chunk[kBK / 16];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    b_row[p] = (uint32_t)((wn * 64 + (2 * p + (lane >> 4)) * 8 + (lane & 7)) * (kBK * 2));
  }
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    b_chunk[ks] = (uint32_t)(((ks * 2 + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
  }

  // fragments of k16 steps, in two buffers: step ks in buffer ks & 1
  uint32_t af[2][MI][4], bf[2][8][2];
  auto load_frags = [&](auto step, uint32_t stage, int kb) {
    constexpr int ks = decltype(step)::value, buf = ks & 1;
    const uint32_t a_k = a_lane + 2u * (uint32_t)(kb * kBK + ks * 16);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      ldmatrix_x4(a_k + mi * a_mi, af[buf][mi][0], af[buf][mi][1], af[buf][mi][2],
                  af[buf][mi][3]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      ldmatrix_x4(stage + b_row[p] + b_chunk[ks], bf[buf][2 * p][0], bf[buf][2 * p][1],
                  bf[buf][2 * p + 1][0], bf[buf][2 * p + 1][1]);
    }
  };
  unsigned live = 0;  // the warp's m16 tiles that hold a block of the row
  auto mmas = [&](auto step) {
    constexpr int buf = decltype(step)::value & 1;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!((live >> mi) & 1)) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], af[buf][mi], bf[buf][ni][0], bf[buf][ni][1]);
    }
  };
  using K0 = std::integral_constant<int, 0>;
  using K1 = std::integral_constant<int, 1>;
  using K2 = std::integral_constant<int, 2>;
  using K3 = std::integral_constant<int, 3>;
  static_assert(kBK == 64, "four k16 steps a slab");

  long long span_id = -1;
  int b = 0, m0 = 0, s = 0;
  for (long long item = i0; item < i1; ++item) {
    const long long sid = item / a.tiles;
    const int tile = (int)(item % a.tiles);
    if (sid != span_id) {  // uniform: a new block tile's samples
      span_id = sid;
      b = (int)(sid / a.m_tiles);
      m0 = (int)(sid % a.m_tiles) * BM;
      __syncthreads();  // every warp is done with the previous span (and the barriers are set)
      load_span(a, reinterpret_cast<__nv_bfloat16*>(smem), b, m0, BM * a.hop, magic);
      __syncthreads();
      live = 0;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (m0 + wrow + mi * 16 < a.ebp) live |= 1u << mi;
      }
    }
    {
      const int st = s % kStages;
      mbar_wait(bars + 8u * st, (uint32_t)((s / kStages) & 1));
      load_frags(K0{}, stages + (uint32_t)(st * kStageBytes), 0);
    }
    for (int kb = 0; kb < nk; ++kb, ++s) {
      const uint32_t stage = stages + (uint32_t)((s % kStages) * kStageBytes);
      load_frags(K1{}, stage, kb);
      mmas(K0{});
      load_frags(K2{}, stage, kb);
      mmas(K1{});
      load_frags(K3{}, stage, kb);  // the last read of this stage
      mmas(K2{});
      __syncthreads();  // every warp is done with slab s: its stage takes slab s + kStages
      if (threadIdx.x == 0 && s + kStages < steps) load_b(a, stages, bars, i0, nk, s + kStages);
      if (kb + 1 < nk) {
        const int st = (s + 1) % kStages;
        mbar_wait(bars + 8u * st, (uint32_t)(((s + 1) / kStages) & 1));
        load_frags(K0{}, stages + (uint32_t)(st * kStageBytes), kb + 1);
      }
      mmas(K3{});
    }
    // epilogue: rows past the row's last block are not stored
    __nv_bfloat16* out_b = a.out + (long long)b * a.ebp * a.cols;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = tile * kBN + wn * 64 + ni * 8 + 2 * tq;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = m0 + wrow + mi * 16 + g + 8 * h;
          if (j < a.ebp) {
            *reinterpret_cast<__nv_bfloat162*>(out_b + (long long)j * a.cols + col) =
                __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          }
          acc[mi][ni][2 * h] = 0.f;
          acc[mi][ni][2 * h + 1] = 0.f;
        }
      }
    }
  }
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
int launch(Args a, cudaStream_t stream) {
  constexpr int BM = 16 * MI * kWarpsM;
  const int smem = (int)smem_bytes(BM, a.hop);
  const cudaError_t err = cudaFuncSetAttribute(
      poly_block_dft_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  a.m_tiles = (a.ebp + BM - 1) / BM;
  a.items = (long long)a.rows * a.m_tiles * a.tiles;
  const long long blocks = a.items < sm_count() ? a.items : sm_count();
  poly_block_dft_kernel<MI><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The block tile for a call, from a model of its time: the longest run of
// items a block takes, a 256-column tile costing max(MI, 3) hop / 2048 (below
// MI = 4 the basis stream, not the MMAs, sets a slab's pace) and a load of
// the samples 0.15 MI hop / 512, loaded where the run starts and at each
// block tile it crosses into. Tiles whose samples do not fit are skipped.
int plan_bm(int hop, int ebp, int rows, int tiles) {
  int best = 0;
  double best_cost = 1e300;
  for (int mi = 4; mi >= 1; mi >>= 1) {
    const int bm = 16 * mi * kWarpsM;
    if (smem_bytes(bm, hop) > kMaxSmem) continue;
    const long long items = (long long)rows * ((ebp + bm - 1) / bm) * tiles;
    const long long blocks = items < sm_count() ? items : sm_count();
    const long long run = (items + blocks - 1) / blocks;
    const long long loads = (run - 1 + tiles - 1) / tiles + 1;
    const double cost = (double)run * (mi > 3 ? mi : 3) * hop / 2048.0 +
                        (double)loads * 0.15 * mi * hop / 512.0;
    if (cost < best_cost) {
      best_cost = cost;
      best = bm;
    }
  }
  return best;
}

}  // namespace

// Whether blocks of hop samples fit the kernel: 1 where hop is a multiple of
// 64 and 32 blocks of it fit in shared memory, else 0.
extern "C" int stratum_poly_block_dft_fits(int hop) {
  return hop >= kBK && hop % kBK == 0 && hop < (1 << 13) && smem_bytes(16 * kWarpsM, hop) <= kMaxSmem;
}

// x: f32 rows (row_stride floats apart), block j of a row at sample j * hop,
// ebp blocks readable; basis: bf16 [2 kp / 256][hop / 64][256][64] (see
// above); out: bf16 [rows, ebp, 2 kp]. kp a multiple of 128.
extern "C" int stratum_poly_block_dft(const void* x, long long row_stride, const void* basis,
                                      void* out, int rows, int ebp, int hop, int kp,
                                      void* stream) {
  if (x == nullptr || basis == nullptr || out == nullptr || rows <= 0 || ebp <= 0 || kp <= 0 ||
      (2 * kp) % kBN || !stratum_poly_block_dft_fits(hop)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{(const float*)x, row_stride, (long long)ebp * hop, (const __nv_bfloat16*)basis,
         (__nv_bfloat16*)out, ebp, hop, 2 * kp, rows, 2 * kp / kBN, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (plan_bm(hop, ebp, rows, a.tiles)) {
    case 128:
      return launch<4>(a, s);
    case 64:
      return launch<2>(a, s);
    default:
      return launch<1>(a, s);
  }
}
