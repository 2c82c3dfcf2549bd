// One fused LSTM step for Hopper (sm_90a), f32 and bf16, on the tensor
// cores (wgmma) with TMA loads.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py::_lstm_cell_kernel
// (launched by _lstm_cell_pallas). Same function, gate order (c, i, f, o):
//   g = xg + r_prev @ w                       xg [B, 4H], r_prev [B, H],
//   c = tanh(g_c) * sigmoid(g_i)                 w [H, 4H], c_prev [B, H]
//       + c_prev * sigmoid(g_f)
//   h = sigmoid(g_o) * tanh(c)
// The recurrent product and the gates are computed here, in one kernel:
// the [B, 4H] gate pre-activations never leave the SM.
//
// What bounds it on this card. At the sequence path's shape (B 256, H 512)
// the product is 2*B*H*4H = 0.54 GFLOP. f32 runs it as three TF32 products
// (below): 1.61 GFLOP at the tensor cores' 495 TFLOP/s, 3.3 us, against
// 8.4 MB of operands moved once (w is 4 MB of them), 2.5 us at 3.35 TB/s,
// so the operations bound it. bf16: 0.54 GFLOP at 989 TFLOP/s is 0.5 us,
// its 5.8 MB 1.7 us: the bytes bound it.
//
// Design:
//   * The product is taken transposed, g^T = w^T r^T: the 4H gate columns
//     are wgmma's M side, the batch its N side (8, 16, 32 or 64 rows of
//     B a block, chosen from B and H by the launcher), H its depth. A
//     block's 64 M rows are 16 hidden units u0.. of each gate (row 16q +
//     u: warp q of a warpgroup holds gate q), so all four gates of a
//     unit come out of one block; they meet in shared memory after the
//     products, and c and h are written once.
//   * Why this way round: a tf32 wgmma reads its shared-memory operands
//     K-major only, and w [H, 4H] has its gate columns contiguous, not H.
//     As the A operand, w is taken from registers, which any layout can
//     feed: each thread reads its fragment from the staged tile of w.
//     r_prev [B, H] is K-major as it is and is wgmma's B operand from
//     shared memory. The batch on N serves B 1 (N 8) and 32 without
//     padding to 64 rows, and w needs no per-scan copy.
//   * f32 with f32 accuracy (CUTLASS's "fast accurate f32"): each operand
//     is split as x_hi = tf32(x), x_lo = tf32(x - x_hi), both rounded to
//     nearest (cvt.rna), and the product is w_lo r_hi + w_hi r_lo + w_hi
//     r_hi, the small terms summed over a chunk in an accumulator of their
//     own, w_hi r_hi over one k-step (two at 64 batch rows), because the
//     tensor cores' f32 adds truncate; these sums are added to the f32
//     result on the CUDA cores (chunk()). The
//     dropped w_lo r_lo is about 2^-22 of each product. w is split in
//     registers as its fragments are read; r_prev in shared memory, once
//     a tile (r_hi over the loaded tile, r_lo beside it).
//   * bf16 (r_prev and w both bf16): one product, bf16 in, f32 accumulate;
//     w's fragments are packed from the staged tile as they are.
//   * Loads by TMA: per K chunk of 128 bytes of depth (32 f32 or 64 bf16),
//     one 2-d box of r_prev (N rows, 128-byte swizzle, as wgmma's K-major
//     descriptor reads it) and one 3-d box of w, which views w [H, 4H] as
//     [gate][depth][unit] and brings the chunk's four gate slices of the
//     block's 16 units at once. They fill a ring of stages that one thread
//     of a producer warpgroup keeps ahead (setmaxnreg gives the others'
//     registers to the consumers) and two consumer warpgroups free, each
//     taking every other chunk with sums of its own, added in a fixed
//     order at the end: one prepares its chunk (the splits, w's
//     fragments) while the other's products run. The epilogue's xg and
//     c_prev are read before the first chunk, so that their latency hides
//     behind the products.
//   * No K split and no atomics: every call gives the same bits.
//   * xg and c_prev are read as f32 (the wrapper upcasts, losslessly); h
//     and c are written in f32 or bf16, as the caller asks; the gate math
//     is f32.
//   * Any B and H: rows of r_prev past B and depth past H are zero-filled
//     by TMA, units past H are not stored; where H is not a multiple of 8
//     the wrapper pads r_prev and w to Hp (the maps need 16-byte row
//     strides) with zeros, which add nothing. xg may have a row stride (a
//     time step of a [B, T, 4H] sequence).
// The kernel launches on the caller's stream and allocates nothing.

#include <atomic>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kUnits = 16;                 // hidden units a block
constexpr int kWg = 128;                   // threads of a warpgroup
constexpr int kConsumers = 2 * kWg;        // two warpgroups: the products
constexpr int kThreads = kConsumers + kWg; // and a producer warpgroup
// registers a thread after setmaxnreg: the producer's one working thread
// needs few, the consumers' sums and fragments many (at 64 batch rows,
// f32 spills under the 168 that 384 threads get at launch)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWBox = 2048;                // bytes of one gate's slice of w
constexpr int kDPitch = 4 * kUnits + 4;    // floats a batch row of sD

struct Params {
  CUtensorMap tr;  // r_prev [B, Hp]: box of 128 bytes x N rows, swizzled
  CUtensorMap tw;  // w as [gate][depth][unit]: box of 4 x chunk x 16
  const float* xg;
  long long ld_xg;  // row stride of xg, in elements
  const float* c_prev;
  void* h;
  void* c;
  int B;
  int H;
  int Hp;  // r_prev's and w's depth (H, or H padded to a multiple of 8)
  int h_bf16;
  int c_bf16;
};

// Shared memory of one block, in bytes from a 1024-aligned base: the
// ring's stages (r_prev's tile, f32: r_lo's tile, w's four gate slices),
// then the products' tile sD [N][kDPitch] f32, then the mbarriers.
template <bool F32, int N>
struct Geo {
  static constexpr int kChunk = F32 ? 32 : 64;   // depth a stage
  static constexpr int kR = N * 128;             // r_prev's tile
  static constexpr int kLo = F32 ? kR : 0;       // r_lo's tile
  static constexpr int kW = kR + kLo;            // w's boxes
  static constexpr int kStage = kW + 4 * kWBox;
  // w's slices in a stage, [gate][depth][unit]: elements between depth
  // rows and between gates
  static constexpr int kWRow = kUnits, kWGate = kChunk * kUnits;
  static constexpr int kStages = N <= 32 ? 8 : 4;  // even: see cell_body
  // f32: k-steps of 8 that one accumulator of w_hi r_hi spans before its
  // sum joins the f32 result (see chunk()): one, or two at 64 batch rows,
  // where four accumulators a chunk would not fit the registers
  static constexpr int kBigSteps = F32 && N > 32 ? 2 : 1;
  static constexpr int kBigs = F32 ? 4 / kBigSteps : 1;
  static constexpr int kD = kStages * kStage;
  static constexpr int kBars = kD + N * kDPitch * 4;
  static constexpr int kTotal = kBars + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// The epilogue's inputs of one (row b, unit j): xg's four gate columns
// and c_prev, read before the products so that their latency hides
// behind them (zeros past B or H).
struct Inputs {
  float x[4];
  float c;
};

__device__ __forceinline__ Inputs load_inputs(const Params& p, int b,
                                              int j) {
  Inputs in = {{0.f, 0.f, 0.f, 0.f}, 0.f};
  if (b < p.B && j < p.H) {
    const float* x = p.xg + (long)b * p.ld_xg + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.x[q] = x[(long)q * p.H];
    in.c = p.c_prev[(long)b * p.H + j];
  }
  return in;
}

// The gates of unit j of row b, from its four accumulated products.
__device__ __forceinline__ void finish(const Params& p, int b, int j,
                                       const Inputs& in, float gc, float gi,
                                       float gf, float go) {
  gc += in.x[0];
  gi += in.x[1];
  gf += in.x[2];
  go += in.x[3];
  const long o = (long)b * p.H + j;
  const float c = tanhf(gc) * sigmoid_f(gi) + in.c * sigmoid_f(gf);
  const float h = sigmoid_f(go) * tanhf(c);
  if (p.h_bf16) {
    static_cast<bf16*>(p.h)[o] = __float2bfloat16(h);
  } else {
    static_cast<float*>(p.h)[o] = h;
  }
  if (p.c_bf16) {
    static_cast<bf16*>(p.c)[o] = __float2bfloat16(c);
  } else {
    static_cast<float*>(p.c)[o] = c;
  }
}

// one box of a 3-d tensor map into shared memory, completed on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma with A from registers, B from shared memory (K-major) ----------
// d += A B for one m64nNk8 (tf32) or m64nNk16 (bf16) step; d is the
// m16n8 C layout per warp (hopper.cuh). A's fragment: tf32, a[0..3] =
// (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); bf16, the
// m16n8k16 layout, k pairs packed low first.
#define LSTM_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define LSTM_A \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)
#define LSTM_P(i) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #i ", 0;\n"

template <bool F32, int N>
__device__ __forceinline__ void wgmma_a_reg(float (&d)[N / 2],
                                            const uint32_t* a, uint64_t db,
                                            int scale_d);

#define LSTM_WG_N8(TYPE, K, TAIL)                                        \
  template <>                                                           \
  __device__ __forceinline__ void wgmma_a_reg<TYPE, 8>(                 \
      float (&d)[4], const uint32_t* a, uint64_t db, int scale_d) {           \
    asm volatile(LSTM_P(9) "wgmma.mma_async.sync.aligned.m64n8" K             \
                 " {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1" TAIL \
                 ";\n}\n"                                                  \
                 : LSTM_D4(0)                                           \
                 : LSTM_A);                                             \
  }
#define LSTM_WG_N16(TYPE, K, TAIL)                                       \
  template <>                                                           \
  __device__ __forceinline__ void wgmma_a_reg<TYPE, 16>(                \
      float (&d)[8], const uint32_t* a, uint64_t db, int scale_d) {           \
    asm volatile(LSTM_P(13) "wgmma.mma_async.sync.aligned.m64n16" K           \
                 " {%0, %1, %2, %3, %4, %5, %6, %7},"                   \
                 " {%8, %9, %10, %11}, %12, p, 1, 1" TAIL ";\n}\n"         \
                 : LSTM_D4(0), LSTM_D4(4)                               \
                 : LSTM_A);                                             \
  }
#define LSTM_WG_N32(TYPE, K, TAIL)                                       \
  template <>                                                           \
  __device__ __forceinline__ void wgmma_a_reg<TYPE, 32>(                \
      float (&d)[16], const uint32_t* a, uint64_t db, int scale_d) {          \
    asm volatile(LSTM_P(21) "wgmma.mma_async.sync.aligned.m64n32" K           \
                 " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"  \
                 " %12, %13, %14, %15}, {%16, %17, %18, %19}, %20,"     \
                 " p, 1, 1" TAIL ";\n}\n"                                  \
                 : LSTM_D4(0), LSTM_D4(4), LSTM_D4(8), LSTM_D4(12)      \
                 : LSTM_A);                                             \
  }
#define LSTM_WG_N64(TYPE, K, TAIL)                                       \
  template <>                                                           \
  __device__ __forceinline__ void wgmma_a_reg<TYPE, 64>(                \
      float (&d)[32], const uint32_t* a, uint64_t db, int scale_d) {          \
    asm volatile(LSTM_P(37) "wgmma.mma_async.sync.aligned.m64n64" K           \
                 " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"  \
                 " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21,"   \
                 " %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"  \
                 " {%32, %33, %34, %35}, %36, p, 1, 1" TAIL ";\n}\n"       \
                 : LSTM_D4(0), LSTM_D4(4), LSTM_D4(8), LSTM_D4(12),     \
                   LSTM_D4(16), LSTM_D4(20), LSTM_D4(24), LSTM_D4(28)   \
                 : LSTM_A);                                             \
  }
// scale_d 0 overwrites d; bf16 takes B's transpose flag too (0: K-major)
#define LSTM_WG_ALL(TYPE, K, TAIL) \
  LSTM_WG_N8(TYPE, K, TAIL)        \
  LSTM_WG_N16(TYPE, K, TAIL)       \
  LSTM_WG_N32(TYPE, K, TAIL)       \
  LSTM_WG_N64(TYPE, K, TAIL)
LSTM_WG_ALL(true, "k8.f32.tf32.tf32", "")
LSTM_WG_ALL(false, "k16.f32.bf16.bf16", ", 0")
#undef LSTM_WG_ALL
#undef LSTM_WG_N64
#undef LSTM_WG_N32
#undef LSTM_WG_N16
#undef LSTM_WG_N8
#undef LSTM_A
#undef LSTM_P
#undef LSTM_D4

// w's fragments of one stage: 4 k-steps of (f32) hi[4] and lo[4], or
// (bf16) 4 packed registers
template <bool F32>
struct Frag {
  uint32_t v[4][F32 ? 8 : 4];
};

template <bool F32>
__device__ __forceinline__ void fence_frag(Frag<F32>& f) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < (F32 ? 8 : 4); ++e)
      asm volatile("" : "+r"(f.v[k][e])::"memory");
}

// Chunk i's stage has arrived: (f32) split r_prev's tile into r_hi (in
// place) and r_lo, and make the tile visible to wgmma; read w's fragments
// for this thread (warp q of the warpgroup: gate q, units g and g + 8),
// split (f32) or packed (bf16). tid: the thread in warpgroup wg.
template <bool F32, int N>
__device__ __forceinline__ void prepare(unsigned char* stage, uint64_t* full,
                                        int i, Frag<F32>& f, int tid,
                                        int wg) {
  using G = Geo<F32, N>;
  mbar_wait(full, (i / G::kStages) & 1);
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if constexpr (F32) {
    float4* r4 = reinterpret_cast<float4*>(stage);
    float4* lo4 = reinterpret_cast<float4*>(stage + G::kR);
#pragma unroll
    for (int e = tid; e < N * 8; e += kWg) {
      const float4 x = r4[e];
      uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
      split_tf32(x.x, h0, l0);
      split_tf32(x.y, h1, l1);
      split_tf32(x.z, h2, l2);
      split_tf32(x.w, h3, l3);
      r4[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(h2), __uint_as_float(h3));
      lo4[e] = make_float4(__uint_as_float(l0), __uint_as_float(l1),
                           __uint_as_float(l2), __uint_as_float(l3));
    }
    const float* w =
        reinterpret_cast<const float*>(stage + G::kW) + warp * G::kWGate;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* w0 = w + (8 * k + t) * G::kWRow + g;
      const float* w1 = w0 + 4 * G::kWRow;
      split_tf32(w0[0], f.v[k][0], f.v[k][4]);
      split_tf32(w0[8], f.v[k][1], f.v[k][5]);
      split_tf32(w1[0], f.v[k][2], f.v[k][6]);
      split_tf32(w1[8], f.v[k][3], f.v[k][7]);
    }
    fence_proxy_async();                  // the split tile, to wgmma
    named_bar_sync(1 + wg, kWg);
  } else {
    constexpr int R = G::kWRow;
    const unsigned short* w =
        reinterpret_cast<const unsigned short*>(stage + G::kW) +
        warp * G::kWGate;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned short* w0 = w + (16 * k + 2 * t) * R + g;
      const unsigned short* w8 = w0 + 8 * R;
      f.v[k][0] = w0[0] | (uint32_t)w0[R] << 16;
      f.v[k][1] = w0[8] | (uint32_t)w0[R + 8] << 16;
      f.v[k][2] = w8[0] | (uint32_t)w8[R] << 16;
      f.v[k][3] = w8[8] | (uint32_t)w8[R + 8] << 16;
    }
  }
}

// Chunk i's products: per k-step of 32 bytes of r_prev's rows, (f32)
// w_lo r_hi and w_hi r_lo into `small`, started afresh at the chunk's
// first k-step, and w_hi r_hi into big[k / kBigSteps], started afresh at
// each one's first k-step; (bf16) w r into `acc`.
template <bool F32, int N>
__device__ __forceinline__ void issue(
    unsigned char* stage, const Frag<F32>& f, float (&acc)[N / 2],
    float (&big)[Geo<F32, N>::kBigs][N / 2], float (&small)[N / 2]) {
  using G = Geo<F32, N>;
  const uint32_t r = smem_u32(stage);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t d_hi = desc_k(r + 32 * k);
    if constexpr (F32) {
      const uint64_t d_lo = desc_k(r + G::kR + 32 * k);
      wgmma_a_reg<true, N>(small, &f.v[k][4], d_hi, k > 0);
      wgmma_a_reg<true, N>(small, &f.v[k][0], d_lo, 1);
      wgmma_a_reg<true, N>(big[k / G::kBigSteps], &f.v[k][0], d_hi,
                           k % G::kBigSteps > 0);
    } else {
      wgmma_a_reg<false, N>(acc, &f.v[k][0], d_hi, 1);
    }
  }
  wgmma_commit();
}

// Chunk i on its warpgroup: prepared, its products issued and waited
// for, the stage handed back to the producer. The other warpgroup's
// chunk runs meanwhile, so one prepares while the other's products run.
// f32: the chunk's sums join `acc` here, on the CUDA cores, small terms
// first: the chunk's parts are added together, then to `acc`. The tensor
// cores truncate each f32 add (always towards zero), so a sum held there
// over many k-steps gathers a bias of one sign; held over a chunk's 4
// k-steps, it put the product's error at 1.4-1.6x the plain f32
// version's at H 37 and the cell's up to 2.2x (chip_smoke.py phase 13 and
// the card tests; on the H100, PERF.md). w_hi r_hi, the large term, is
// therefore summed over one k-step (two at 64 batch rows) an accumulator.
template <bool F32, int N>
__device__ __forceinline__ void chunk(
    unsigned char* smem, uint64_t* full, uint64_t* empty, int i,
    Frag<F32>& f, float (&acc)[N / 2],
    float (&big)[Geo<F32, N>::kBigs][N / 2], float (&small)[N / 2],
    int tid, int wg) {
  using G = Geo<F32, N>;
  const int s = i % G::kStages;
  prepare<F32, N>(smem + s * G::kStage, &full[s], i, f, tid, wg);
  issue<F32, N>(smem + s * G::kStage, f, acc, big, small);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_frag(f);
  if constexpr (F32) {
    fence_regs(small);
#pragma unroll
    for (int b = 0; b < G::kBigs; ++b) fence_regs(big[b]);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      float t = small[e];
#pragma unroll
      for (int b = 0; b < G::kBigs; ++b) t += big[b][e];
      acc[e] += t;
    }
  }
  mbar_arrive(&empty[s]);
}

template <bool F32, int N>
__device__ __forceinline__ void cell_body(const Params& p,
                                          unsigned char* smem_raw) {
  using G = Geo<F32, N>;
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBars);
  uint64_t* empty = full + G::kStages;
  const int u0 = blockIdx.x * kUnits, b0 = blockIdx.y * N;
  const int n_chunks = (p.Hp + G::kChunk - 1) / G::kChunk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWg);  // the warpgroup that takes the stage
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: per chunk, r_prev's box and one box of w's four gate
    // slices, from one thread
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % G::kStages, k0 = i * G::kChunk;
        mbar_wait(&empty[s], ((i / G::kStages) & 1) ^ 1);
        unsigned char* st = smem + s * G::kStage;
        mbar_arrive_expect_tx(&full[s], G::kR + 4 * kWBox);
        tma_load_2d(st, &p.tr, &full[s], k0, b0);
        tma_load_3d(st + G::kW, &p.tw, &full[s], u0, k0, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // ---- the consumer warpgroups: warpgroup wg takes chunks wg, wg + 2,
  // .. (with an even ring, always the same stages), each with sums of its
  // own, added in a fixed order at the end
  const int wg = tid / kWg, ltid = tid % kWg;
  // this thread's outputs: (row b0 + n, unit u0 + u) for idx = tid + 256
  // * it < 16 N, u = idx % 16, n = idx / 16
  constexpr int kOut = (kUnits * N + kConsumers - 1) / kConsumers;
  Inputs in[kOut];
#pragma unroll
  for (int it = 0; it < kOut; ++it) {
    const int idx = tid + kConsumers * it;
    if (idx < kUnits * N)
      in[it] = load_inputs(p, b0 + idx / kUnits, u0 + idx % kUnits);
  }
  float acc[N / 2], big[G::kBigs][N / 2], small[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  Frag<F32> f;
  for (int i = wg; i < n_chunks; i += 2)
    chunk<F32, N>(smem, full, empty, i, f, acc, big, small, ltid, wg);

  // the products' tile, [batch row][gate row]: warpgroup 1's sums, then
  // warpgroup 0's added to them; then the gates by unit
  float* sD = reinterpret_cast<float*>(smem + G::kD);
  const int warp = ltid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sD[(8 * j + 2 * t + (e & 1)) * kDPitch + 16 * warp + g +
           8 * (e >> 1)] = acc[4 * j + e];
  }
  named_bar_sync(3, kConsumers);
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& d = sD[(8 * j + 2 * t + (e & 1)) * kDPitch + 16 * warp + g +
                      8 * (e >> 1)];
        d = acc[4 * j + e] + d;
      }
  }
  named_bar_sync(3, kConsumers);
#pragma unroll
  for (int it = 0; it < kOut; ++it) {
    const int idx = tid + kConsumers * it;
    const int u = idx % kUnits, n = idx / kUnits;
    const int b = b0 + n, j = u0 + u;
    if (idx < kUnits * N && b < p.B && j < p.H) {
      const float* d = sD + n * kDPitch + u;
      finish(p, b, j, in[it], d[0], d[kUnits], d[2 * kUnits],
             d[3 * kUnits]);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_cell_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_f32[];
  cell_body<true, N>(p, smem_f32);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_cell_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  cell_body<false, N>(p, smem_bf16);
}

// ---- host ------------------------------------------------------------------
// A tensor map of `rank` dims (sizes and box in elements, inner first;
// strides in bytes of dims 1..), f32 or bf16; what lies outside the tensor
// is zero-filled. A map is a function of these arguments, which repeat:
// w's over a scan's steps, r_prev's whenever the caching allocator hands
// the same address out again; so each host thread keeps the last
// kMapCache.
constexpr int kMapCache = 16;
struct MapKey {
  const void* ptr;
  long v[10];
};

cudaError_t cached_map(CUtensorMap* map, const void* ptr, bool bf16_elems,
                       int rank, const long* dims, const long* strides,
                       const int* box, bool swizzle) {
  struct Entry {
    CUtensorMap map;
    MapKey key;
    bool valid;
  };
  thread_local Entry cache[kMapCache];
  MapKey key;
  std::memset(&key, 0, sizeof key);
  key.ptr = ptr;
  key.v[0] = rank * 4 + 2 * (long)bf16_elems + (long)swizzle;
  for (int d = 0; d < rank; ++d) {
    key.v[1 + d] = dims[d];
    key.v[4 + d] = box[d];
    if (d > 0) key.v[6 + d] = strides[d - 1];
  }
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (long v : key.v) h = h * 1000003u ^ (uint64_t)v;
  Entry& e = cache[h % kMapCache];
  if (!e.valid || std::memcmp(&e.key, &key, sizeof key) != 0) {
    const EncodeTiledFn fn = encode_tiled_fn();
    if (fn == nullptr) return cudaErrorNotSupported;
    cuuint64_t gdims[3], gstrides[2];
    cuuint32_t gbox[3], estr[3] = {1, 1, 1};
    for (int d = 0; d < rank; ++d) {
      gdims[d] = (cuuint64_t)dims[d];
      gbox[d] = (cuuint32_t)box[d];
      if (d > 0) gstrides[d - 1] = (cuuint64_t)strides[d - 1];
    }
    e.valid = false;
    const CUresult r = fn(
        &e.map, bf16_elems ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        rank, const_cast<void*>(ptr), gdims, gstrides, gbox, estr,
        CU_TENSOR_MAP_INTERLEAVE_NONE,
        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    e.key = key;
    e.valid = true;
  }
  *map = e.map;
  return cudaSuccess;
}

// r_prev [B, Hp]: box of 128 bytes of depth x N rows, 128-byte swizzle
// (wgmma's K-major layout), coordinates {k0, b0}. w [Hp, 4Hp] as
// [gate][depth][unit] (its gate stride Hp, depth stride 4Hp elements):
// box of 16 units x a chunk's depth x 4 gates, coordinates {u0, k0, 0},
// so one load brings a chunk's four gate slices, gate after gate.
template <bool F32, int N>
cudaError_t launch(Params& p, const void* r, const void* w,
                   cudaStream_t s) {
  using G = Geo<F32, N>;
  const long e = F32 ? 4 : 2, Hp = p.Hp;
  const long r_dims[2] = {Hp, p.B}, r_strides[1] = {Hp * e};
  const int r_box[2] = {(int)(128 / e), N};
  cudaError_t err = cached_map(&p.tr, r, !F32, 2, r_dims, r_strides, r_box,
                               true);
  if (err != cudaSuccess) return err;
  const long w_dims[3] = {Hp, Hp, 4}, w_strides[2] = {4 * Hp * e, Hp * e};
  const int w_box[3] = {kUnits, G::kChunk, 4};
  err = cached_map(&p.tw, w, !F32, 3, w_dims, w_strides, w_box, false);
  if (err != cudaSuccess) return err;
  void (*kernel)(Params) =
      F32 ? lstm_cell_f32_kernel<N> : lstm_cell_bf16_kernel<N>;
  // the instantiation's shared-memory limit, set once a device
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((smem_set.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::kTotal);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set.fetch_or(1ull << dev);
  }
  const dim3 grid((p.H + kUnits - 1) / kUnits, (p.B + N - 1) / N);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, G::kTotal, s>>>(p);
  return cudaGetLastError();
}

template <bool F32>
cudaError_t launch_dtype(Params& p, int n, const void* r, const void* w,
                         cudaStream_t s) {
  switch (n) {
    case 8: return launch<F32, 8>(p, r, w, s);
    case 16: return launch<F32, 16>(p, r, w, s);
    case 32: return launch<F32, 32>(p, r, w, s);
    case 64: return launch<F32, 64>(p, r, w, s);
  }
  return cudaErrorInvalidValue;
}

// The batch rows a block: the least of 8, 16, 32, 64 that holds B (64 past
// it), halved while the grid holds under 66 blocks (half the H100's 132
// SMs), down to 8. At (256, 512): 64, 32 x 4 = 128 blocks; at B 1 and 32,
// H 512: 8, 32 and 128 blocks.
int batch_tile(int B, int H) {
  int n = B <= 8 ? 8 : B <= 16 ? 16 : B <= 32 ? 32 : 64;
  const long m_tiles = (H + kUnits - 1) / kUnits;
  while (n > 8 && m_tiles * ((B + n - 1) / n) < 66) n /= 2;
  return n;
}

}  // namespace

// xg: [B, 4H] f32 with row stride ld_xg; r_prev [B, Hp] and w [Hp, 4Hp]
// contiguous and 16-byte aligned (Hp a multiple of 8, >= H; w's gate q at
// columns q * Hp ..), both f32 or (dot_bf16) both bf16; c_prev [B, H] f32;
// h and c [B, H], bf16 where h_bf16 / c_bf16, else f32. batch_tile_rows: the
// batch rows a block, 8, 16, 32 or 64, or 0 for batch_tile(B, H). Returns
// the CUDA error of the launch (0 on success; cudaErrorInvalidValue for
// another batch_tile_rows).
extern "C" int lstm_cell(const void* xg, long long ld_xg, const void* r,
                         const void* c_prev, const void* w, void* h, void* c,
                         int B, int H, int Hp, int dot_bf16, int h_bf16,
                         int c_bf16, int batch_tile_rows, void* stream) {
  if (B <= 0 || H <= 0 || Hp < H || Hp % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch_tile_rows != 0 && batch_tile_rows != 8 && batch_tile_rows != 16 &&
      batch_tile_rows != 32 && batch_tile_rows != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xg = static_cast<const float*>(xg);
  p.ld_xg = ld_xg;
  p.c_prev = static_cast<const float*>(c_prev);
  p.h = h;
  p.c = c;
  p.B = B;
  p.H = H;
  p.Hp = Hp;
  p.h_bf16 = h_bf16;
  p.c_bf16 = c_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = batch_tile_rows ? batch_tile_rows : batch_tile(B, H);
  const cudaError_t err = dot_bf16 ? launch_dtype<false>(p, n, r, w, s)
                                   : launch_dtype<true>(p, n, r, w, s);
  return static_cast<int>(err);
}
