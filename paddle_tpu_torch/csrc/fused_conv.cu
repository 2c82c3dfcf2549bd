// Fused conv + epilogue for Hopper (sm_90a), bf16 and f32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py::_fconv_kernel
// (launched by _fconv_pallas) in both its forms. Same function:
//   y = epilogue(conv(x, w))        (or a depthwise conv)
// with the conv accumulated in f32 and the epilogue stages (folded batch
// norm, activations, scale, binary ops against per-channel, per-sample,
// whole-tensor or scalar operands) applied to the f32 accumulator on
// chip, then one cast and one store. Layout: x [N, H, W, Cin]
// (NHWC), w [Cout, KH, KW, Cin] (depthwise: [KH, KW, C]), out
// [N, Ho, Wo, Cout] in x's dtype; aux 't' operands [N, Ho, Wo, Cout].
//
// The stats form (emit_stats; entry point fused_conv_stats; train-mode
// batch norm) takes no epilogue stages and also writes, per channel, the
// sum and the sum of squares of the f32 accumulator over each run of
// kStatRows output rows (pixels): a [2, ceil(M / kStatRows), Cout] f32
// slab, sums first, each slot written by one block with no atomics, so
// the result is deterministic. Rows past M = N*Ho*Wo add nothing. The
// caller sums the slab over its slots.
//
// What bounds it on this card. A ResNet-50 conv at batch 32 does tens
// to hundreds of multiply-adds per byte it must move (K = KH*KW*Cin
// products per output): the 3x3 and the wide 1x1 convs sit above the
// H100's ~295 bf16 ops/byte balance point (tensor-core bound), the
// narrow 1x1 convs and the stem below it (HBM bound); 1x1 stride-1 convs
// hold two thirds of a request's bound. Fusing the epilogue removes the
// unfused path's extra round trips of the conv output through HBM (batch
// norm, add, relu each read and write it once more).
//
// Design. An implicit GEMM: M = N*Ho*Wo output pixels, N = Cout, K =
// KH*KW*Cin in (kh, kw, ci) order, the order of the NHWC input and the
// [Cout, KH, KW, Cin] weight. The input is read unpadded (padding and
// rows past M read as 0). The wrapper's plan (cuda_kernels.fused_conv_plan,
// in FusedConvArgs) picks one of four variants:
//   * wgmma (bf16, Cin % 64 == 0, Cout % 8 == 0: every ResNet-50 region
//     but the stem): warp-specialised, TMA loads (im2col mode for strided
//     and padded convs, so no thread computes an address) through a ring
//     of shared-memory stages, wgmma into f32 registers, a persistent grid
//     for ResNet's epilogues and the stats form, TMA stores; the output
//     tile's width follows Cout and the number of M tiles, and where the
//     tiles fall short of a wave K is split across blocks whose partials
//     are added in a fixed order (one turn after another on a counter per
//     output tile), so two calls give the same bits; such a grid is
//     launched cooperatively, so all its blocks run at once;
//   * stem (bf16, Cin % 8 != 0: the 7x7 stride-2 conv of a 3-channel
//     image): the input rows under a tile staged in shared memory with
//     16-byte loads, the whole K (147, padded to 160) in one tile, mma.sync;
//   * mma_sync (other bf16): 128 threads per 128 x 64 output tile (64 x 64
//     where 128-row tiles would give the SMs fewer than two blocks each),
//     each warp 32 (16) rows x 64 columns on mma.sync.m16n8k16; 32-deep k
//     tiles come in by cp.async through a ring of three when Cin % 8 == 0,
//     by scalar loads otherwise;
//   * fma (f32, and depthwise in either dtype): 256 threads per 64 x 64
//     tile, 4 x 4 outputs a thread, scalar FMA in full f32 (no TF32); the
//     depthwise kernel a block per 64 pixels by 32 channels, a
//     multiply-add per tap in f32.
// The epilogue is a list of opcodes (FusedConvArgs) interpreted on the f32
// accumulators; every thread of the grid walks the same list, so the
// branches do not diverge. The stats form reduces what each block
// already holds, one slot per 64 rows, each slot written by one block.
// The kernels launch on the caller's stream and allocate nothing.

#include <algorithm>
#include <atomic>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxAux = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxTaps = 64;  // KH * KW of the wgmma kernel

// cuda_kernels._AUX_KINDS
enum AuxKind { kAuxC = 0, kAuxNC = 1, kAuxT = 2, kAuxS = 3 };
// cuda_kernels._STAGE_OPS
enum StageOp { kAffine = 0, kAct = 1, kActP = 2, kScale = 3, kPostmul = 4,
               kBin = 5 };
// activations.ACTS, in order
enum Act { kSigmoid = 0, kLogSigmoid, kExp, kRelu, kTanh, kTanhShrink, kSqrt,
           kAbs, kSquare, kCeil, kFloor, kRound, kReciprocal, kLog, kSoftplus,
           kSoftsign };
// activations.ACTS_P, in order
enum ActP { kBrelu = 0, kLeakyRelu, kElu, kRelu6, kSoftRelu, kHardShrink,
            kSoftshrink, kPow, kStanh, kThresholdedRelu, kHardSigmoid, kSwish,
            kClip };
// activations.BINS, in order
enum Bin { kAdd = 0, kSub, kMul, kDiv, kMax, kMin, kBinPow };

// cuda_kernels._FusedConvArgs, field for field.
struct FusedConvArgs {
  const void* x;
  const void* w;
  void* out;
  const void* aux[kMaxAux];
  int aux_kind[kMaxAux];
  int aux_bf16[kMaxAux];
  int n_aux;
  int stage_op[kMaxStages];
  int stage_code[kMaxStages];
  int stage_a[kMaxStages];
  int stage_b[kMaxStages];
  float stage_p0[kMaxStages];
  float stage_p1[kMaxStages];
  int n_stages;
  int N, H, W, Cin, Cout, KH, KW, sh, sw, ph, pw, Ho, Wo;
  int depthwise, is_bf16;
  float* stats;  // the stats form's slab, or null
  // the plan (cuda_kernels.fused_conv_plan): the variant (Variant), the
  // wgmma kernel's tile width and K splits, the SM count
  int variant, bn, splits, sms;
  // the wgmma kernel's im2col load (cuda_kernels.fused_conv_im2col), each
  // {w, h}: the bounding box's corners (the pixels an output's (0, 0) tap
  // reads), the element strides, each tap's offsets in K order
  int im2col_lower[2], im2col_upper[2], im2col_stride[2];
  int im2col_taps[kMaxTaps][2];
  float* workspace;  // splits > 1: an f32 tile per output tile
  // splits > 1: an int32 per output tile, 0 at the launch; each output
  // tile's last turn puts its counter back to 0
  int* counters;
};

// cuda_kernels.FUSED_CONV_VARIANTS, in order
enum Variant { kFma = 0, kMmaSync = 1, kWgmma = 2, kStem = 3 };

// output rows (pixels) per slot of the stats form's slab
constexpr int kStatRows = 64;

// The stats form's slab: sums at [slot, co], sums of squares after all
// ceil(M / kStatRows) slots of sums.
__device__ __forceinline__ void write_stats(const FusedConvArgs& a, int M,
                                            int slot, int co, float s,
                                            float ss) {
  const long at = (long)slot * a.Cout + co;
  a.stats[at] = s;
  a.stats[(long)((M + kStatRows - 1) / kStatRows) * a.Cout + at] = ss;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float softplusf(float x) {  // logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ float act(int code, float x) {
  switch (code) {
    case kSigmoid: return sigmoidf(x);
    case kLogSigmoid: return -softplusf(-x);
    case kExp: return expf(x);
    case kRelu: return x < 0.f ? 0.f : x;
    case kTanh: return tanhf(x);
    case kTanhShrink: return x - tanhf(x);
    case kSqrt: return sqrtf(x);
    case kAbs: return fabsf(x);
    case kSquare: return x * x;
    case kCeil: return ceilf(x);
    case kFloor: return floorf(x);
    case kRound: return rintf(x);  // half to even, as torch.round
    case kReciprocal: return 1.f / x;
    case kLog: return logf(x);
    case kSoftplus: return softplusf(x);
    case kSoftsign: return x / (fabsf(x) + 1.f);
  }
  return x;
}

__device__ float act_p(int code, float x, float p0, float p1) {
  switch (code) {
    case kBrelu: return clampf(x, p0, p1);
    case kLeakyRelu: return x >= 0.f ? x : p0 * x;
    case kElu: return x > 0.f ? x : p0 * expm1f(x);
    case kRelu6: return clampf(x, 0.f, p0);
    case kSoftRelu: return log1pf(expf(clampf(x, -p0, p0)));
    case kHardShrink: return fabsf(x) > p0 ? x : 0.f;
    case kSoftshrink: return x > p0 ? x - p0 : (x < -p0 ? x + p0 : 0.f);
    case kPow: return powf(x, p0);
    case kStanh: return p1 * tanhf(p0 * x);
    case kThresholdedRelu: return x > p0 ? x : 0.f;
    case kHardSigmoid: return clampf(p0 * x + p1, 0.f, 1.f);
    case kSwish: return x * sigmoidf(p0 * x);
    case kClip: return clampf(x, p0, p1);
  }
  return x;
}

__device__ float bin(int code, float a, float b) {
  switch (code) {
    case kAdd: return a + b;
    case kSub: return a - b;
    case kMul: return a * b;
    case kDiv: return a / b;
    case kMax: return fmaxf(a, b);
    case kMin: return fminf(a, b);
    case kBinPow: return powf(a, b);
  }
  return a;
}

// The i-th aux operand at output pixel m (flat over N*Ho*Wo), channels
// co0 .. co0 + V - 1 (V = 8 only where co0 + 8 <= Cout): one decode of
// the kind for the V values, and 16-byte loads where the address allows.
template <int V>
__device__ __forceinline__ void load_aux(const FusedConvArgs& a, int i,
                                         long m, int co0, float (&b)[V]) {
  long off = 0;
  switch (a.aux_kind[i]) {
    case kAuxC: off = co0; break;
    case kAuxNC: off = (m / ((long)a.Ho * a.Wo)) * a.Cout + co0; break;
    case kAuxT: off = m * a.Cout + co0; break;
    default:  // kAuxS: one value for every element
      b[0] = a.aux_bf16[i]
                 ? __bfloat162float(*static_cast<const bf16*>(a.aux[i]))
                 : *static_cast<const float*>(a.aux[i]);
#pragma unroll
      for (int j = 1; j < V; ++j) b[j] = b[0];
      return;
  }
  if (a.aux_bf16[i]) {
    const bf16* p = static_cast<const bf16*>(a.aux[i]) + off;
    if (V == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const int4 raw = *reinterpret_cast<const int4*>(p);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = __bfloat162float(h[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = __bfloat162float(p[j]);
    }
  } else {
    const float* p = static_cast<const float*>(a.aux[i]) + off;
    if (V == 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      const float r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = r[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) b[j] = p[j];
    }
  }
}

// The stage list on V f32 accumulator values of one output pixel,
// consecutive channels: each stage is decoded once for the V;
// fetch(i, b) gives the i-th aux operand's V values there.
template <int V, class Fetch>
__device__ __forceinline__ void run_stages(const FusedConvArgs& a,
                                           float (&y)[V], Fetch&& fetch) {
  for (int s = 0; s < a.n_stages; ++s) {
    const int code = a.stage_code[s];
    const float p0 = a.stage_p0[s], p1 = a.stage_p1[s];
    float b[V], c[V];
    switch (a.stage_op[s]) {
      case kAffine:
        fetch(a.stage_a[s], b);
        fetch(a.stage_b[s], c);
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = y[j] * b[j] + c[j];
        break;
      case kAct:
        if (code == kRelu) {
#pragma unroll
          for (int j = 0; j < V; ++j) y[j] = y[j] < 0.f ? 0.f : y[j];
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) y[j] = act(code, y[j]);
        }
        break;
      case kActP:
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = act_p(code, y[j], p0, p1);
        break;
      case kScale:
#pragma unroll
        for (int j = 0; j < V; ++j)
          y[j] = code ? y[j] * p0 + p1 : (y[j] + p1) * p0;
        break;
      case kPostmul:
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = y[j] * p0;
        break;
      case kBin:
        fetch(a.stage_a[s], b);
        if (a.stage_b[s]) {
#pragma unroll
          for (int j = 0; j < V; ++j) y[j] = bin(code, b[j], y[j]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) y[j] = bin(code, y[j], b[j]);
        }
        break;
    }
  }
}

// The stage list on output pixel m (flat over N*Ho*Wo), channels co0 ..
// co0 + V - 1, the aux operands read from global memory.
template <int V>
__device__ void epilogue(const FusedConvArgs& a, float (&y)[V], long m,
                         int co0) {
  run_stages<V>(a, y, [&](int i, float (&b)[V]) {
    load_aux<V>(a, i, m, co0, b);
  });
}

// One value through the stage list.
__device__ __forceinline__ float epilogue1(const FusedConvArgs& a, float y,
                                           long m, int co) {
  float v[1] = {y};
  epilogue<1>(a, v, m, co);
  return v[0];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// Where output pixel m reads its (0, 0) tap: image, top row, left column
// (the last two may be negative: padding). img < 0 marks m >= M.
struct RowInfo {
  int img, hi, wi;
};

__device__ __forceinline__ RowInfo row_info(const FusedConvArgs& a, int m,
                                            int M) {
  RowInfo r;
  if (m >= M) {
    r.img = -1;
    r.hi = r.wi = 0;
    return r;
  }
  const int hw = a.Ho * a.Wo;
  r.img = m / hw;
  const int rem = m - r.img * hw;
  const int ho = rem / a.Wo, wo = rem - (rem / a.Wo) * a.Wo;
  r.hi = ho * a.sh - a.ph;
  r.wi = wo * a.sw - a.pw;
  return r;
}

// The (kh, kw, ci) of flat k.
__device__ __forceinline__ void split_k(const FusedConvArgs& a, int k, int& kh,
                                        int& kw, int& ci) {
  ci = k % a.Cin;
  const int khw = k / a.Cin;
  kw = khw % a.KW;
  kh = khw / a.KW;
}

template <typename T>
__device__ __forceinline__ T load_x(const FusedConvArgs& a, const T* x,
                                    const RowInfo& r, int kh, int kw,
                                    int ci) {
  const int hi = r.hi + kh, wi = r.wi + kw;
  if (r.img < 0 || hi < 0 || hi >= a.H || wi < 0 || wi >= a.W) return T(0.f);
  return x[(((long)r.img * a.H + hi) * a.W + wi) * a.Cin + ci];
}

// ---- bf16: implicit GEMM on mma.sync ---------------------------------------
// A block of 128 threads (4 warps) computes a BM x 64 output tile, BM =
// 64 * MT: each warp MT 16-row tiles by eight 8-column tiles.
constexpr int kBN = 64, kBK = 32;
constexpr int kLDS = kBK + 8;  // padded pitch: conflict-free fragment reads
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kLDC = kBN + 4;  // pitch of the staged f32 output tile
constexpr int kStemBM = 128;   // the stem kernel's output rows a block
constexpr int kStemLoads = 8;  // its 16-byte loads in flight a thread
constexpr int kStemRun = 24;   // elements of A it copies in one batch
constexpr int kSmemLimit = 232448;  // 227 KB, a block's most
template <int MT>
struct Tile {
  static constexpr int BM = 64 * MT;
  static constexpr int kStageElems = (BM + kBN) * kLDS;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  static_assert(BM * kLDC * 4 <= kSmemBytes, "output tile fits the ring");
};

// 16 bytes global -> shared without registers; zero-filled when !pred
// (src is then any valid address and is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One k tile of the implicit GEMM as 16-byte copies (Cin % 8 == 0): this
// thread's A rows lr + 32j and B rows lr + 32j, at k chunk lc.
template <int MT>
__device__ __forceinline__ void load_tile_async(
    const FusedConvArgs& a, const bf16* x, const bf16* w, bf16* sA, bf16* sB,
    const RowInfo (&rows)[2 * MT], int k0, int K, int n0, int lr, int lc) {
  const int k = k0 + lc * 8;
  int kh = 0, kw = 0, ci = 0;
  if (k < K) split_k(a, k, kh, kw, ci);
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j) {
    const int hi = rows[j].hi + kh, wi = rows[j].wi + kw;
    const bool in = k < K && rows[j].img >= 0 && hi >= 0 && hi < a.H &&
                    wi >= 0 && wi < a.W;
    const bf16* src =
        in ? x + (((long)rows[j].img * a.H + hi) * a.W + wi) * a.Cin + ci : x;
    cp_async16(sA + (lr + 32 * j) * kLDS + lc * 8, src, in);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int co = n0 + lr + 32 * j;
    const bool in = k < K && co < a.Cout;
    cp_async16(sB + (lr + 32 * j) * kLDS + lc * 8,
               in ? w + (long)co * K + k : w, in);
  }
}

// The same tile with scalar loads, for any Cin (the stem's Cin = 3); k
// past K reads 0.
template <int MT>
__device__ __forceinline__ void load_tile_scalar(
    const FusedConvArgs& a, const bf16* x, const bf16* w, bf16* sA, bf16* sB,
    const RowInfo (&rows)[2 * MT], int k0, int K, int n0, int lr, int lc) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int kk = k0 + lc * 8 + e;
    int kh = 0, kw = 0, ci = 0;
    if (kk < K) split_k(a, kk, kh, kw, ci);
#pragma unroll
    for (int j = 0; j < 2 * MT; ++j)
      sA[(lr + 32 * j) * kLDS + lc * 8 + e] =
          kk < K ? load_x(a, x, rows[j], kh, kw, ci) : bf16(0.f);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = n0 + lr + 32 * j;
      sB[(lr + 32 * j) * kLDS + lc * 8 + e] =
          kk < K && co < a.Cout ? w[(long)co * K + kk] : bf16(0.f);
    }
  }
}

// Four 8x8 b16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// acc += this warp's 16*MT rows x 64 columns of sA . sB^T over one k tile.
// ldmatrix gives each lane its mma fragments: for A, lanes 0-15 name rows
// 0-15 at k 0-7 and lanes 16-31 the same rows at k 8-15 (a0..a3); for B,
// stored [n][k], lanes 0-7 / 8-15 name n-tile nt at k 0-7 / 8-15 and
// lanes 16-31 n-tile nt + 1 (b0, b1 of two n-tiles).
template <int MT>
__device__ __forceinline__ void mma_tile(const bf16* sA, const bf16* sB,
                                         float (&acc)[MT][8][4], int warp,
                                         int lane) {
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(af[mt], sA + ((warp * MT + mt) * 16 + (lane & 15)) * kLDS +
                              kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, sB + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLDS +
                          kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
        mma_bf16_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// The epilogue of a 128-thread mma.sync block's BM x 64 tile: the f32
// tile goes through shared memory (sC, BM x kLDC, free for it) so that each
// thread then runs the stages on 8 consecutive channels of one pixel and
// stores them as one 16-byte vector (rows of the NHWC output are
// contiguous); element e of mma tile (mt, nt) is row g (+8 for e >= 2),
// column 2*t4 (+1 for odd e). The stats form first sums each column over
// each kStatRows-row slot of the tile.
template <int MT>
__device__ void store_tile(const FusedConvArgs& a, float* sC,
                           const float (&acc)[MT][8][4], int m0, int n0,
                           int M) {
  constexpr int BM = 64 * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(
            sC + ((warp * MT + mt) * 16 + g + 8 * half) * kLDC + nt * 8 +
            2 * t4) = make_float2(acc[mt][nt][2 * half],
                                  acc[mt][nt][2 * half + 1]);
  __syncthreads();
  if (a.stats) {
    // per channel over each kStatRows-row slot of the tile: thread i
    // sums column i % kBN down slot i / kBN, rows in order (neighbouring
    // threads read neighbouring columns: no bank conflicts)
    for (int i = tid; i < (BM / kStatRows) * kBN; i += 128) {
      const int slot = i / kBN, c = i % kBN, r0 = slot * kStatRows;
      if (m0 + r0 >= M || n0 + c >= a.Cout) continue;
      const int rows = min(kStatRows, M - m0 - r0);
      float s = 0.f, ss = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float v = sC[(r0 + r) * kLDC + c];
        s += v;
        ss += v * v;
      }
      write_stats(a, M, (m0 + r0) / kStatRows, n0 + c, s, ss);
    }
  }
  bf16* out = static_cast<bf16*>(a.out);
  const bool vec_out = (a.Cout & 7) == 0;
  for (int i = tid; i < BM * (kBN / 8); i += 128) {
    const int r = i >> 3, c8 = (i & 7) * 8;
    const int m = m0 + r, co0 = n0 + c8;
    if (m >= M || co0 >= a.Cout) continue;
    const float* src = sC + r * kLDC + c8;
    bf16* dst = out + (long)m * a.Cout + co0;
    if (vec_out) {  // co0 + 8 <= Cout
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = src[j];
      epilogue<8>(a, v, m, co0);
      *reinterpret_cast<int4*>(dst) =
          make_int4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
      for (int j = 0; j < 8 && co0 + j < a.Cout; ++j)
        dst[j] = __float2bfloat16(epilogue1(a, src[j], m, co0 + j));
    }
  }
}

template <int MT>
__global__ void __launch_bounds__(128)
    conv_bf16_kernel(const __grid_constant__ FusedConvArgs a) {
  constexpr int BM = Tile<MT>::BM, kStageElems = Tile<MT>::kStageElems;
  __shared__ __align__(16) unsigned char smem[Tile<MT>::kSmemBytes];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int M = a.N * a.Ho * a.Wo;
  const int K = a.KH * a.KW * a.Cin;
  const int nk = (K + kBK - 1) / kBK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = tid >> 2, lc = tid & 3;
  RowInfo rows[2 * MT];
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j) rows[j] = row_info(a, m0 + lr + 32 * j, M);

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  if ((a.Cin & 7) == 0) {
    // 16-byte copies through a ring of kStages tiles: tile kt + 2 is in
    // flight while tile kt is multiplied
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) {
        bf16* sA = ring + st * kStageElems;
        load_tile_async<MT>(a, x, w, sA, sA + BM * kLDS, rows, st * kBK, K, n0,
                            lr, lc);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile kt landed; every warp left tile kt - 1
      const int next = kt + kStages - 1;
      if (next < nk) {
        bf16* sA = ring + (next % kStages) * kStageElems;
        load_tile_async<MT>(a, x, w, sA, sA + BM * kLDS, rows, next * kBK, K,
                            n0, lr, lc);
      }
      cp_async_commit();
      const bf16* sA = ring + (kt % kStages) * kStageElems;
      mma_tile<MT>(sA, sA + BM * kLDS, acc, warp, lane);
    }
    cp_async_wait<0>();
  } else {
    for (int kt = 0; kt < nk; ++kt) {
      __syncthreads();
      load_tile_scalar<MT>(a, x, w, ring, ring + BM * kLDS, rows, kt * kBK,
                           K, n0, lr, lc);
      __syncthreads();
      mma_tile<MT>(ring, ring + BM * kLDS, acc, warp, lane);
    }
  }

  __syncthreads();
  store_tile<MT>(a, reinterpret_cast<float*>(smem), acc, m0, n0, M);
}

// ---- bf16 stem: Cin % 8 != 0 (ResNet's 7x7 stride-2 conv of the image) ----
// Blocks of 128 threads (two an SM) walk 128 x 64 output tiles on
// mma.sync. A block stages its [64][Kp] B tile once (K padded to a
// multiple of 16 with zeros: 147 -> 160), from a 16-byte copy of its rows
// of w. For each tile, the input rows under it (each output row the
// tile's pixels span, KH input rows each, zero rows for the padding) are
// staged in shared memory with 16-byte loads, between zero columns that
// keep the 16-byte stores aligned; the whole [128][Kp] A tile is built
// from there, each (row, kh) a run of KW * Cin contiguous elements; the
// products run over Kp without a barrier.
struct StemLayout {
  int kp, lda;    // K rounded up to 16; the A and B tiles' pitch
  int rows_out;   // output rows 128 consecutive pixels can span
  int pl;         // left padding pixels of a staged row
  int pitch;      // a staged row's elements
  int a_bytes, b_bytes, x_bytes;
};

__host__ __device__ inline StemLayout stem_layout(const FusedConvArgs& a) {
  StemLayout L;
  const int K = a.KH * a.KW * a.Cin;
  L.kp = (K + 15) / 16 * 16;
  L.lda = L.kp + 8;
  L.rows_out = (127 + a.Wo - 1) / a.Wo + 1;
  int q = 8;  // pixels a 16-byte boundary repeats over
  while (q > 1 && (q / 2) * a.Cin % 8 == 0) q /= 2;
  L.pl = (a.pw + q - 1) / q * q;
  L.pitch = (2 * L.pl + a.W) * a.Cin;
  const int sc_bytes = kStemBM * kLDC * 4;  // the f32 tile, over A
  L.a_bytes = kStemBM * L.lda * 2 > sc_bytes ? kStemBM * L.lda * 2 : sc_bytes;
  L.b_bytes = kBN * L.lda * 2;
  L.x_bytes = L.rows_out * a.KH * L.pitch * 2;
  return L;
}

__global__ void __launch_bounds__(128)
    conv_stem_kernel(const __grid_constant__ FusedConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_stem[];
  const StemLayout L = stem_layout(a);
  bf16* sA = reinterpret_cast<bf16*>(smem_stem);
  bf16* sB = reinterpret_cast<bf16*>(smem_stem + L.a_bytes);
  bf16* sX = reinterpret_cast<bf16*>(smem_stem + L.a_bytes + L.b_bytes);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int C = a.Cin, K = a.KH * a.KW * C;
  const int M = a.N * a.Ho * a.Wo;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // B once a block: the block's rows of w (contiguous, a multiple of 16
  // bytes) into the A tile's space with 16-byte loads, then into the
  // [64][Kp] tile, zero past K and past Cout
  {
    const int rows = min(kBN, a.Cout - n0);
    const int4* src = reinterpret_cast<const int4*>(w + (long)n0 * K);
    int4* flat = reinterpret_cast<int4*>(sA);
    for (int i = tid; i < rows * K / 8; i += 128) flat[i] = src[i];
    __syncthreads();
    for (int i = tid; i < kBN * L.kp; i += 128) {
      const int n = i / L.kp, k = i - n * L.kp;
      sB[n * L.lda + k] = k < K && n < rows ? sA[n * K + k] : bf16(0.f);
    }
  }

  // the block's M tiles, gridDim.x apart
  const int vecs = L.pitch / 8, data = a.W * C / 8, left = L.pl * C / 8;
  const int run = a.KW * C;
  for (int m0 = blockIdx.x * kStemBM; m0 < M; m0 += gridDim.x * kStemBM) {
    const int g0 = m0 / a.Wo;  // the first output row (flat over N * Ho)
    __syncthreads();  // the last tile's A (its f32 output) and rows are read
    // the input rows: staged row (r, kh) is input row ho * sh - ph + kh
    // of output row g0 + r's image; kStemLoads 16-byte loads in flight a
    // thread
    const int total = L.rows_out * a.KH * vecs;
    for (int i0 = tid; i0 < total; i0 += 128 * kStemLoads) {
      int4 val[kStemLoads];
#pragma unroll
      for (int u = 0; u < kStemLoads; ++u) {
        const int i = i0 + 128 * u;
        const int rr = i / vecs, v = i - rr * vecs - left;
        const int g = g0 + rr / a.KH, img = g / a.Ho;
        const int hi = (g - img * a.Ho) * a.sh - a.ph + rr % a.KH;
        val[u] = make_int4(0, 0, 0, 0);
        if (i < total && img < a.N && hi >= 0 && hi < a.H && v >= 0 &&
            v < data)
          val[u] = *reinterpret_cast<const int4*>(
              x + ((long)img * a.H + hi) * a.W * C + v * 8);
      }
#pragma unroll
      for (int u = 0; u < kStemLoads; ++u)
        if (i0 + 128 * u < total)
          *reinterpret_cast<int4*>(sX + (i0 + 128 * u) * 8) = val[u];
    }
    __syncthreads();
    // A: row m's taps of input row kh are KW * C contiguous staged
    // elements (read in runs of up to kStemRun); K padded with zeros
    for (int i = tid; i < kStemBM * a.KH; i += 128) {
      const int r = i / a.KH, kh = i - r * a.KH, m = m0 + r;
      bf16* dst = sA + r * L.lda + kh * run;
      const int g = m / a.Wo, wo = m - g * a.Wo;
      const bf16* src = sX + ((g - g0) * a.KH + kh) * L.pitch +
                        (wo * a.sw - a.pw + L.pl) * C;
      for (int e0 = 0; e0 < run; e0 += kStemRun) {
        bf16 v[kStemRun];
#pragma unroll
        for (int e = 0; e < kStemRun; ++e)
          v[e] = m < M && e0 + e < run ? src[e0 + e] : bf16(0.f);
#pragma unroll
        for (int e = 0; e < kStemRun; ++e)
          if (e0 + e < run) dst[e0 + e] = v[e];
      }
    }
    for (int i = tid; i < kStemBM * (L.kp - K); i += 128) {
      const int r = i / (L.kp - K);
      sA[r * L.lda + K + (i - r * (L.kp - K))] = bf16(0.f);
    }
    __syncthreads();

    // each warp 32 rows x 64 columns, as mma_tile<2>
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
            0.f;
    for (int kc = 0; kc < L.kp / 16; ++kc) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], sA + ((warp * 2 + mt) * 16 + (lane & 15)) *
                                     L.lda + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sB + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                 L.lda + kc * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
          mma_bf16_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
    store_tile<2>(a, reinterpret_cast<float*>(smem_stem), acc, m0, n0, M);
  }
}

// what the stem kernel takes: bf16 rows of 16-byte multiples, a 16-byte
// output row, its shared memory within a block's
int stem_smem_bytes(const FusedConvArgs& a) {
  if (!a.is_bf16 || a.depthwise || (a.W * a.Cin) % 8 || a.Cout % 8)
    return -1;
  const StemLayout L = stem_layout(a);
  const int bytes = L.a_bytes + L.b_bytes + L.x_bytes;
  return bytes <= kSmemLimit ? bytes : -1;
}

// ---- f32: implicit GEMM on scalar FMA --------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFLD = kFM + 4;  // pitch of the k-major tiles, 16-byte rows
static_assert(kFM == kStatRows, "an f32 block's rows are one stats slot");

__global__ void __launch_bounds__(256)
    conv_f32_kernel(const __grid_constant__ FusedConvArgs a) {
  __shared__ __align__(16) float sA[kFK * kFLD];
  __shared__ __align__(16) float sB[kFK * kFLD];
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const int M = a.N * a.Ho * a.Wo;
  const int K = a.KH * a.KW * a.Cin;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int tid = threadIdx.x;
  // loads: rows (A) / output channels (B) tid/16 + 16j, k offset tid % 16
  const int lr = tid >> 4, lk = tid & 15;
  RowInfo rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) rows[j] = row_info(a, m0 + lr + 16 * j, M);
  // compute: rows ty*4.., columns tx*4..
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();
    const int k = k0 + lk;
    int kh = 0, kw = 0, ci = 0;
    if (k < K) split_k(a, k, kh, kw, ci);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sA[lk * kFLD + lr + 16 * j] =
          k < K ? load_x(a, x, rows[j], kh, kw, ci) : 0.f;
      const int co = n0 + lr + 16 * j;
      sB[lk * kFLD + lr + 16 * j] =
          k < K && co < a.Cout ? w[(long)co * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(sA + kk * kFLD + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(sB + kk * kFLD + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  if (a.stats) {
    // each thread's 4 rows, then the 16 row groups of a column in order
    // through shared memory; the block's kFM = kStatRows rows are one slot
    __shared__ float sS[2][kFM / 4][kFN];
    float s[4] = {}, ss[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + ty * 4 + i >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] += acc[i][j];
        ss[j] += acc[i][j] * acc[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sS[0][ty][tx * 4 + j] = s[j];
      sS[1][ty][tx * 4 + j] = ss[j];
    }
    __syncthreads();
    if (tid < kFN && n0 + tid < a.Cout) {
      float bs = 0.f, bss = 0.f;
      for (int g = 0; g < kFM / 4; ++g) {
        bs += sS[0][g][tid];
        bss += sS[1][g][tid];
      }
      write_stats(a, M, blockIdx.x, n0 + tid, bs, bss);
    }
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < a.Cout)
        out[(long)m * a.Cout + co] = epilogue1(a, acc[i][j], m, co);
    }
  }
}

// ---- depthwise: a multiply-add per tap -------------------------------------
// A block of 256 threads covers kStatRows output pixels by kDwC channels:
// thread (p, c) = (tid / kDwC, tid % kDwC) computes pixels p, p + kDwP,
// ... of its channel, so neighbouring threads read and write neighbouring
// channels of one pixel, and the block's pixels are one slot of the stats
// form's slab.
constexpr int kDwC = 32, kDwP = 8;

template <typename T>
__global__ void __launch_bounds__(kDwC * kDwP)
    conv_depthwise_kernel(const __grid_constant__ FusedConvArgs a) {
  __shared__ float sS[2][kDwP][kDwC];
  const int C = a.Cout;
  const int M = a.N * a.Ho * a.Wo;
  const int lc = threadIdx.x % kDwC, lp = threadIdx.x / kDwC;
  const int c = blockIdx.y * kDwC + lc;
  const int m0 = blockIdx.x * kStatRows;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  float s = 0.f, ss = 0.f;
  if (c < C) {
    for (int p = lp; p < kStatRows && m0 + p < M; p += kDwP) {
      const int m = m0 + p;
      const RowInfo r = row_info(a, m, M);
      float acc = 0.f;
      for (int kh = 0; kh < a.KH; ++kh)
        for (int kw = 0; kw < a.KW; ++kw)
          acc = fmaf(to_f32(load_x(a, x, r, kh, kw, c)),
                     to_f32(w[(kh * a.KW + kw) * C + c]), acc);
      s += acc;
      ss += acc * acc;
      store(static_cast<T*>(a.out) + (long)m * C + c,
            epilogue1(a, acc, m, c));
    }
  }
  if (a.stats) {
    sS[0][lp][lc] = s;
    sS[1][lp][lc] = ss;
    __syncthreads();
    if (lp == 0 && c < C) {
      float bs = 0.f, bss = 0.f;
      for (int g = 0; g < kDwP; ++g) {
        bs += sS[0][g][lc];
        bss += sS[1][g][lc];
      }
      write_stats(a, M, blockIdx.x, c, bs, bss);
    }
  }
}

// ---- bf16, Cin % 64 == 0: wgmma, TMA loads, split-K ------------------------
// A block of three warpgroups; a unit of work is a 128 x BN output tile
// (BN 64, 128 or 256) and, where K is split, one split of its K.
// Warpgroup 0 is the producer (setmaxnreg 40): one thread keeps TMA loads
// of (A, B) K chunks in flight through a ring of wg_ring(BN) stages, each
// with a full and an empty mbarrier. A K chunk is 64 channels of one tap
// (Cin % 64 == 0, so a chunk never straddles a tap): A is 128 output
// pixels of it, one 128-byte-swizzled [128][64] sub-tile, fetched from x
// as a [M, Cin] matrix for a 1x1 stride-1 unpadded conv and by TMA's
// im2col mode otherwise (the hardware walks the tile's pixels, applies
// the stride and the tap's offset and zero-fills padding and rows past
// M); B is the [BN][64] slice of w as a [Cout, K] matrix. Warpgroups 1
// and 2 are consumers (setmaxnreg 232), 64 output rows each: wgmma
// m64·BN·k16 from shared memory into f32 registers, one wgmma group in
// flight, a stage released as soon as its group is done.
//
// With the fast epilogue (ResNet's stage lists and the stats form) the
// grid is persistent, one block an SM walking units in blockIdx order: the
// producer runs ahead into the next unit's chunks while the consumers
// finish this one, whose bf16 tile leaves through a staging area of its
// own by TMA stores (the residual tile comes in there by TMA, once the
// last tile's stores have read it). Any other stage list takes one unit a
// block and the staged generic epilogue.
constexpr int kWgBM = 128;
constexpr int kWgThreads = 384;
constexpr int kWgSub = kWgBM * 128;  // one [128][64] bf16 sub-tile, bytes
constexpr int kWgMaxRing = 8;
static_assert(kWgBM == 2 * kStatRows, "a consumer's rows are one slot");

__host__ __device__ constexpr int wg_stage_bytes(int bn) {
  return kWgSub + bn * 128;
}
// beyond the ring: alignment slack, the output tile's staging (where the
// residual tile lands and the stats form sums its columns), the
// mbarriers, each consumer's copy of the folded batch norm's columns
__host__ __device__ constexpr int wg_fixed_bytes(int bn) {
  return 1024 + (bn / 64) * kWgSub + 256 + 2 * 2 * bn * 4;
}
// the ring: as many stages as the rest leaves room for, at most
// kWgMaxRing (8, 5 and 3 at BN 64, 128 and 256)
__host__ __device__ constexpr int wg_ring(int bn) {
  return (kSmemLimit - wg_fixed_bytes(bn)) / wg_stage_bytes(bn) < kWgMaxRing
             ? (kSmemLimit - wg_fixed_bytes(bn)) / wg_stage_bytes(bn)
             : kWgMaxRing;
}
__host__ __device__ constexpr int wg_smem_bytes(int bn) {
  return wg_ring(bn) * wg_stage_bytes(bn) + wg_fixed_bytes(bn);
}

// One step of the moments' shuffle tree over lanes `mask` apart: the lane
// with `up` set keeps v[HALF..2 HALF), its partner v[0..HALF); each adds
// the other's copy of the half it keeps into v[0..HALF). The selects are
// in asm so that v keeps static indices (registers, not local memory).
template <int HALF, int N>
__device__ __forceinline__ void halve_sums(float (&v)[N], int up, int mask) {
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    float send, keep;
    asm("{\n.reg .pred q;\nsetp.ne.b32 q, %4, 0;\n"
        "selp.f32 %0, %2, %3, q;\nselp.f32 %1, %3, %2, q;\n}"
        : "=f"(send), "=f"(keep)
        : "f"(v[k]), "f"(v[k + HALF]), "r"(up));
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Where column col of the moments' per-warp sums (sq: of squares) sits in
// its row: the writers of one store are the 8 row-group lanes of a t4,
// whose columns differ by a quarter of BN and whose rows by sum / square,
// so each quarter and the squares get banks of their own.
template <int BN>
__device__ __forceinline__ int red_col(int col, int sq) {
  return col ^ ((col / (BN / 4)) << 3) ^ sq;
}

struct alignas(64) WgConvParams {
  CUtensorMap tx;    // x: [M, Cin] 2-d, or the NHWC im2col map
  CUtensorMap tw;    // w: [Cout, K] 2-d, box BN x 64
  CUtensorMap tres;  // the residual operand: [M, Cout] 2-d, box 128 x 64
  CUtensorMap tout;  // y: [M, Cout] 2-d, box 64 x 64
  FusedConvArgs a;
  int im2col;   // A by im2col loads (else x is a [M, Cin] matrix)
  // the fast epilogue, for stage lists of ResNet's form: [affine of two
  // per-channel operands] [+ one bf16 residual operand] [relu], each
  // optional, in that order
  int fast, fast_affine, fast_mul, fast_add, fast_relu;
  int res_aux;  // the residual operand, read through tres, or -1
  int m_tiles, n_tiles;
  int nk;       // K chunks (KH * KW * Cin / 64)
  int cchunks;  // Cin / 64
};

// unit u: its output tile (M tiles of a group walked with their N tiles,
// as group_order does for heads), its split and K chunks
struct WgUnit {
  int tile, split, m0, n0, kb, nkl;
  bool last;
};

template <int BN>
__device__ __forceinline__ WgUnit wg_unit(const WgConvParams& p, int u) {
  WgUnit w;
  const int tiles = p.m_tiles * p.n_tiles;
  w.tile = u % tiles;
  w.split = u / tiles;
  int mt, nt;
  group_order(w.tile, p.m_tiles, p.n_tiles, mt, nt);
  w.m0 = mt * kWgBM;
  w.n0 = nt * BN;
  w.kb = (int)((long)w.split * p.nk / p.a.splits);
  w.nkl = (int)((long)(w.split + 1) * p.nk / p.a.splits) - w.kb;
  w.last = w.split == p.a.splits - 1;
  return w;
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ WgConvParams p) {
  constexpr int kStage = wg_stage_bytes(BN);
  constexpr int S = wg_ring(BN);
  constexpr int kSubs = BN / 64;  // 64-column sub-tiles of a tile
  static_assert(S >= 2 && wg_smem_bytes(BN) <= kSmemLimit,
                "a ring of two stages fits");
  static_assert(kWgBM * (BN + 4) * 4 <= S * kStage,
                "the generic epilogue's f32 tile fits the ring");
  const FusedConvArgs& a = p.a;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = align1024(smem_wg);
  unsigned char* out_st = smem + S * kStage;  // [kSubs][128][64] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(out_st + kSubs * kWgSub);
  uint64_t* empty = full + kWgMaxRing;
  uint64_t* res_full = empty + kWgMaxRing;  // the residual tile landed
  uint64_t* out_free = res_full + 1;        // both halves stored
  float* sc = reinterpret_cast<float*>(out_st + kSubs * kWgSub + 256);

  const int M = a.N * a.Ho * a.Wo;
  const int units = p.m_tiles * p.n_tiles * a.splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    mbar_init(res_full, 1);
    mbar_init(out_free, 2);  // one thread of each consumer
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: each unit's K chunks, then (its last split) the
    // residual tile into the staging area once the last tile left it
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0, res_n = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const WgUnit w = wg_unit<BN>(p, u);
        // the first pixel's (0, 0) tap: its place in the bounding box
        int w0 = 0, h0 = 0, img = 0;
        if (p.im2col) {
          const int hw = a.Ho * a.Wo;
          img = w.m0 / hw;
          const int rem = w.m0 - img * hw, ho = rem / a.Wo;
          h0 = a.im2col_lower[1] + ho * a.im2col_stride[1];
          w0 = a.im2col_lower[0] + (rem - ho * a.Wo) * a.im2col_stride[0];
        }
        for (int i = 0; i < w.nkl; ++i, ++it) {
          const int s = it % S, kc = w.kb + i;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          unsigned char* st = smem + s * kStage;
          mbar_arrive_expect_tx(&full[s], kStage);
          const int tap = kc / p.cchunks, c0 = (kc - tap * p.cchunks) * 64;
          if (p.im2col)
            tma_load_im2col_4d(st, &p.tx, &full[s], c0, w0, h0, img,
                               a.im2col_taps[tap][0], a.im2col_taps[tap][1]);
          else
            tma_load_2d(st, &p.tx, &full[s], c0, w.m0);
          tma_load_2d(st + kWgSub, &p.tw, &full[s], kc * 64, w.n0);
        }
        if (w.last && p.res_aux >= 0) {
          mbar_wait(out_free, (res_n & 1) ^ 1);
          mbar_arrive_expect_tx(res_full, kSubs * kWgSub);
          for (int j = 0; j < kSubs; ++j)
            tma_load_2d(out_st + j * kWgSub, &p.tres, res_full,
                        w.n0 + 64 * j, w.m0);
          ++res_n;
        }
      }
    }
  } else {
  // ---- consumers
  setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128;  // over both consumers
  const int ltid = tid & 127;
  const int warp = ltid >> 5, lane = ltid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lrow = 64 * cw + 16 * warp + g;  // tile rows lrow, lrow + 8
  float* mul = sc + cw * 2 * BN;             // this consumer's copy
  float* add = mul + BN;
  const uint32_t ring = smem_u32(smem);
  int it = 0, res_n = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const WgUnit w = wg_unit<BN>(p, u);
    const int m0 = w.m0, n0 = w.n0;
    if (w.last && p.fast_affine) {
      // the tile's columns of the folded batch norm; the last unit's
      // epilogue is done with them (the barrier before its store)
      const float* gm = static_cast<const float*>(a.aux[p.fast_mul]);
      const float* ga = static_cast<const float*>(a.aux[p.fast_add]);
      for (int c = ltid; c < BN; c += 128) {
        mul[c] = n0 + c < a.Cout ? gm[n0 + c] : 0.f;
        add[c] = n0 + c < a.Cout ? ga[n0 + c] : 0.f;
      }
    }

    // the first product overwrites the accumulators (scale_d 0): no other
    // instruction defines them while wgmma runs, so ptxas keeps the
    // products in flight
    float acc[BN / 2];
    const int it0 = it;
    for (int i = 0; i < w.nkl; ++i, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint32_t sa = ring + s * kStage + cw * (64 * 128);
      const uint32_t sb = ring + s * kStage + kWgSub;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN, 0, 0>(acc, desc_k(sa + kk * 32), desc_k(sb + kk * 32),
                           kk > 0 || i > 0);
      wgmma_commit();
      wgmma_wait<1>();
      // the previous chunk's products are done: its stage is free
      if (i > 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(it0 + w.nkl - 1) % S]);

    const bool half_in = m0 + 64 * cw < M;  // this consumer has a row < M
    if (a.splits > 1) {
      // ---- split-K: in this split's turn (one counter per output tile)
      // the first split stores its f32 partial into the workspace in
      // register order, the next ones add theirs, the last reads the sum
      int* ctr = a.counters + w.tile;
      float4* ws = reinterpret_cast<float4*>(a.workspace +
                                             (long)w.tile * (kWgBM * BN)) +
                   cw * (BN / 8) * 128 + ltid;
      if (tid == 0) {
        wait_counter_ge(ctr, w.split);
        // every other turn is done: the counter is free for the next launch
        if (w.last) *ctr = 0;
      }
      named_bar_sync(1, 256);
      if (!w.last) {
        if (half_in && w.split == 0) {
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
            __stcg(ws + i * 128, make_float4(acc[4 * i], acc[4 * i + 1],
                                             acc[4 * i + 2], acc[4 * i + 3]));
        } else if (half_in) {
          // read-add-write, 8 vectors in flight; each address has one
          // writer a turn
#pragma unroll
          for (int i0 = 0; i0 < BN / 8; i0 += 8) {
            float4 v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = __ldcg(ws + (i0 + i) * 128);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int e = 4 * (i0 + i);
              __stcg(ws + (i0 + i) * 128,
                     make_float4(v[i].x + acc[e], v[i].y + acc[e + 1],
                                 v[i].z + acc[e + 2], v[i].w + acc[e + 3]));
            }
          }
        }
        __threadfence();
        named_bar_sync(1, 256);
        if (tid == 0) release_add(ctr, 1);
        continue;
      }
      if (half_in) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float4 v = __ldcg(ws + i * 128);
          acc[4 * i] = v.x + acc[4 * i];
          acc[4 * i + 1] = v.y + acc[4 * i + 1];
          acc[4 * i + 2] = v.z + acc[4 * i + 2];
          acc[4 * i + 3] = v.w + acc[4 * i + 3];
        }
      }
    }

    if (!p.fast) {
      // ---- any other stage list (one unit a block, so the ring is free
      // once both consumers are done): the f32 tile through shared
      // memory, the stage interpreter on 8 channels of a pixel at a time
      // (aux operands from global memory), one 16-byte store each
      constexpr int kLd = BN + 4;  // padded pitch
      float* st = reinterpret_cast<float*>(smem);
      named_bar_sync(1, 256);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(st + (lrow + 8 * r) * kLd + 8 * j +
                                     2 * t4) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      named_bar_sync(1, 256);
      bf16* out = static_cast<bf16*>(a.out);
      for (int i = tid; i < kWgBM * (BN / 8); i += 256) {
        const int r = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
        const int m = m0 + r, co0 = n0 + c8;
        if (m >= M || co0 >= a.Cout) continue;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = st[r * kLd + c8 + e];
        epilogue<8>(a, v, m, co0);
        *reinterpret_cast<int4*>(out + (long)m * a.Cout + co0) =
            make_int4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                      pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      }
      continue;
    }

    // this consumer's last stores have read the staging area (its thread 0
    // waits for them here, or waited right after them where a residual
    // tile was to follow) and its columns of the batch norm are in place
    if (ltid == 0) bulk_wait_read();
    named_bar_sync(2 + cw, 128);
    if (a.stats != nullptr) {
      // ---- the moments: this consumer's 64 rows are one slot; per column
      // the thread's two rows, the warp's 8 row groups by shuffle, the 4
      // warps through shared memory (this consumer's rows of the staging
      // area), each in a fixed order. The shuffles halve what they carry:
      // at each of the three steps a lane keeps half of its values and
      // hands its partner the other half (7/8 of a shuffle a value
      // instead of 3); the pairs summed are those of a plain xor tree
      constexpr int kV = BN / 2;  // [sum, sum of squares][column slot]
      const bool va = m0 + lrow < M, vb = m0 + lrow + 8 < M;
      float v[kV];  // slot c: column 8 (c / 2) + 2 t4 + c % 2
#pragma unroll
      for (int c = 0; c < BN / 4; ++c) {
        const float v0 = va ? acc[4 * (c >> 1) + (c & 1)] : 0.f;
        const float v1 = vb ? acc[4 * (c >> 1) + 2 + (c & 1)] : 0.f;
        v[c] = v0 + v1;
        v[BN / 4 + c] = v0 * v0 + v1 * v1;
      }
      halve_sums<kV / 2>(v, g & 1, 4);
      halve_sums<kV / 4>(v, (g >> 1) & 1, 8);
      halve_sums<kV / 8>(v, (g >> 2) & 1, 16);
      // lane g now holds the warp's sums kept at base + k, k < kV / 8:
      // sums (g even) or sums of squares of one quarter q of the columns;
      // red_col spreads the 8 lanes of a t4 over distinct banks
      float* red = reinterpret_cast<float*>(out_st + cw * (64 * 128));
      const int sq = g & 1;
      const int base = ((g >> 1) & 1) * (kV / 4) + (g >> 2) * (kV / 8);
#pragma unroll
      for (int k = 0; k < kV / 8; ++k) {
        const int c = base + k;
        red[(4 * sq + warp) * BN +
            red_col<BN>(8 * (c >> 1) + 2 * t4 + (c & 1), sq)] = v[k];
      }
      named_bar_sync(2 + cw, 128);
      if (half_in) {
        for (int c = ltid; c < BN && n0 + c < a.Cout; c += 128) {
          float s = 0.f, ss = 0.f;
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) {
            s += red[w4 * BN + red_col<BN>(c, 0)];
            ss += red[(4 + w4) * BN + red_col<BN>(c, 1)];
          }
          write_stats(a, M, (m0 + 64 * cw) / kStatRows, n0 + c, s, ss);
        }
      }
      named_bar_sync(2 + cw, 128);
    }

    // ---- the fast stage list on the accumulator fragments, into the
    // staging area (128-byte-swizzled [128][64] sub-tiles, the TMA store's
    // layout, where the residual tile landed), then TMA stores, which drop
    // rows past M and columns past Cout
    if (p.res_aux >= 0) {
      mbar_wait(res_full, res_n & 1);
      ++res_n;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int lc = 8 * j + 2 * t4, cb = (lc % 64) * 2;
      unsigned char* base = out_st + (lc / 64) * kWgSub;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lrow + 8 * r;
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            base + row * 128 + ((((cb >> 4) ^ (row & 7)) << 4) | (cb & 15)));
        float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (p.fast_affine) {
          v0 = v0 * mul[lc] + add[lc];
          v1 = v1 * mul[lc + 1] + add[lc + 1];
        }
        if (p.res_aux >= 0) {
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(dst);
          v0 += __low2float(h);
          v1 += __high2float(h);
        }
        if (p.fast_relu) {
          v0 = v0 < 0.f ? 0.f : v0;
          v1 = v1 < 0.f ? 0.f : v1;
        }
        *dst = pack_bf16(v0, v1);
      }
    }
    fence_proxy_async();
    named_bar_sync(2 + cw, 128);
    if (ltid == 0) {
      if (half_in) {
        for (int sub = 0; sub < kSubs && n0 + 64 * sub < a.Cout; ++sub)
          tma_store_2d(&p.tout, out_st + sub * kWgSub + cw * (64 * 128),
                       n0 + 64 * sub, m0 + 64 * cw);
        bulk_commit();
      }
      // the next residual tile may come in once the stores have read the
      // staging area; without one the wait goes to the next epilogue, so
      // the stores overlap the next unit's products
      if (p.res_aux >= 0) {
        bulk_wait_read();
        mbar_arrive(out_free);
      }
    }
  }
  if (ltid == 0) bulk_wait_read();  // the staging area outlives the stores
  }
}

// Host: a tensor map is a function of its encoder's arguments (address,
// sizes, box), which a served model's launches repeat (its weights, and
// the activations the caching allocator hands out again), so each host
// thread keeps the last kMapCache maps of each call site.
constexpr int kMapCache = 64;
struct MapKey {
  const void* ptr;
  long v[7];  // the encoder's other arguments
};

template <class Encode>
cudaError_t cached_map(CUtensorMap* map, const MapKey& key, Encode encode) {
  struct Entry {
    CUtensorMap map;
    MapKey key;
    bool valid;
  };
  thread_local Entry cache[kMapCache];
  uint64_t h = reinterpret_cast<uintptr_t>(key.ptr) >> 4;
  for (long v : key.v) h = h * 1000003u ^ (uint64_t)v;
  Entry& e = cache[h % kMapCache];
  if (!e.valid || std::memcmp(&e.key, &key, sizeof key) != 0) {
    e.valid = false;
    const cudaError_t err = encode(&e.map);
    if (err != cudaSuccess) return err;
    e.key = key;
    e.valid = true;
  }
  *map = e.map;
  return cudaSuccess;
}

template <int BN>
cudaError_t launch_wgmma_bn(const WgConvParams& p, cudaStream_t st) {
  const int smem = wg_smem_bytes(BN);
  // the kernel's shared-memory limit, set once a device
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((smem_set.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(conv_wgmma_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set.fetch_or(1ull << dev);
  }
  const long units = (long)p.m_tiles * p.n_tiles * p.a.splits;
  if (units > 0x7fffffffL) return cudaErrorInvalidValue;
  // persistent with the fast epilogue: one block an SM
  const long blocks = p.fast ? std::min<long>(units, p.a.sms) : units;
  // split-K: a unit waits for the turns of its tile's lower splits, which
  // are lower-numbered units, and each block takes its units in rising
  // order, so the lowest unfinished unit can always go on, provided its
  // block is running. Such a grid launches cooperatively: the driver
  // places every block at once (the plan keeps the grid within one block
  // an SM) or refuses the launch, so no turn waits on a queued block.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = p.a.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, conv_wgmma_kernel<BN>, p);
}

cudaError_t launch_wgmma(const FusedConvArgs& a, cudaStream_t st) {
  const long M = (long)a.N * a.Ho * a.Wo;
  const long K = (long)a.KH * a.KW * a.Cin;
  if (!a.is_bf16 || a.depthwise || a.Cin % 64 || a.Cout % 8 ||
      (a.bn != 64 && a.bn != 128 && a.bn != 256) || a.splits < 1 ||
      a.splits > K / 64 || a.KH * a.KW > kMaxTaps ||
      (a.splits > 1 && (a.workspace == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  // the im2col map's limits: corners in [-128, 127], element strides in
  // [1, 8], offsets under 2**16
  for (int d = 0; d < 2; ++d)
    if (a.im2col_lower[d] < -128 || a.im2col_lower[d] > 127 ||
        a.im2col_upper[d] < -128 || a.im2col_upper[d] > 127 ||
        a.im2col_stride[d] < 1 || a.im2col_stride[d] > 8)
      return cudaErrorInvalidValue;
  for (int t = 0; t < a.KH * a.KW; ++t)
    if (a.im2col_taps[t][0] < 0 || a.im2col_taps[t][0] > 0xffff ||
        a.im2col_taps[t][1] < 0 || a.im2col_taps[t][1] > 0xffff)
      return cudaErrorInvalidValue;
  WgConvParams p;
  p.a = a;
  p.im2col = !(a.KH == 1 && a.KW == 1 && a.sh == 1 && a.sw == 1 &&
               a.ph == 0 && a.pw == 0);
  p.m_tiles = (int)((M + kWgBM - 1) / kWgBM);
  p.n_tiles = (a.Cout + a.bn - 1) / a.bn;
  p.nk = (int)(K / 64);
  p.cchunks = a.Cin / 64;
  // the fast epilogue's stage lists; the residual comes in by TMA
  p.fast = 1;
  p.fast_affine = p.fast_mul = p.fast_add = p.fast_relu = 0;
  p.res_aux = -1;
  int s = 0;
  if (s < a.n_stages && a.stage_op[s] == kAffine &&
      a.aux_kind[a.stage_a[s]] == kAuxC &&
      a.aux_kind[a.stage_b[s]] == kAuxC) {
    p.fast_affine = 1;
    p.fast_mul = a.stage_a[s];
    p.fast_add = a.stage_b[s];
    ++s;
  }
  if (s < a.n_stages && a.stage_op[s] == kBin && a.stage_code[s] == kAdd) {
    const int i = a.stage_a[s];
    if (a.aux_kind[i] == kAuxT && a.aux_bf16[i] &&
        (reinterpret_cast<uintptr_t>(a.aux[i]) & 15) == 0) {
      p.res_aux = i;
      ++s;
    }
  }
  if (s < a.n_stages && a.stage_op[s] == kAct && a.stage_code[s] == kRelu) {
    p.fast_relu = 1;
    ++s;
  }
  if (s < a.n_stages) {
    p.fast = p.fast_affine = p.fast_relu = 0;
    p.res_aux = -1;
  }
  cudaError_t err =
      p.im2col
          ? cached_map(&p.tx,
                       {a.x,
                        {a.N, a.H, a.W, a.Cin,
                         a.im2col_lower[0] * 256L + a.im2col_lower[1],
                         a.im2col_upper[0] * 256L + a.im2col_upper[1],
                         a.im2col_stride[0] * 256L + a.im2col_stride[1]}},
                       [&](CUtensorMap* m) {
                         return encode_nhwc_im2col(
                             m, a.x, a.N, a.H, a.W, a.Cin, a.im2col_lower,
                             a.im2col_upper, a.im2col_stride, kWgBM);
                       })
          : cached_map(&p.tx, {a.x, {M, a.Cin}}, [&](CUtensorMap* m) {
              return encode_2d(m, a.x, M, a.Cin, a.Cin, kWgBM);
            });
  if (err == cudaSuccess)
    err = cached_map(&p.tw, {a.w, {a.Cout, K, a.bn}}, [&](CUtensorMap* m) {
      return encode_2d(m, a.w, a.Cout, K, K, a.bn);
    });
  if (err == cudaSuccess)
    err = cached_map(&p.tout, {a.out, {M, a.Cout}}, [&](CUtensorMap* m) {
      return encode_2d(m, a.out, M, a.Cout, a.Cout, 64);
    });
  if (err == cudaSuccess && p.res_aux >= 0) {
    const void* res = a.aux[p.res_aux];
    err = cached_map(&p.tres, {res, {M, a.Cout}}, [&](CUtensorMap* m) {
      return encode_2d(m, res, M, a.Cout, a.Cout, kWgBM);
    });
  }
  if (err != cudaSuccess) return err;
  switch (a.bn) {
    case 64: return launch_wgmma_bn<64>(p, st);
    case 128: return launch_wgmma_bn<128>(p, st);
    default: return launch_wgmma_bn<256>(p, st);
  }
}

int launch(const FusedConvArgs& a, void* stream) {
  if (a.n_aux < 0 || a.n_aux > kMaxAux || a.n_stages < 0 ||
      a.n_stages > kMaxStages || a.N <= 0 || a.Ho <= 0 || a.Wo <= 0 ||
      a.Cin <= 0 || a.Cout <= 0 || a.KH <= 0 || a.KW <= 0 || a.sh <= 0 ||
      a.sw <= 0 || a.sms <= 0)
    return (int)cudaErrorInvalidValue;
  const long M = (long)a.N * a.Ho * a.Wo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the variant must take these operands (cuda_kernels.fused_conv_plan)
  const bool fma = !a.is_bf16 || a.depthwise;
  if ((a.variant == kFma) != fma) return (int)cudaErrorInvalidValue;
  if (a.variant == kWgmma) return (int)launch_wgmma(a, st);
  if (a.variant != kFma && a.variant != kMmaSync && a.variant != kStem)
    return (int)cudaErrorInvalidValue;
  if (a.depthwise) {
    const dim3 grid((unsigned)((M + kStatRows - 1) / kStatRows),
                    (a.Cout + kDwC - 1) / kDwC);
    if (a.Cin != a.Cout || grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (a.is_bf16)
      conv_depthwise_kernel<bf16><<<grid, kDwC * kDwP, 0, st>>>(a);
    else
      conv_depthwise_kernel<float><<<grid, kDwC * kDwP, 0, st>>>(a);
  } else if (a.variant == kStem) {
    const int smem = stem_smem_bytes(a);
    const long n_tiles = (a.Cout + kBN - 1) / kBN;
    if (smem < 0 || n_tiles > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        conv_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    // two blocks an SM, each walking M tiles (B staged once a block)
    const long m_tiles = (M + kStemBM - 1) / kStemBM;
    conv_stem_kernel<<<dim3((unsigned)std::min<long>(m_tiles, 2L * a.sms),
                            (unsigned)n_tiles), 128, smem, st>>>(a);
  } else if (a.is_bf16) {
    // 128-row tiles, or 64-row ones when 128-row tiles would not give
    // every SM two blocks (the small-M convs of the late stages)
    const long n_tiles = (a.Cout + kBN - 1) / kBN;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    if ((M + 127) / 128 * n_tiles >= 2L * a.sms)
      conv_bf16_kernel<2><<<dim3((unsigned)((M + 127) / 128), n_tiles), 128, 0,
                            st>>>(a);
    else
      conv_bf16_kernel<1><<<dim3((unsigned)((M + 63) / 64), n_tiles), 128, 0,
                            st>>>(a);
  } else {
    const dim3 grid((unsigned)((M + kFM - 1) / kFM), (a.Cout + kFN - 1) / kFN);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    conv_f32_kernel<<<grid, 256, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes: ``args`` points at a
// FusedConvArgs. Each returns 0 (cudaSuccess) or the cudaError_t of the
// refused or failed launch; arguments it cannot take give
// cudaErrorInvalidValue. The caller checks shapes, dtypes, devices,
// contiguity and 16-byte alignment of x and w before calling.

// conv + epilogue, one store
extern "C" int fused_conv(const void* args, void* stream) {
  const FusedConvArgs& a = *static_cast<const FusedConvArgs*>(args);
  if (a.stats) return (int)cudaErrorInvalidValue;
  return launch(a, stream);
}

// The stats form: conv, no epilogue, and the moment slab at a.stats
// ([2, ceil(M / 64), Cout] f32, every slot written).
extern "C" int fused_conv_stats(const void* args, void* stream) {
  const FusedConvArgs& a = *static_cast<const FusedConvArgs*>(args);
  if (!a.stats || a.n_stages != 0)
    return (int)cudaErrorInvalidValue;
  return launch(a, stream);
}
