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
// narrow 1x1 convs of the first stage and the stem below it (HBM bound).
// Fusing the epilogue removes the unfused path's extra round trips of
// the conv output through HBM (batch norm, add, relu each read and write
// it once more).
//
// Design (a first version; TMA, wgmma and warp specialisation come
// later):
//   * implicit GEMM: M = N*Ho*Wo output pixels, N = Cout, K = KH*KW*Cin
//     in (kh, kw, ci) order, the order of the NHWC input and the
//     [Cout, KH, KW, Cin] weight, so a run of 8 k values is 16
//     contiguous bytes of both whenever Cin % 8 == 0;
//   * the input is read unpadded: each load checks the tap's row and
//     column against the image and reads 0 outside it (no slack rows, no
//     reshape-and-take, no padded copy); k past K reads 0, which
//     zero-pads K = 147 of the 7x7 stem with Cin = 3 to the tile depth;
//   * bf16: 128 threads per 128 x 64 output tile (64 x 64 where 128-row
//     tiles would give the SMs fewer than two blocks each), each warp 32
//     (16) rows x 64 columns on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate); tiles of 32 k values are staged in shared memory with
//     a padded pitch that makes the ldmatrix fragment reads conflict-free;
//     when Cin % 8 == 0 they come in by cp.async through a ring of three,
//     so two are in flight while one is multiplied; the output tile is
//     staged in shared memory (the same bytes) and stored as 16-byte rows
//     of 8 channels;
//   * f32: 256 threads per 64 x 64 tile, 4 x 4 outputs a thread, scalar
//     FMA in full f32 (no TF32);
//   * depthwise: a block per 64 pixels by 32 channels, a thread per
//     channel and eighth of the pixels, a multiply-add per tap in f32;
//   * the stats form reduces what each block already holds: the bf16
//     kernel its f32 tile staged in shared memory, the f32 kernel its
//     register tile through shared memory, the depthwise kernel its
//     per-thread sums; one slot per 64 rows, so a block of 128 rows
//     writes two;
//   * the epilogue is a list of opcodes (FusedConvArgs) interpreted on
//     the accumulators, 8 channels of a pixel at a time in the bf16
//     kernel (one decode, 16-byte operand loads); every thread of the
//     grid walks the same list, so the branches do not diverge.
// The kernel launches on the caller's stream and allocates nothing.

#include "common.cuh"

namespace {

constexpr int kMaxAux = 8;
constexpr int kMaxStages = 8;

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
};

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

// The stage list on V f32 accumulator values of one output pixel m,
// channels co0 .. co0 + V - 1: each stage is decoded once for the V.
template <int V>
__device__ void epilogue(const FusedConvArgs& a, float (&y)[V], long m,
                         int co0) {
  for (int s = 0; s < a.n_stages; ++s) {
    const int code = a.stage_code[s];
    const float p0 = a.stage_p0[s], p1 = a.stage_p1[s];
    float b[V], c[V];
    switch (a.stage_op[s]) {
      case kAffine:
        load_aux<V>(a, a.stage_a[s], m, co0, b);
        load_aux<V>(a, a.stage_b[s], m, co0, c);
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
        load_aux<V>(a, a.stage_a[s], m, co0, b);
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
  const int g = lane >> 2, t4 = lane & 3;
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

  // epilogue: the f32 tile goes through shared memory so that each thread
  // then runs the stages on 8 consecutive channels of one pixel and
  // stores them as one 16-byte vector (rows of the NHWC output are
  // contiguous); element e of mma tile (mt, nt) is row g (+8 for e >= 2),
  // column 2*t4 (+1 for odd e)
  __syncthreads();
  float* sC = reinterpret_cast<float*>(smem);
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

int launch(const FusedConvArgs& a, void* stream) {
  if (a.n_aux < 0 || a.n_aux > kMaxAux || a.n_stages < 0 ||
      a.n_stages > kMaxStages || a.N <= 0 || a.Ho <= 0 || a.Wo <= 0 ||
      a.Cin <= 0 || a.Cout <= 0 || a.KH <= 0 || a.KW <= 0 || a.sh <= 0 ||
      a.sw <= 0)
    return (int)cudaErrorInvalidValue;
  const long M = (long)a.N * a.Ho * a.Wo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.depthwise) {
    const dim3 grid((unsigned)((M + kStatRows - 1) / kStatRows),
                    (a.Cout + kDwC - 1) / kDwC);
    if (a.Cin != a.Cout || grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (a.is_bf16)
      conv_depthwise_kernel<bf16><<<grid, kDwC * kDwP, 0, st>>>(a);
    else
      conv_depthwise_kernel<float><<<grid, kDwC * kDwP, 0, st>>>(a);
  } else if (a.is_bf16) {
    // 128-row tiles, or 64-row ones when 128-row tiles would not give
    // every SM two blocks (the small-M convs of the late stages)
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
    }
    const long n_tiles = (a.Cout + kBN - 1) / kBN;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    if ((M + 127) / 128 * n_tiles >= 2L * sms)
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
