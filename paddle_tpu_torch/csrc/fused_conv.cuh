// The fused conv's shared part: its arguments (FusedConvArgs, which
// cuda_kernels._FusedConvArgs mirrors field for field), the epilogue's
// stage interpreter, the host's cache of tensor maps and the helpers
// every variant uses. fused_conv.cu (the stem and wgmma kernels and the C
// entry points), the mma.sync kernels' sources (fused_conv_tf32.cu,
// fused_conv_mma_sync.cu) and the depthwise kernel's
// (fused_conv_depthwise.cu) include it; they compile in parallel into one
// library (ops/_build.py).
#pragma once

#include <cuda.h>

#include <atomic>
#include <cstring>

#include "common.cuh"

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
  // output tile's width (wgmma, tf32, mma_sync), K's splits (wgmma: the
  // blocks that share an output tile's K; tf32 and mma_sync: the warps of
  // a block that do), the SM count
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
  // the depthwise kernel's tile (cuda_kernels.depthwise_tile): output
  // rows, strips of kDwCols outputs across, channels of a block; blocks
  // along the tiles (the stats form's slots); halo buffers of its ring
  int dw_rows, dw_strips, dw_chans, dw_blocks, dw_bufs;
};

// cuda_kernels.FUSED_CONV_VARIANTS, in order
enum Variant { kDepthwise = 0, kMmaSync = 1, kWgmma = 2, kStem = 3,
               kTf32 = 4 };

// output rows (pixels) per slot of the stats form's slab (every variant
// but the depthwise one, whose slot is a block: dw_blocks slots)
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
// co0 .. co0 + V - 1 (V = 4 or 8 only where co0 + V <= Cout): one decode
// of the kind for the V values, and vector loads where the address
// allows.
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
    } else if (V == 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 4 && j < V; ++j) b[j] = __bfloat162float(h[j]);
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
    } else if (V == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      const float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4 && j < V; ++j) b[j] = r[j];
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// The (kh, kw, ci) of flat k.
__device__ __forceinline__ void split_k(const FusedConvArgs& a, int k, int& kh,
                                        int& kw, int& ci) {
  ci = k % a.Cin;
  const int khw = k / a.Cin;
  kw = khw % a.KW;
  kh = khw / a.KW;
}

// ---- shared by the mma.sync kernels --------------------------------------
constexpr int kBN = 64;        // the stem's output tile width
constexpr int kLDC = kBN + 4;  // pitch of its staged f32 output tile
constexpr int kStemBM = 128;   // the stem kernel's output rows a block
constexpr int kStemLoads = 8;  // its 16-byte loads in flight a thread
constexpr int kStemRun = 24;   // elements of A it copies in one batch
constexpr int kSmemLimit = 232448;  // 227 KB, a block's most

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

// Four 8x8 b16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

}  // namespace

// The mma.sync kernels' launchers (fused_conv_tf32.cu, f32;
// fused_conv_mma_sync.cu, bf16): ``args`` a FusedConvArgs; 0
// (cudaSuccess) or the launch's cudaError_t.
extern "C" int fused_conv_tf32_launch(const void* args, void* stream);
extern "C" int fused_conv_mma_sync_launch(const void* args, void* stream);
// The depthwise kernel's launcher (fused_conv_depthwise.cu), both forms.
extern "C" int fused_conv_depthwise_launch(const void* args, void* stream);
