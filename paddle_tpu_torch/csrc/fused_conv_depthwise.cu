// The fused conv's depthwise kernel for Hopper (sm_90a), f32 and bf16, in
// both forms (fused_conv and fused_conv_stats).
//
// Replaces the depthwise branch of the TPU kernel
// paddle_tpu/ops/pallas_kernels.py::_fconv_kernel (:807-809), which
// paddle_tpu/compiler/passes.py routes every conv2d(groups=C) with a
// [C, 1, KH, KW] filter to:
//   y[n, ho, wo, c] = epilogue(sum over (kh, kw) of
//                     x[n, ho*sh - ph + kh, wo*sw - pw + kw, c] * w[kh, kw, c])
// accumulated in f32, the padding read as 0; the stats form takes no
// stages and also gives each channel's sum and sum of squares of the f32
// conv. x [N, H, W, C], w [KH, KW, C], out [N, Ho, Wo, C] in x's dtype.
//
// What bounds it on this card: bytes. A 3x3 depthwise conv does 9
// multiply-adds an output element, one to two per byte it must move,
// hundreds of times below the H100's balance point; its least time is x
// read once and y written once at 3.35 TB/s.
//
// Design. A block owns a slice of dw_chans channels (128 bytes of a pixel
// where C allows: 32 f32, 64 bf16; more where a tile holds a whole small
// image) and walks output tiles of one image, dw_rows rows by
// dw_strips * kDwCols columns, gridDim.x tiles apart (a persistent grid of
// dw_blocks blocks along the tiles):
//   * the tile's input halo, ((rows - 1) * sh + KH) x ((cols - 1) * sw +
//     KW) pixels of the slice, comes into shared memory by one TMA load of
//     a 4-d tiled map over NHWC, whose out-of-bounds fill gives the
//     padding's and the ragged edges' zeros. A ring of dw_bufs (2 to 4)
//     halo buffers: the loads of the next dw_bufs - 1 tiles are in flight
//     while this tile's arithmetic runs. Each input element is read from
//     device memory once a tile, not once a tap (neighbouring tiles'
//     overlap comes from L2);
//   * a thread owns 4 channels and a strip of kDwCols neighbouring outputs
//     of one row. 3x3 at stride 1 or 2 (MobileNet's) is a template: the
//     taps' weights sit in registers, loaded once a block, and each input
//     column of the strip is read from shared memory once and fed to the
//     outputs it covers (a sliding window: 10 reads for 8 outputs of a row
//     at stride 1). Any other shape loops over its taps, the weights in
//     shared memory. 4 channels and not the 8 of a bf16 16-byte vector:
//     9 taps x 8 channels would hold 72 weights a thread in registers;
//   * the tile fixes image, rows and columns: no division an output;
//   * the epilogue: MobileNet's stage list (the folded batch norm's
//     per-channel affine, then relu, either optional) from the thread's
//     own channels' scale and shift in registers; any other list through
//     the stage interpreter (run_stages) on an output's 4 channels at once,
//     per-channel operands ('c') staged once a block in shared memory,
//     per-sample, whole-tensor and scalar ones read where they are; then
//     one 16-byte (f32) or 8-byte (bf16) store;
//   * the stats form: each thread sums its outputs and their squares per
//     channel over all its tiles, the block adds its threads' sums in a
//     fixed order in shared memory and writes its own slot, blockIdx.x, of
//     the slab [2, dw_blocks, C]: one writer a slot, no atomics, the same
//     bits on every call. (The other variants' slot is 64 output rows;
//     cuda_kernels.fused_conv_slots gives the count.)
// Where a pixel's C channels are not a multiple of 16 bytes (TMA cannot
// take such rows) the block's threads stage the halo with scalar loads,
// one tile at a time, and the rest is the same.

#include <algorithm>
#include <atomic>

#include "fused_conv.cuh"
#include "hopper.cuh"

namespace {

constexpr int kDwCols = 8;       // outputs a thread along W (_DW_COLS)
constexpr int kDwThreads = 256;  // most threads a block (_DW_THREADS)
constexpr int kDwBox = 256;      // a TMA box's most elements a dimension

constexpr int kDwMaxBufs = 4;    // the ring's most halo buffers

struct alignas(64) DwParams {
  CUtensorMap tx;  // x as {C, W, H, N}, box {chans, iw, ir, 1}
  FusedConvArgs a;
  int tma;         // the halo by TMA (else scalar loads, one buffer)
  // the stage list is [affine of two 'c' operands] [relu], each optional:
  // the affine's operands (or -1), relu
  int fast, fast_mul, fast_add, fast_relu;
};

// The tile's geometry and shared memory (cuda_kernels.depthwise_smem_bytes
// mirrors it): from a 128-byte-aligned base, the halo buffers (dw_bufs
// where TMA loads them, else one; after the walk, the stats form's
// per-thread sums), the generic path's weights, the 'c' operands, the
// mbarriers; 128 bytes of slack for the alignment.
struct DwGeom {
  int ct, tw, ir, iw, tiles_h, tiles_w, threads;
  long tiles;
  int box_bytes, halo, w_off, aux_off, bar_off, smem;
};

__host__ __device__ inline DwGeom dw_geom(const FusedConvArgs& a, int tma,
                                          int generic) {
  DwGeom g;
  const int e = a.is_bf16 ? 2 : 4;
  g.ct = a.dw_chans / 4;
  g.tw = a.dw_strips * kDwCols;
  g.ir = (a.dw_rows - 1) * a.sh + a.KH;
  g.iw = (g.tw - 1) * a.sw + a.KW;
  g.tiles_h = (a.Ho + a.dw_rows - 1) / a.dw_rows;
  g.tiles_w = (a.Wo + g.tw - 1) / g.tw;
  g.tiles = (long)a.N * g.tiles_h * g.tiles_w;
  g.threads = g.ct * a.dw_rows * a.dw_strips;
  g.box_bytes = g.ir * g.iw * a.dw_chans * e;
  g.halo = (g.box_bytes + 127) / 128 * 128;
  const int red = 2 * a.dw_rows * a.dw_strips * a.dw_chans * 4;
  const int bufs = (tma ? a.dw_bufs : 1) * g.halo;
  g.w_off = bufs > red ? bufs : red;
  g.aux_off = g.w_off + (generic ? a.KH * a.KW * a.dw_chans * 4 : 0);
  g.bar_off = g.aux_off + a.n_aux * a.dw_chans * 4;
  g.smem = 128 + g.bar_off + 8 * kDwMaxBufs;
  return g;
}

// 4 consecutive elements from shared or global memory (16 bytes f32, 8
// bytes bf16, aligned), in f32
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float elem(const float* p) { return *p; }
__device__ __forceinline__ float elem(const bf16* p) {
  return __bfloat162float(*p);
}

// the first n (1..4) of 4 elements at p: vector loads where vec, else one
// at a time; the rest 0
template <typename T>
__device__ __forceinline__ void ld4n(const T* p, int n, bool vec,
                                     float (&v)[4]) {
  if (vec) {
    ld4(p, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < n ? elem(p + q) : 0.f;
}

// MODE: 1, 3x3 at stride 1; 2, 3x3 at stride 2 (both strides); 0, any
// taps and strides
template <typename T, int MODE>
__global__ void __launch_bounds__(kDwThreads, 2)
    conv_dw_kernel(const __grid_constant__ DwParams p) {
  constexpr bool kFast = MODE != 0;
  const FusedConvArgs& a = p.a;
  const DwGeom g = dw_geom(a, p.tma, !kFast);
  extern __shared__ unsigned char smem_dw_raw[];
  unsigned char* smem =
      smem_dw_raw + ((128u - (smem_u32(smem_dw_raw) & 127u)) & 127u);
  T* buf0 = reinterpret_cast<T*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + g.w_off);
  float* s_aux = reinterpret_cast<float*>(smem + g.aux_off);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + g.bar_off);

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  T* out = static_cast<T*>(a.out);
  const int C = a.Cout, cs = a.dw_chans;
  const int c0 = blockIdx.y * cs;
  const int tid = threadIdx.x;
  const int cq = tid % g.ct, pt = tid / g.ct;
  const int ty = pt / a.dw_strips, sxi = pt - ty * a.dw_strips;
  const int c = c0 + 4 * cq;
  const int nvalid = min(4, C - c);  // <= 0: no channel of the tensor
  const bool vec4 = (C & 3) == 0;    // 4-channel groups aligned in memory

  // once a block: the per-channel operands, the weights
  for (int i = 0; i < a.n_aux; ++i) {
    if (a.aux_kind[i] != kAuxC) continue;
    for (int cc = tid; cc < cs; cc += g.threads)
      s_aux[i * cs + cc] =
          c0 + cc >= C ? 0.f
          : a.aux_bf16[i]
              ? __bfloat162float(static_cast<const bf16*>(a.aux[i])[c0 + cc])
              : static_cast<const float*>(a.aux[i])[c0 + cc];
  }
  float wr[kFast ? 9 : 1][4];
  if constexpr (kFast) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (nvalid > 0)
        ld4n(w + (long)t * C + c, nvalid, vec4, wr[t]);
      else
        wr[t][0] = wr[t][1] = wr[t][2] = wr[t][3] = 0.f;
    }
  } else {
    const int taps = a.KH * a.KW;
    for (int i = tid; i < taps * cs; i += g.threads) {
      const int t = i / cs, cc = i - t * cs;
      s_w[i] = c0 + cc < C ? elem(w + (long)t * C + c0 + cc) : 0.f;
    }
  }
  // the fast epilogue's scale and shift of the thread's channels
  float sc[4] = {1.f, 1.f, 1.f, 1.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
  if (p.fast && p.fast_mul >= 0 && nvalid > 0) {
    ld4n(static_cast<const float*>(a.aux[p.fast_mul]) + c, nvalid, false,
         sc);
    ld4n(static_cast<const float*>(a.aux[p.fast_add]) + c, nvalid, false,
         sh);
  }
  const int nbuf = p.tma ? a.dw_bufs : 1;
  if (p.tma && tid == 0) {
    for (int b = 0; b < nbuf; ++b) mbar_init(&bar[b], 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int per_img = g.tiles_h * g.tiles_w;
  // tile t's image and first output row and column
  auto locate = [&](long t, int& n, int& ho0, int& wo0) {
    n = (int)(t / per_img);
    const int r = (int)(t - (long)n * per_img);
    const int th = r / g.tiles_w;
    ho0 = th * a.dw_rows;
    wo0 = (r - th * g.tiles_w) * g.tw;
  };
  auto issue = [&](long t, int b) {
    int n, ho0, wo0;
    locate(t, n, ho0, wo0);
    mbar_arrive_expect_tx(&bar[b], g.box_bytes);
    tma_load_4d(smem + b * g.halo, &p.tx, &bar[b], c0, wo0 * a.sw - a.pw,
                ho0 * a.sh - a.ph, n);
  };
  // the ring's first nbuf - 1 tiles
  if (p.tma && tid == 0)
    for (int b = 0; b < nbuf - 1; ++b)
      if (blockIdx.x + (long)b * gridDim.x < g.tiles)
        issue(blockIdx.x + (long)b * gridDim.x, b);

  float s[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
  int it = 0;
  for (long t = blockIdx.x; t < g.tiles; t += gridDim.x, ++it) {
    int n, ho0, wo0;
    locate(t, n, ho0, wo0);
    const int b = it % nbuf;
    const T* buf = reinterpret_cast<const T*>(smem + b * g.halo);
    if (p.tma) {
      // the tile nbuf - 1 ahead goes into the buffer read in the last
      // turn, which ended with a barrier
      const long ahead = t + (long)(nbuf - 1) * gridDim.x;
      if (tid == 0 && ahead < g.tiles) issue(ahead, (it + nbuf - 1) % nbuf);
      mbar_wait(&bar[b], (it / nbuf) & 1);
    } else {
      const int hi0 = ho0 * a.sh - a.ph, wi0 = wo0 * a.sw - a.pw;
      const int total = g.ir * g.iw * cs;
      for (int i = tid; i < total; i += g.threads) {
        const int pix = i / cs, cc = i - pix * cs;
        const int lr = pix / g.iw, lc = pix - lr * g.iw;
        const int hi = hi0 + lr, wi = wi0 + lc, ch = c0 + cc;
        buf0[i] = hi >= 0 && hi < a.H && wi >= 0 && wi < a.W && ch < C
                      ? x[(((long)n * a.H + hi) * a.W + wi) * C + ch]
                      : T(0.f);
      }
      __syncthreads();
    }

    const int ho = ho0 + ty, wo_base = wo0 + sxi * kDwCols;
    if (ho < a.Ho && nvalid > 0 && wo_base < a.Wo) {
      float acc[kDwCols][4];
#pragma unroll
      for (int j = 0; j < kDwCols; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      if constexpr (kFast) {
        constexpr int SW = MODE;
        const T* base =
            buf + ((ty * SW) * g.iw + sxi * kDwCols * SW) * cs + 4 * cq;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const T* row = base + kh * g.iw * cs;
          // input column q of the strip feeds output j = (q - kw) / SW
#pragma unroll
          for (int q = 0; q < (kDwCols - 1) * SW + 3; ++q) {
            float v[4];
            ld4(row + q * cs, v);
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              const int d = q - kw;
              if (d >= 0 && d % SW == 0 && d / SW < kDwCols) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[d / SW][e] =
                      fmaf(v[e], wr[kh * 3 + kw][e], acc[d / SW][e]);
              }
            }
          }
        }
      } else {
        for (int kh = 0; kh < a.KH; ++kh)
          for (int kw = 0; kw < a.KW; ++kw) {
            float wv[4];
            ld4(s_w + (kh * a.KW + kw) * cs + 4 * cq, wv);
            const T* src = buf + ((ty * a.sh + kh) * g.iw +
                                  sxi * kDwCols * a.sw + kw) * cs + 4 * cq;
#pragma unroll
            for (int j = 0; j < kDwCols; ++j) {
              float v[4];
              ld4(src + j * a.sw * cs, v);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[j][e] = fmaf(v[e], wv[e], acc[j][e]);
            }
          }
      }

      // the epilogue, output by output of the strip
      const long m0 = ((long)n * a.Ho + ho) * a.Wo + wo_base;
      T* dst = out + m0 * C + c;
#pragma unroll
      for (int j = 0; j < kDwCols; ++j, dst += C) {
        if (wo_base + j >= a.Wo) break;
        float y[4] = {acc[j][0], acc[j][1], acc[j][2], acc[j][3]};
        if (a.stats) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[e] += y[e];
            ss[e] += y[e] * y[e];
          }
        }
        if (p.fast) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = fmaf(y[e], sc[e], sh[e]);
            if (p.fast_relu) y[e] = y[e] < 0.f ? 0.f : y[e];
          }
        } else {
          const long m = m0 + j;
          run_stages<4>(a, y, [&](int i, float (&v)[4]) {
            switch (a.aux_kind[i]) {
              case kAuxC:
                ld4(s_aux + i * cs + 4 * cq, v);
                return;
              case kAuxS: {
                const float sv =
                    a.aux_bf16[i]
                        ? __bfloat162float(
                              *static_cast<const bf16*>(a.aux[i]))
                        : *static_cast<const float*>(a.aux[i]);
                v[0] = v[1] = v[2] = v[3] = sv;
                return;
              }
              default: {
                // vector loads where the operand's rows keep 4 channels
                // aligned
                const long off =
                    (a.aux_kind[i] == kAuxNC ? (long)n : m) * C + c;
                const uintptr_t at = reinterpret_cast<uintptr_t>(a.aux[i]);
                if (a.aux_bf16[i])
                  ld4n(static_cast<const bf16*>(a.aux[i]) + off, nvalid,
                       vec4 && (at & 7) == 0, v);
                else
                  ld4n(static_cast<const float*>(a.aux[i]) + off, nvalid,
                       vec4 && (at & 15) == 0, v);
              }
            }
          });
        }
        if (vec4) {
          if constexpr (sizeof(T) == 4)
            *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2],
                                                          y[3]);
          else
            *reinterpret_cast<uint2*>(dst) =
                make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < nvalid) store(dst + e, y[e]);
        }
      }
    }
    __syncthreads();  // every thread is done with buf
  }

  if (a.stats) {
    // the halo buffers are free (no load is in flight after the last
    // tile): per channel, the threads' sums in pixel-thread order
    const int P = a.dw_rows * a.dw_strips;
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[pt * cs + 4 * cq + e] = s[e];
      red[(P + pt) * cs + 4 * cq + e] = ss[e];
    }
    __syncthreads();
    for (int cc = tid; cc < cs && c0 + cc < C; cc += g.threads) {
      float bs = 0.f, bss = 0.f;
      for (int q = 0; q < P; ++q) {
        bs += red[q * cs + cc];
        bss += red[(P + q) * cs + cc];
      }
      a.stats[(long)blockIdx.x * C + c0 + cc] = bs;
      a.stats[((long)gridDim.x + blockIdx.x) * C + c0 + cc] = bss;
    }
  }
}

// the kernel's shared-memory limit (the most a block may have, so one
// setting serves every launch), set once a device for each
// instantiation, then the launch
template <typename T, int MODE>
cudaError_t launch_dw(const DwParams& p, const DwGeom& g, cudaStream_t st) {
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((smem_set.load() >> dev) & 1)) {
    err = cudaFuncSetAttribute(conv_dw_kernel<T, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set.fetch_or(1ull << dev);
  }
  const dim3 grid((unsigned)p.a.dw_blocks,
                  (unsigned)((p.a.Cout + p.a.dw_chans - 1) / p.a.dw_chans));
  conv_dw_kernel<T, MODE><<<grid, g.threads, g.smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw_t(const DwParams& p, const DwGeom& g, int mode,
                        cudaStream_t st) {
  switch (mode) {
    case 1: return launch_dw<T, 1>(p, g, st);
    case 2: return launch_dw<T, 2>(p, g, st);
    default: return launch_dw<T, 0>(p, g, st);
  }
}

}  // namespace

extern "C" int fused_conv_depthwise_launch(const void* args, void* stream) {
  const FusedConvArgs& a = *static_cast<const FusedConvArgs*>(args);
  if (!a.depthwise || a.Cin != a.Cout || a.dw_rows < 1 || a.dw_strips < 1 ||
      a.dw_chans < 4 || a.dw_chans % 4 || a.dw_chans > kDwBox ||
      a.dw_blocks < 1 || a.dw_bufs < 2 || a.dw_bufs > kDwMaxBufs)
    return (int)cudaErrorInvalidValue;
  DwParams p;
  std::memset(&p, 0, sizeof p);
  p.a = a;
  const int e = a.is_bf16 ? 2 : 4;
  p.tma = (a.Cout * e) % 16 == 0;
  // MobileNet's stage list: [affine of two f32 'c' operands] [relu]
  p.fast = 1;
  p.fast_mul = p.fast_add = -1;
  p.fast_relu = 0;
  int k = 0;
  if (k < a.n_stages && a.stage_op[k] == kAffine &&
      a.aux_kind[a.stage_a[k]] == kAuxC && !a.aux_bf16[a.stage_a[k]] &&
      a.aux_kind[a.stage_b[k]] == kAuxC && !a.aux_bf16[a.stage_b[k]]) {
    p.fast_mul = a.stage_a[k];
    p.fast_add = a.stage_b[k];
    ++k;
  }
  if (k < a.n_stages && a.stage_op[k] == kAct &&
      a.stage_code[k] == kRelu) {
    p.fast_relu = 1;
    ++k;
  }
  if (k < a.n_stages) p.fast = 0;
  const int mode = a.KH == 3 && a.KW == 3 && a.sh == a.sw &&
                           (a.sh == 1 || a.sh == 2)
                       ? a.sh
                       : 0;
  const DwGeom g = dw_geom(a, p.tma, mode == 0);
  if (g.threads > kDwThreads || g.ir > kDwBox || g.iw > kDwBox ||
      g.smem > kSmemLimit || (p.tma && (a.dw_chans * e) % 16) ||
      (a.Cout + a.dw_chans - 1) / a.dw_chans > 65535 ||
      g.tiles > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (p.tma) {
    const cudaError_t err = cached_map(
        &p.tx,
        {a.x, {a.N, a.H, a.W, a.Cout * 2L + a.is_bf16, a.dw_chans, g.iw,
               g.ir}},
        [&](CUtensorMap* m) {
          return encode_nhwc_tile(m, a.x, a.is_bf16 != 0, a.N, a.H, a.W,
                                  a.Cout, a.dw_chans, g.iw, g.ir);
        });
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(a.is_bf16 ? launch_dw_t<bf16>(p, g, mode, st)
                         : launch_dw_t<float>(p, g, mode, st));
}
