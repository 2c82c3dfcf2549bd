// Flash-attention forward for Hopper (sm_90a), bf16 and f32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py::_flash_kernel
// (launched by _flash_pallas_call). Same function:
//   out = softmax(q k^T / sqrt(D) [+ causal mask]) v
//   lse = natural-log logsumexp of each score row (f32)
// on q, k, v, out laid out [B, T, H, D] (contiguous; the flash_attention
// op's reshape of [B, T, H*D], so no transposes are needed) and lse laid
// out [B, H, T].
//
// What bounds it on this card. Causal attention at the flagship shape
// (T=2048, D=128) does about T/2 multiply-adds per byte it must move, so
// it is far above the H100's ~295 ops/byte balance point: the bound is
// the tensor-core rate, not HBM. The [T, T] score matrix never leaves
// the SM: each block keeps its 64 query rows' running max, running sum
// and output accumulator in f32 registers and streams K/V tiles of 64
// keys through shared memory, so HBM traffic is q, k, v read once per
// query tile and out/lse written once.
//
// Design (a first, simple version; wgmma, TMA and a K/V ring come later):
//   * one thread block per (b*h, 64-row query tile); grid y walks the
//     query tiles from the last (heaviest under the causal mask) first;
//   * bf16: 4 warps, each owns 16 query rows; S = Q K^T and O += P V run
//     on mma.sync.m16n8k16 (bf16 in, f32 accumulate); Q lives in
//     registers as A fragments, P is re-packed from the S accumulator
//     registers into A fragments without touching shared memory;
//   * f32: 256 threads, 4 per query row, each owning D/4 columns; scalar
//     FMA in full f32 (no TF32), K/V tiles of 32 keys;
//   * causal blocks stop at the diagonal (the Pallas kernel's
//     _kb_clamp skip); the ragged edge (T not a multiple of the tile) is
//     masked: key rows past T are zero-filled and scored -inf, query
//     rows past T are not stored;
//   * the online softmax runs in exp2 with log2(e)/sqrt(D) folded into
//     the score scale (the Pallas kernel's exp2 mode); lse is returned
//     in natural log.
// The kernel launches on the caller's stream and allocates nothing.

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int T;
  int H;
  int causal;
  float scale_log2;  // log2(e) / sqrt(D)
};

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int BM = kBlockM, BN = 64;
  constexpr int LDS = D + 8;  // padded pitch: conflict-free fragment reads
  constexpr int KC = D / 16;  // k-chunks of the QK^T product
  constexpr int DN = D / 8;   // n-tiles of the output
  constexpr int NT = BN / 8;  // n-tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LDS;
  __nv_bfloat16* sV = sK + BN * LDS;

  const int T = p.T, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const long row_stride = (long)H * D;
  const long head_off = ((long)b * T * H + h) * D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + head_off;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + head_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + head_off;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + head_off;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r_local = warp * 16 + g;  // this thread's rows: r_local, +8
  const int row_a = q0 + r_local, row_b = row_a + 8;

  load_tile_bf16<BM, D, LDS, 128>(sQ, qg, q0, T, row_stride);
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const __nv_bfloat16* a0 = sQ + r_local * LDS + kc * 16 + 2 * t4;
    const __nv_bfloat16* a1 = a0 + 8 * LDS;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(a0);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(a1);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(a1 + 8);
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int kv_end = p.causal ? min(T, q0 + BM) : T;
  const int n_kt = (kv_end + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<BN, D, LDS, 128>(sK, kg, k0, T, row_stride);
    load_tile_bf16<BN, D, LDS, 128>(sV, vg, k0, T, row_stride);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = sK + (j * 8 + g) * LDS + 2 * t4;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kc * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 8);
        mma_bf16_16816(s[j], qf[kc], b0, b1);
      }
    }

    // scale into log2 units, mask, and take each row's max
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool live = col < T && (!p.causal || col <= row);
        s[j][e] = live ? s[j][e] * p.scale_log2 : -INFINITY;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      const float alpha = exp2f(m_r[i] - base[i]);
      m_r[i] = mx[i];
      l_r[i] *= alpha;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        acc[dn][2 * i] *= alpha;
        acc[dn][2 * i + 1] *= alpha;
      }
    }

    // P = exp2(S - m), summed in f32 and re-packed as bf16 A fragments
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - base[0]);
      const float p1 = exp2f(s[j][1] - base[0]);
      const float p2 = exp2f(s[j][2] - base[1]);
      const float p3 = exp2f(s[j][3] - base[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const __nv_bfloat16* vr = sV + (kk * 16 + 2 * t4) * LDS + dn * 8 + g;
        const uint32_t b0 = pack_raw(vr[0], vr[LDS]);
        const uint32_t b1 = pack_raw(vr[8 * LDS], vr[9 * LDS]);
        mma_bf16_16816(acc[dn], pf[kk], b0, b1);
      }
    }
  }

  // finalize: full row sums across the 4 threads of a row quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const float inv_a = l_r[0] > 0.f ? 1.f / l_r[0] : 0.f;
  const float inv_b = l_r[1] > 0.f ? 1.f / l_r[1] : 0.f;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (row_a < T)
      *reinterpret_cast<uint32_t*>(og + (long)row_a * row_stride + col) =
          pack_bf16(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
    if (row_b < T)
      *reinterpret_cast<uint32_t*>(og + (long)row_b * row_stride + col) =
          pack_bf16(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
  }
  if (t4 == 0) {
    float* lse = p.lse + (long)bh * T;
    if (row_a < T) lse[row_a] = m_r[0] * kLn2 + logf(l_r[0]);
    if (row_b < T) lse[row_b] = m_r[1] * kLn2 + logf(l_r[1]);
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32_kernel(const Params p) {
  constexpr int BM = kBlockM, BN = 32;
  constexpr int DPT = D / 4;  // columns per thread: t4 + 4 * i
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BN * D;

  const int T = p.T, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const long row_stride = (long)H * D;
  const long head_off = ((long)b * T * H + h) * D;
  const float* qg = static_cast<const float*>(p.q) + head_off;
  const float* kg = static_cast<const float*>(p.k) + head_off;
  const float* vg = static_cast<const float*>(p.v) + head_off;
  float* og = static_cast<float*>(p.o) + head_off;

  const int t4 = threadIdx.x & 3;
  const int row = q0 + (threadIdx.x >> 2);
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row < T ? qg[(long)row * row_stride + t4 + 4 * i] * p.scale_log2
                    : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int kv_end = p.causal ? min(T, q0 + BM) : T;
  const int n_kt = (kv_end + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    for (int i = threadIdx.x; i < BN * D / 4; i += 256) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < T) {
        kv = *reinterpret_cast<const float4*>(kg + (long)(k0 + r) * row_stride + c);
        vv = *reinterpret_cast<const float4*>(vg + (long)(k0 + r) * row_stride + c);
      }
      *reinterpret_cast<float4*>(sK + r * D + c) = kv;
      *reinterpret_cast<float4*>(sV + r * D + c) = vv;
    }
    __syncthreads();

    float s[BN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) d = fmaf(qr[i], sK[j * D + t4 + 4 * i], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int col = k0 + j;
      const bool live = col < T && (!p.causal || col <= row);
      s[j] = live ? d : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - base);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float pj = exp2f(s[j] - base);
      l += pj;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(pj, sV[j * D + t4 + 4 * i], acc[i]);
    }
  }

  if (row < T) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      og[(long)row * row_stride + t4 + 4 * i] = acc[i] * inv;
    if (t4 == 0) p.lse[(long)bh * T + row] = m * kLn2 + logf(l);
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int BH, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * 64) * (D + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.T + kBlockM - 1) / kBlockM);
  flash_fwd_bf16_kernel<D><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int BH, cudaStream_t stream) {
  const int smem = 2 * 32 * D * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.T + kBlockM - 1) / kBlockM);
  flash_fwd_f32_kernel<D><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns 0 (cudaSuccess) or the
// cudaError_t of the refused or failed launch; an unsupported D gives
// cudaErrorInvalidValue. The caller checks shapes, dtypes, devices,
// contiguity and 16-byte alignment before calling.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T, int H, int D,
                              int is_bf16, int causal, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (T + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.T = T;
  p.H = H;
  p.causal = causal;
  p.scale_log2 = kLog2e / sqrtf((float)D);
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 32) err = launch_bf16<32>(p, BH, st);
    else if (D == 64) err = launch_bf16<64>(p, BH, st);
    else if (D == 128) err = launch_bf16<128>(p, BH, st);
  } else {
    if (D == 32) err = launch_f32<32>(p, BH, st);
    else if (D == 64) err = launch_f32<64>(p, BH, st);
    else if (D == 128) err = launch_f32<128>(p, BH, st);
  }
  return (int)err;
}
