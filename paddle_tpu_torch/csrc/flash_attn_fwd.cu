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
// the SM: a block keeps its query rows' running max, running sum and
// output accumulator in f32 registers and streams K/V tiles through
// shared memory, so HBM traffic is q, k, v read once per query tile and
// out/lse written once. Reaching the tensor-core rate takes wgmma (the
// only path to it), operands fed by TMA without the math waiting on them,
// and no per-element work on tiles that need no mask.
//
// Three variants, picked by the wrapper from (dtype, D):
//   * wgmma (bf16, D 64 and 128; the flagship's path): one block of three
//     warpgroups per (b*h, 128-query tile); heads are launched in groups
//     of 16 so that a group's K and V stay in L2, the heaviest causal
//     tiles of the group first. Warpgroup 0 is the producer and gives up
//     its registers (setmaxnreg 24): one thread loads the Q tile once and
//     keeps TMA loads of 128-key K and V tiles in flight through two
//     two-stage rings in shared memory (128-byte swizzle), each stage with
//     a full and an empty mbarrier. Warpgroups 1 and 2 are consumers
//     (setmaxnreg 240), 64 query rows each: S = Q K^T on wgmma with Q and
//     K read from shared memory, the online softmax in registers (exp2
//     with log2(e)/sqrt(D) folded into the score scale, the Pallas
//     kernel's exp2 mode), P rounded to bf16 and re-packed from the S
//     accumulators into wgmma A fragments, and O += P V on wgmma with V as
//     the transposed (MN-major) B operand. Tile i's S is issued with tile
//     i-1's P V, so one wait covers both, and the two consumers take the
//     tensor cores in turns (named barriers): one's softmax runs while the
//     other's products do. K/V tiles go from the last to the first, so the
//     one tile that crosses the diagonal (or holds the ragged edge) comes
//     first and is the only one masked;
//   * mma_sync (bf16, D 32): 4 warps on mma.sync.m16n8k16 over 64-row
//     query tiles and synchronously loaded 64-key tiles, every tile
//     masked element by element;
//   * fma (f32): 256 threads, 4 per query row, each owning D/4 columns;
//     scalar FMA in full f32 (no TF32), K/V tiles of 32 keys.
// All three stop causal blocks at the diagonal (the Pallas kernel's
// _kb_clamp skip) and mask the ragged edge (T not a multiple of the
// tile): key rows past T are zero-filled and scored -inf, query rows
// past T are not stored. lse is returned in natural log.
// The kernel launches on the caller's stream and allocates nothing.

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16, D 64 and 128: wgmma, TMA, a K/V ring -----------------------------
constexpr int kWgBM = 128;     // query rows per block (64 per consumer)
constexpr int kWgBN = 128;     // keys per K/V tile
constexpr int kWgStages = 2;   // K/V ring depth
constexpr int kWgThreads = 384;

struct alignas(64) WgParams {
  CUtensorMap tq, tk, tv;  // [B, T, H, D] bf16, boxes of 64 columns
  bf16* o;
  float* lse;
  int T;
  int H;
  int BH;
  int causal;
  float scale_log2;
};

// shared memory, in bytes from a 1024-aligned base: Q, then the ring's K
// and V tiles, then the mbarriers; every tile is D/64 sub-tiles of
// [rows][64] bf16
template <int D>
struct WgFwdSmem {
  static constexpr int kQ = kWgBM * D * 2;
  static constexpr int kKV = kWgBN * D * 2;
  static constexpr int kQSub = kWgBM * 128;   // one sub-tile of Q
  static constexpr int kKVSub = kWgBN * 128;  // one sub-tile of K or V
  static constexpr int q = 0;
  static constexpr int k = kQ;
  static constexpr int v = k + kWgStages * kKV;
  static constexpr int bars = v + kWgStages * kKV;
  static constexpr int total = bars + 128 + 1024;  // + alignment slack
};

// The online softmax of one 64 x 128 score tile held in the wgmma
// accumulator layout (rows r0 = row_a and row_b = row_a + 8 per thread):
// scaled into log2 units and, for the tile that crosses the diagonal or
// the ragged edge, masked; the running row maxima over the quad, O and l
// rescaled, P = exp2(S - m) summed into l in f32 and rounded to bf16 A
// fragments for O += P V.
template <int D>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kWgBN / 2], float (&o)[D / 2], float (&m_r)[2],
    float (&l_r)[2], uint32_t (&pa)[kWgBN / 16][4], bool masked, int k0,
    int row_a, int T, int causal, float scale_log2, int t4) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2;
      if (masked) {
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = row_a + (e < 2 ? 0 : 8);
        if (col >= T || (causal && col > row)) x = -INFINITY;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    const float alpha = exp2f(m_r[r] - base[r]);
    m_r[r] = mx[r];
    l_r[r] *= alpha;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * r] *= alpha;
      o[4 * j + 2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
    const float p0 = exp2f(sc[4 * j] - base[0]);
    const float p1 = exp2f(sc[4 * j + 1] - base[0]);
    const float p2 = exp2f(sc[4 * j + 2] - base[1]);
    const float p3 = exp2f(sc[4 * j + 3] - base[1]);
    l_r[0] += p0 + p1;
    l_r[1] += p2 + p3;
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
}

// S = Q K^T for one consumer: 64 query rows x 128 keys, depth D in k16
// steps, Q and K both K-major
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[kWgBN / 2], uint32_t sQ,
                                        uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<kWgBN, 0, 0>(sc,
                          desc_k(sQ + (kk >> 2) * (kWgBM * 128) + off),
                          desc_k(sK + (kk >> 2) * (kWgBN * 128) + off),
                          kk > 0);
  }
}

// O += P V: P from registers, V [keys][D] the MN-major B operand
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kWgBN / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk)
    wgmma_rs<D, 1>(o, pa[kk], desc_mn(sV + kk * 2048, kWgBN * 128), 1);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  using L = WgFwdSmem<D>;
  constexpr int kSub = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = align1024(smem_wg);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_full = bar_q + 1;
  uint64_t* k_empty = k_full + kWgStages;
  uint64_t* v_full = k_empty + kWgStages;
  uint64_t* v_empty = v_full + kWgStages;

  const int T = p.T, H = p.H;
  const int n_qt = (T + kWgBM - 1) / kWgBM;
  int bh, rank;
  group_order(blockIdx.x, p.BH, n_qt, bh, rank);
  const int b = bh / H, h = bh % H;
  const int q0 = (n_qt - 1 - rank) * kWgBM;  // the heaviest first
  const int kv_end = p.causal ? min(T, q0 + kWgBM) : T;
  const int n_kt = (kv_end + kWgBN - 1) / kWgBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 2 * 128);  // every consumer thread
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 2 * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q once, then K and V tiles from the last to the first
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, L::kQ);
      for (int c = 0; c < kSub; ++c)
        tma_load_4d(smem + L::q + c * L::kQSub, &p.tq, bar_q, c * 64, h, q0,
                    b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kWgStages, k0 = (n_kt - 1 - i) * kWgBN;
        const uint32_t ph = ((i / kWgStages) & 1) ^ 1;
        mbar_wait(&k_empty[s], ph);
        mbar_arrive_expect_tx(&k_full[s], L::kKV);
        for (int c = 0; c < kSub; ++c)
          tma_load_4d(smem + L::k + s * L::kKV + c * L::kKVSub, &p.tk,
                      &k_full[s], c * 64, h, k0, b);
        mbar_wait(&v_empty[s], ph);
        mbar_arrive_expect_tx(&v_full[s], L::kKV);
        for (int c = 0; c < kSub; ++c)
          tma_load_4d(smem + L::v + s * L::kKV + c * L::kKVSub, &p.tv,
                      &v_full[s], c * 64, h, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each. Tile i's S = Q K^T is issued
    // with tile i-1's O += P V, so one wait covers both and the softmax
    // of tile i runs while the other consumer's products run
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_a = q0 + 64 * cw + 16 * warp + g, row_b = row_a + 8;
    const uint32_t sQ = smem_u32(smem + L::q) + cw * 64 * 128;
    const uint32_t sK0 = smem_u32(smem + L::k);
    const uint32_t sV0 = smem_u32(smem + L::v);

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    uint32_t pa[kWgBN / 16][4];  // P of the previous tile, bf16

    if (cw == 1) turn_pass(cw);  // consumer 0 takes the first turn
    mbar_wait(bar_q, 0);
    {  // tile 0 (the last, the only one that can need a mask): S alone
      const int k0 = (n_kt - 1) * kWgBN;
      float sc[kWgBN / 2];
      mbar_wait(&k_full[0], 0);
      turn_wait(cw);
      wgmma_fence();
      issue_s<D>(sc, sQ, sK0);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&k_empty[0]);
      softmax_tile<D>(sc, o, m_r, l_r, pa, p.causal || k0 + kWgBN > T, k0,
                      row_a, T, p.causal, p.scale_log2, t4);
    }
    for (int i = 1; i < n_kt; ++i) {
      const int s = i % kWgStages, sp = (i - 1) % kWgStages;
      float sc[kWgBN / 2];
      mbar_wait(&k_full[s], (i / kWgStages) & 1);
      mbar_wait(&v_full[sp], ((i - 1) / kWgStages) & 1);
      turn_wait(cw);
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, pa, sV0 + sp * L::kKV);
      issue_s<D>(sc, sQ, sK0 + s * L::kKV);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      fence_regs(sc);
      mbar_arrive(&v_empty[sp]);
      mbar_arrive(&k_empty[s]);
      const int k0 = (n_kt - 1 - i) * kWgBN;
      softmax_tile<D>(sc, o, m_r, l_r, pa, false, k0, row_a, T, p.causal,
                      p.scale_log2, t4);
    }
    {  // the last tile's P V
      const int sp = (n_kt - 1) % kWgStages;
      mbar_wait(&v_full[sp], ((n_kt - 1) / kWgStages) & 1);
      turn_wait(cw);
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, pa, sV0 + sp * L::kKV);
      wgmma_commit();
      if (cw == 0) turn_pass(cw);  // consumer 1 takes the last turn
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&v_empty[sp]);
    }

    // finalize: full row sums across the 4 threads of a row quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    const float inv_a = l_r[0] > 0.f ? 1.f / l_r[0] : 0.f;
    const float inv_b = l_r[1] > 0.f ? 1.f / l_r[1] : 0.f;
    const long rs = (long)H * D;
    bf16* og = p.o + ((long)b * T * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row_a < T)
        *reinterpret_cast<uint32_t*>(og + (long)row_a * rs + col) =
            pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (row_b < T)
        *reinterpret_cast<uint32_t*>(og + (long)row_b * rs + col) =
            pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
    if (t4 == 0) {
      float* lse = p.lse + (long)bh * T;
      if (row_a < T) lse[row_a] = m_r[0] * kLn2 + logf(l_r[0]);
      if (row_b < T) lse[row_b] = m_r[1] * kLn2 + logf(l_r[1]);
    }
  }
}

// ---- bf16, D 32: mma.sync ---------------------------------------------------
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
cudaError_t launch_wgmma(const Params& p, int B, int H, cudaStream_t stream) {
  using L = WgFwdSmem<D>;
  WgParams w;
  cudaError_t err = encode_bthd(&w.tq, p.q, B, p.T, H, D, kWgBM);
  if (err == cudaSuccess) err = encode_bthd(&w.tk, p.k, B, p.T, H, D, kWgBN);
  if (err == cudaSuccess) err = encode_bthd(&w.tv, p.v, B, p.T, H, D, kWgBN);
  if (err != cudaSuccess) return err;
  w.o = static_cast<bf16*>(p.o);
  w.lse = p.lse;
  w.T = p.T;
  w.H = H;
  w.BH = B * H;
  w.causal = p.causal;
  w.scale_log2 = p.scale_log2;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::total);
  if (err != cudaSuccess) return err;
  const long blocks = (long)B * H * ((p.T + kWgBM - 1) / kWgBM);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<D><<<(unsigned)blocks, kWgThreads, L::total,
                              stream>>>(w);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma_sync(const Params& p, int BH, cudaStream_t stream) {
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

// the wrapper's variant codes (ops/cuda_kernels.py FLASH_FWD_VARIANTS)
enum Variant { kFma = 0, kMmaSync = 1, kWgmma = 2 };

}  // namespace

// Plain C entry point, bound with ctypes. `variant` is the wrapper's pick
// for (dtype, D): fma for f32, mma_sync for bf16 at D 32, wgmma for bf16
// at D 64 and 128. Returns 0 (cudaSuccess) or the cudaError_t of the
// refused or failed launch; a variant that does not take D gives
// cudaErrorInvalidValue. The caller checks shapes, dtypes, devices,
// contiguity and 16-byte alignment before calling.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int T, int H, int D,
                              int variant, int causal, void* stream) {
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
  if (variant == kWgmma) {
    if (D == 64) err = launch_wgmma<64>(p, B, H, st);
    else if (D == 128) err = launch_wgmma<128>(p, B, H, st);
  } else if (variant == kMmaSync) {
    if (D == 32) err = launch_mma_sync<32>(p, BH, st);
  } else if (variant == kFma) {
    if (D == 32) err = launch_f32<32>(p, BH, st);
    else if (D == 64) err = launch_f32<64>(p, BH, st);
    else if (D == 128) err = launch_f32<128>(p, BH, st);
  }
  return (int)err;
}
