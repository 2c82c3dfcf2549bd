// Flash-attention backward for Hopper (sm_90a), bf16 and f32.
//
// Replaces the three TPU backward kernels of paddle_tpu/ops/pallas_kernels.py:
//   _flash_dkvdq_kernel (launched by _flash_bwd_merged): one kv-major sweep
//       that gives dk, dv and dq        -> flash_attn_bwd_dkvdq
//   _flash_dq_kernel    (launched by _flash_bwd_pallas): the q-major dq pass
//       of the two-pass backward        -> flash_attn_bwd_dq
//   _flash_dkv_kernel   (launched by _flash_bwd_pallas): the kv-major dk/dv
//       pass of the two-pass backward   -> flash_attn_bwd_dkv
// All three recompute the probabilities from the forward's logsumexp and
// share one tile function per dtype, the counterpart of _bwd_p_ds:
//   s  = q k^T / sqrt(D), masked (causal, ragged edge)
//   p  = exp(s - lse)
//   dp = do v^T
//   ds = p (dp - delta),   delta = rowsum(do * o) - g_lse (computed by the
//                          caller in PyTorch, as JAX computes it in XLA)
// and then dv = p^T do, dk = ds^T q / sqrt(D), dq = ds k / sqrt(D).
// Rounding points are the Pallas kernels': bf16 p before p^T do, bf16 ds
// before ds^T q and ds k; every product accumulates in f32.
//
// Layouts: q, k, v, do, dq, dk, dv are [B, T, H, D] (contiguous; the
// flash_attention op's view of [B, T, H*D], so no transposes); lse and
// delta are [B, H, T] f32.
//
// What bounds it on this card. At the flagship training shape (T 2048,
// D 128, causal) the backward does five T x T x D products per head, about
// T/2 multiply-adds per byte it must move: the tensor-core rate bounds it,
// not HBM. As in the forward, the [T, T] matrices never leave the SM.
//
// Design (a first, simple version; wgmma, TMA and pipelined tile loads
// come later):
//   * bf16 on mma.sync.m16n8k16 (bf16 in, f32 accumulate), 4 warps;
//     f32 on scalar FMA in full f32 (no TF32), 256 threads;
//   * kv-major kernels (dkv, dkvdq): a block owns 64 keys (bf16; 32 for
//     f32) and walks the query tiles, from the diagonal on when causal
//     (the Pallas _qi_clamp skip); dk and dv accumulate in registers. In
//     bf16 each warp owns 16 keys and computes the transposed tile S^T,
//     so P^T and dS^T come out of the accumulators already in the A-operand
//     layout of the dv and dk products and never touch shared memory;
//   * q-major kernel (dq): a block owns 64 query rows (32 for f32) and
//     walks the key tiles up to the diagonal (the _kb_clamp skip);
//   * where dq accumulates in the merged kernel: the Pallas kernel writes
//     one dq partial per 1024-key TPU block into a [BH, n_kb, T, D] slab
//     that XLA sums. With 64-key tiles that slab would be 32 partials deep
//     (2 GiB at the training shape), so here each block stages its bf16 dS
//     tile in shared memory, multiplies it by its K tile, and adds the
//     result into one zeroed [B, T, H, D] f32 buffer with atomics (128 MiB
//     at the training shape); the caller casts it to q's dtype. Atomics add
//     in an order that varies from run to run: the two-pass route is the
//     deterministic one;
//   * the ragged edge (T not a multiple of the tile) is masked: rows past T
//     are zero-filled, scored as masked (p = 0) and never stored.
// The kernels launch on the caller's stream and allocate nothing.

#include "common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T], natural log
  const float* delta;  // [B, H, T]
  void* dq;            // dq kernel: [B, T, H, D], input dtype
  float* dq_accum;     // merged kernel: [B, T, H, D] f32, zeroed by the caller
  void* dk;
  void* dv;
  int T;
  int H;
  int causal;
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// f32 rows into shared memory with pitch D + 1 (conflict-free column walks).
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int T,
                                              long row_stride) {
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        row0 + r < T ? src[(long)(row0 + r) * row_stride + c] : 0.f;
  }
}

// The lse (pre-multiplied by log2 e, for exp2) and delta of query rows
// [q0, q0 + ROWS); rows past T get 0 (their p is masked to 0 anyway).
template <int ROWS>
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDelta,
                                               const float* lse,
                                               const float* delta, int q0,
                                               int T) {
  if (threadIdx.x < ROWS) {
    const int q = q0 + threadIdx.x;
    sLse[threadIdx.x] = q < T ? lse[q] * kLog2e : 0.f;
    sDelta[threadIdx.x] = q < T ? delta[q] : 0.f;
  }
}

// Two neighbouring f32 adds: one vector atomic on sm_90 where the toolkit
// has it (CUDA 12.4 and later), else two scalar ones.
__device__ __forceinline__ void atomic_add2(float* addr, float x, float y) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 ||                        \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 4))
  atomicAdd(reinterpret_cast<float2*>(addr), make_float2(x, y));
#else
  atomicAdd(addr, x);
  atomicAdd(addr + 1, y);
#endif
}

// ---- the tile math, bf16 (counterpart of _bwd_p_ds) --------------------------
// One warp, a 16 x NB tile between 16 rows of X and NB rows of Y (both in
// shared memory, pitch D + 8): S = X Y^T and dP = X2 Y2^T on mma.sync, then
//   p  = exp2(S * scale_log2 - lse_log2[q])   (0 where masked)
//   ds = p * (dP - delta[q]).
// q-major kernels pass X = Q, X2 = dO, Y = K, Y2 = V (rows are queries);
// kv-major kernels pass X = K, X2 = V, Y = Q, Y2 = dO (rows are keys), so the
// tile is S^T. p and ds come back in the C layout of m16n8k16: element e of
// n-tile j is row g (+8 for e >= 2), column 8j + 2t + (e & 1), with
// g = lane / 4, t = lane % 4. x0 / y0 are the global indices of X's and Y's
// first rows; xl0 is X's first row within the tile (sLse and sDelta are
// indexed by the query's row within the tile).
template <int D, int NB, bool KV_MAJOR>
__device__ __forceinline__ void bwd_p_ds_bf16(
    const bf16* sX, const bf16* sX2, const bf16* sY, const bf16* sY2,
    const float* sLse, const float* sDelta, int x0, int xl0, int y0, int T,
    int causal, float scale_log2, float (&p)[NB / 8][4],
    float (&ds)[NB / 8][4]) {
  constexpr int LDS = D + 8, KC = D / 16, NT = NB / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4], a2[4];
    const bf16* xr = sX + g * LDS + kc * 16 + 2 * t4;
    const bf16* xr2 = sX2 + g * LDS + kc * 16 + 2 * t4;
    a[0] = ld32(xr);
    a[1] = ld32(xr + 8 * LDS);
    a[2] = ld32(xr + 8);
    a[3] = ld32(xr + 8 * LDS + 8);
    a2[0] = ld32(xr2);
    a2[1] = ld32(xr2 + 8 * LDS);
    a2[2] = ld32(xr2 + 8);
    a2[3] = ld32(xr2 + 8 * LDS + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* yr = sY + (j * 8 + g) * LDS + kc * 16 + 2 * t4;
      const bf16* yr2 = sY2 + (j * 8 + g) * LDS + kc * 16 + 2 * t4;
      mma_bf16_16816(p[j], a, ld32(yr), ld32(yr + 8));
      mma_bf16_16816(ds[j], a2, ld32(yr2), ld32(yr2 + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >= 2 ? 8 : 0);
      const int c = j * 8 + 2 * t4 + (e & 1);
      const int ql = KV_MAJOR ? c : xl0 + r;
      const int q = KV_MAJOR ? y0 + c : x0 + r;
      const int kk = KV_MAJOR ? x0 + r : y0 + c;
      const bool live = q < T && kk < T && (!causal || kk <= q);
      const float pe = live ? exp2f(p[j][e] * scale_log2 - sLse[ql]) : 0.f;
      p[j][e] = pe;
      ds[j][e] = pe * (ds[j][e] - sDelta[ql]);
    }
  }
}

// C-layout tile (NB columns) -> bf16 A fragments over its columns: the C
// layout of n-tiles 2kk and 2kk+1 is the A layout of k-chunk kk.
template <int NB>
__device__ __forceinline__ void pack_a(const float (&c)[NB / 8][4],
                                       uint32_t (&a)[NB / 16][4]) {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    a[j >> 1][(j & 1) * 2] = pack_bf16(c[j][0], c[j][1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

// ---- bf16, kv-major: dk, dv (and, MERGED, dq through atomics) ---------------
template <int D, bool MERGED>
__global__ void __launch_bounds__(128)
    flash_bwd_kv_bf16_kernel(const Params p) {
  constexpr int BN = 64, BM = 32;  // keys per block, queries per step
  constexpr int LDS = D + 8, DN = D / 8, LDP = BM + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * LDS;
  bf16* sQ = sV + BN * LDS;
  bf16* sDO = sQ + BM * LDS;
  bf16* sDS = sDO + BM * LDS;  // [BN keys][LDP]: dS^T, MERGED only
  float* sLse = reinterpret_cast<float*>(sDS + (MERGED ? BN * LDP : 0));
  float* sDelta = sLse + BM;

  const int T = p.T, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BN;
  const long rs = (long)H * D;
  const long head_off = ((long)b * T * H + h) * D;
  const bf16* qg = static_cast<const bf16*>(p.q) + head_off;
  const bf16* kg = static_cast<const bf16*>(p.k) + head_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + head_off;
  const bf16* dog = static_cast<const bf16*>(p.dout) + head_off;
  const float* lse = p.lse + (long)bh * T;
  const float* delta = p.delta + (long)bh * T;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  load_tile_bf16<BN, D, LDS, 128>(sK, kg, k0, T, rs);
  load_tile_bf16<BN, D, LDS, 128>(sV, vg, k0, T, rs);

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }

  // causal: query tiles before the block's first key see none of its keys
  for (int q0 = p.causal ? k0 : 0; q0 < T; q0 += BM) {
    __syncthreads();  // the previous step is done with sQ, sDO, sDS
    load_tile_bf16<BM, D, LDS, 128>(sQ, qg, q0, T, rs);
    load_tile_bf16<BM, D, LDS, 128>(sDO, dog, q0, T, rs);
    load_row_stats<BM>(sLse, sDelta, lse, delta, q0, T);
    __syncthreads();

    float pt[BM / 8][4], dst[BM / 8][4];  // P^T, dS^T: rows are this warp's keys
    bwd_p_ds_bf16<D, BM, true>(sK + warp * 16 * LDS, sV + warp * 16 * LDS, sQ,
                               sDO, sLse, sDelta, k0 + warp * 16, 0, q0, T,
                               p.causal, p.scale_log2, pt, dst);
    uint32_t pa[BM / 16][4], da[BM / 16][4];  // bf16: the Pallas rounding points
    pack_a<BM>(pt, pa);
    pack_a<BM>(dst, da);

    // dV += P^T dO and dK += dS^T Q; B operands are two query rows of dO / Q
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const bf16* dr = sDO + (kk * 16 + 2 * t4) * LDS + dn * 8 + g;
        const bf16* qr = sQ + (kk * 16 + 2 * t4) * LDS + dn * 8 + g;
        mma_bf16_16816(dv[dn], pa[kk], pack_raw(dr[0], dr[LDS]),
                       pack_raw(dr[8 * LDS], dr[9 * LDS]));
        mma_bf16_16816(dk[dn], da[kk], pack_raw(qr[0], qr[LDS]),
                       pack_raw(qr[8 * LDS], qr[9 * LDS]));
      }
    }

    if (MERGED) {
      // this tile's dQ = dS K over the block's keys, added into dq_accum
      bf16* drow = sDS + (warp * 16 + g) * LDP + 2 * t4;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        *reinterpret_cast<uint32_t*>(drow + j * 8) = da[j >> 1][(j & 1) * 2];
        *reinterpret_cast<uint32_t*>(drow + 8 * LDP + j * 8) =
            da[j >> 1][(j & 1) * 2 + 1];
      }
      __syncthreads();
      const int mt = warp & 1;   // the warp's 16 query rows of the tile
      const int nh = warp >> 1;  // and its half of the head dim
      uint32_t a[BN / 16][4];    // dS [query][key] as A fragments
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const bf16* c0 = sDS + (kc * 16 + 2 * t4) * LDP + mt * 16 + g;
        a[kc][0] = pack_raw(c0[0], c0[LDP]);
        a[kc][1] = pack_raw(c0[8], c0[LDP + 8]);
        a[kc][2] = pack_raw(c0[8 * LDP], c0[9 * LDP]);
        a[kc][3] = pack_raw(c0[8 * LDP + 8], c0[9 * LDP + 8]);
      }
      const int qa = q0 + mt * 16 + g, qb = qa + 8;
      float* dqa = p.dq_accum + head_off + (long)qa * rs;
#pragma unroll
      for (int dn = nh * (DN / 2); dn < (nh + 1) * (DN / 2); ++dn) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc) {
          const bf16* kr = sK + (kc * 16 + 2 * t4) * LDS + dn * 8 + g;
          mma_bf16_16816(acc, a[kc], pack_raw(kr[0], kr[LDS]),
                         pack_raw(kr[8 * LDS], kr[9 * LDS]));
        }
        const int col = dn * 8 + 2 * t4;
        if (qa < T) atomic_add2(dqa + col, acc[0] * p.scale, acc[1] * p.scale);
        if (qb < T)
          atomic_add2(dqa + 8 * rs + col, acc[2] * p.scale, acc[3] * p.scale);
      }
    }
  }

  const int ka = k0 + warp * 16 + g, kb = ka + 8;
  bf16* dkg = static_cast<bf16*>(p.dk) + head_off;
  bf16* dvg = static_cast<bf16*>(p.dv) + head_off;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (ka < T) {
      *reinterpret_cast<uint32_t*>(dkg + (long)ka * rs + col) =
          pack_bf16(dk[dn][0] * p.scale, dk[dn][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + (long)ka * rs + col) =
          pack_bf16(dv[dn][0], dv[dn][1]);
    }
    if (kb < T) {
      *reinterpret_cast<uint32_t*>(dkg + (long)kb * rs + col) =
          pack_bf16(dk[dn][2] * p.scale, dk[dn][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + (long)kb * rs + col) =
          pack_bf16(dv[dn][2], dv[dn][3]);
    }
  }
}

// ---- bf16, q-major: dq ---------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int BM = 64, BN = 32;  // queries per block, keys per step
  constexpr int LDS = D + 8, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + BM * LDS;
  bf16* sK = sDO + BM * LDS;
  bf16* sV = sK + BN * LDS;
  float* sLse = reinterpret_cast<float*>(sV + BN * LDS);
  float* sDelta = sLse + BM;

  const int T = p.T, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest (causal) first
  const long rs = (long)H * D;
  const long head_off = ((long)b * T * H + h) * D;
  const bf16* qg = static_cast<const bf16*>(p.q) + head_off;
  const bf16* kg = static_cast<const bf16*>(p.k) + head_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + head_off;
  const bf16* dog = static_cast<const bf16*>(p.dout) + head_off;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  load_tile_bf16<BM, D, LDS, 128>(sQ, qg, q0, T, rs);
  load_tile_bf16<BM, D, LDS, 128>(sDO, dog, q0, T, rs);
  load_row_stats<BM>(sLse, sDelta, p.lse + (long)bh * T,
                     p.delta + (long)bh * T, q0, T);

  float dq[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  const int kv_end = p.causal ? min(T, q0 + BM) : T;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<BN, D, LDS, 128>(sK, kg, k0, T, rs);
    load_tile_bf16<BN, D, LDS, 128>(sV, vg, k0, T, rs);
    __syncthreads();

    float pp[BN / 8][4], ds[BN / 8][4];
    bwd_p_ds_bf16<D, BN, false>(sQ + warp * 16 * LDS, sDO + warp * 16 * LDS,
                                sK, sV, sLse, sDelta, q0 + warp * 16,
                                warp * 16, k0, T, p.causal, p.scale_log2, pp,
                                ds);
    uint32_t da[BN / 16][4];
    pack_a<BN>(ds, da);
    // dQ += dS K; B operands are two key rows of K
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const bf16* kr = sK + (kk * 16 + 2 * t4) * LDS + dn * 8 + g;
        mma_bf16_16816(dq[dn], da[kk], pack_raw(kr[0], kr[LDS]),
                       pack_raw(kr[8 * LDS], kr[9 * LDS]));
      }
    }
  }

  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  bf16* dqg = static_cast<bf16*>(p.dq) + head_off;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t4;
    if (qa < T)
      *reinterpret_cast<uint32_t*>(dqg + (long)qa * rs + col) =
          pack_bf16(dq[dn][0] * p.scale, dq[dn][1] * p.scale);
    if (qb < T)
      *reinterpret_cast<uint32_t*>(dqg + (long)qb * rs + col) =
          pack_bf16(dq[dn][2] * p.scale, dq[dn][3] * p.scale);
  }
}

// ---- the tile math, f32 (counterpart of _bwd_p_ds) ---------------------------
// One block of 256 threads, a 32 x 32 tile of queries [q0, q0 + 32) and keys
// [k0, k0 + 32): S and dP by scalar FMA from shared memory (pitch D + 1),
// then p and ds into sP / sDS [query][key] (pitch 33). Thread: key
// lane, queries warp + 8i.
constexpr int kTileF = 32;
constexpr int kLdt = kTileF + 1;

template <int D>
__device__ __forceinline__ void bwd_p_ds_f32(
    const float* sQ, const float* sK, const float* sV, const float* sDO,
    const float* sLse, const float* sDelta, int q0, int k0, int T, int causal,
    float scale_log2, float* sP, float* sDS) {
  constexpr int LDF = D + 1;
  const int c = threadIdx.x & 31, r0 = threadIdx.x >> 5;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float kv = sK[c * LDF + d], vv = sV[c * LDF + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = fmaf(sQ[(r0 + 8 * i) * LDF + d], kv, s[i]);
      dp[i] = fmaf(sDO[(r0 + 8 * i) * LDF + d], vv, dp[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 8 * i, q = q0 + r, kk = k0 + c;
    const bool live = q < T && kk < T && (!causal || kk <= q);
    const float pe = live ? exp2f(s[i] * scale_log2 - sLse[r]) : 0.f;
    sP[r * kLdt + c] = pe;
    sDS[r * kLdt + c] = pe * (dp[i] - sDelta[r]);
  }
}

// ---- f32, kv-major: dk, dv (and, MERGED, dq through atomics) ----------------
template <int D, bool MERGED>
__global__ void __launch_bounds__(256) flash_bwd_kv_f32_kernel(const Params p) {
  constexpr int LDF = D + 1, DPT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kTileF * LDF;
  float* sQ = sV + kTileF * LDF;
  float* sDO = sQ + kTileF * LDF;
  float* sP = sDO + kTileF * LDF;
  float* sDS = sP + kTileF * kLdt;
  float* sLse = sDS + kTileF * kLdt;
  float* sDelta = sLse + kTileF;

  const int T = p.T, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTileF;
  const long rs = (long)H * D;
  const long head_off = ((long)b * T * H + h) * D;
  const float* qg = static_cast<const float*>(p.q) + head_off;
  const float* kg = static_cast<const float*>(p.k) + head_off;
  const float* vg = static_cast<const float*>(p.v) + head_off;
  const float* dog = static_cast<const float*>(p.dout) + head_off;
  const float* lse = p.lse + (long)bh * T;
  const float* delta = p.delta + (long)bh * T;

  load_tile_f32<kTileF, D, 256>(sK, kg, k0, T, rs);
  load_tile_f32<kTileF, D, 256>(sV, vg, k0, T, rs);

  const int row = threadIdx.x >> 3, dc = threadIdx.x & 7;  // cols dc + 8i
  float dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk[i] = dv[i] = 0.f;

  for (int q0 = p.causal ? k0 : 0; q0 < T; q0 += kTileF) {
    __syncthreads();
    load_tile_f32<kTileF, D, 256>(sQ, qg, q0, T, rs);
    load_tile_f32<kTileF, D, 256>(sDO, dog, q0, T, rs);
    load_row_stats<kTileF>(sLse, sDelta, lse, delta, q0, T);
    __syncthreads();
    bwd_p_ds_f32<D>(sQ, sK, sV, sDO, sLse, sDelta, q0, k0, T, p.causal,
                    p.scale_log2, sP, sDS);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q for key `row`
    for (int r = 0; r < kTileF; ++r) {
      const float pv = sP[r * kLdt + row], dsv = sDS[r * kLdt + row];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dv[i] = fmaf(pv, sDO[r * LDF + dc + 8 * i], dv[i]);
        dk[i] = fmaf(dsv, sQ[r * LDF + dc + 8 * i], dk[i]);
      }
    }
    if (MERGED) {
      // query `row` of the tile: dQ += dS K over the block's keys
      const int q = q0 + row;
      float acc[DPT];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
      for (int c = 0; c < kTileF; ++c) {
        const float dsv = sDS[row * kLdt + c];
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          acc[i] = fmaf(dsv, sK[c * LDF + dc + 8 * i], acc[i]);
      }
      if (q < T) {
        float* dqr = p.dq_accum + head_off + (long)q * rs;
#pragma unroll
        for (int i = 0; i < DPT; ++i) atomicAdd(dqr + dc + 8 * i, acc[i] * p.scale);
      }
    }
  }

  const int kk = k0 + row;
  if (kk < T) {
    float* dkr = static_cast<float*>(p.dk) + head_off + (long)kk * rs;
    float* dvr = static_cast<float*>(p.dv) + head_off + (long)kk * rs;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dkr[dc + 8 * i] = dk[i] * p.scale;
      dvr[dc + 8 * i] = dv[i];
    }
  }
}

// ---- f32, q-major: dq ------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int LDF = D + 1, DPT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + kTileF * LDF;
  float* sK = sDO + kTileF * LDF;
  float* sV = sK + kTileF * LDF;
  float* sP = sV + kTileF * LDF;
  float* sDS = sP + kTileF * kLdt;
  float* sLse = sDS + kTileF * kLdt;
  float* sDelta = sLse + kTileF;

  const int T = p.T, H = p.H;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileF;
  const long rs = (long)H * D;
  const long head_off = ((long)b * T * H + h) * D;
  const float* qg = static_cast<const float*>(p.q) + head_off;
  const float* kg = static_cast<const float*>(p.k) + head_off;
  const float* vg = static_cast<const float*>(p.v) + head_off;
  const float* dog = static_cast<const float*>(p.dout) + head_off;

  load_tile_f32<kTileF, D, 256>(sQ, qg, q0, T, rs);
  load_tile_f32<kTileF, D, 256>(sDO, dog, q0, T, rs);
  load_row_stats<kTileF>(sLse, sDelta, p.lse + (long)bh * T,
                         p.delta + (long)bh * T, q0, T);

  const int row = threadIdx.x >> 3, dc = threadIdx.x & 7;
  float dq[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dq[i] = 0.f;

  const int kv_end = p.causal ? min(T, q0 + kTileF) : T;
  for (int k0 = 0; k0 < kv_end; k0 += kTileF) {
    __syncthreads();
    load_tile_f32<kTileF, D, 256>(sK, kg, k0, T, rs);
    load_tile_f32<kTileF, D, 256>(sV, vg, k0, T, rs);
    __syncthreads();
    bwd_p_ds_f32<D>(sQ, sK, sV, sDO, sLse, sDelta, q0, k0, T, p.causal,
                    p.scale_log2, sP, sDS);
    __syncthreads();
    for (int c = 0; c < kTileF; ++c) {
      const float dsv = sDS[row * kLdt + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        dq[i] = fmaf(dsv, sK[c * LDF + dc + 8 * i], dq[i]);
    }
  }

  const int q = q0 + row;
  if (q < T) {
    float* dqr = static_cast<float*>(p.dq) + head_off + (long)q * rs;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dqr[dc + 8 * i] = dq[i] * p.scale;
  }
}

// ---- launchers -------------------------------------------------------------------
enum Kind { kDq = 0, kDkv = 1, kDkvdq = 2 };

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, int smem,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(Kind kind, const Params& p, int BH,
                        cudaStream_t stream) {
  constexpr int LDS = D + 8;
  const int bytes = (int)sizeof(bf16);
  if (kind == kDq) {
    const int smem = (2 * 64 + 2 * 32) * LDS * bytes + 2 * 64 * 4;
    return launch(flash_bwd_dq_bf16_kernel<D>, dim3(BH, (p.T + 63) / 64), 128,
                  smem, p, stream);
  }
  const dim3 grid(BH, (p.T + 63) / 64);
  const int base = (2 * 64 + 2 * 32) * LDS * bytes + 2 * 32 * 4;
  if (kind == kDkv)
    return launch(flash_bwd_kv_bf16_kernel<D, false>, grid, 128, base, p,
                  stream);
  return launch(flash_bwd_kv_bf16_kernel<D, true>, grid, 128,
                base + 64 * (32 + 8) * bytes, p, stream);
}

template <int D>
cudaError_t launch_f32(Kind kind, const Params& p, int BH,
                       cudaStream_t stream) {
  const int smem = (4 * kTileF * (D + 1) + 2 * kTileF * kLdt + 2 * kTileF) *
                   (int)sizeof(float);
  const dim3 grid(BH, (p.T + kTileF - 1) / kTileF);
  if (kind == kDq)
    return launch(flash_bwd_dq_f32_kernel<D>, grid, 256, smem, p, stream);
  if (kind == kDkv)
    return launch(flash_bwd_kv_f32_kernel<D, false>, grid, 256, smem, p,
                  stream);
  return launch(flash_bwd_kv_f32_kernel<D, true>, grid, 256, smem, p, stream);
}

int run(Kind kind, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int B, int T, int H, int D, int is_bf16,
        int causal, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (T + kTileF - 1) / kTileF > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = kind == kDq ? dq : nullptr;
  p.dq_accum = kind == kDkvdq ? static_cast<float*>(dq) : nullptr;
  p.dk = dk;
  p.dv = dv;
  p.T = T;
  p.H = H;
  p.causal = causal;
  p.scale = 1.f / sqrtf((float)D);
  p.scale_log2 = kLog2e * p.scale;
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 32) err = launch_bf16<32>(kind, p, BH, st);
    else if (D == 64) err = launch_bf16<64>(kind, p, BH, st);
    else if (D == 128) err = launch_bf16<128>(kind, p, BH, st);
  } else {
    if (D == 32) err = launch_f32<32>(kind, p, BH, st);
    else if (D == 64) err = launch_f32<64>(kind, p, BH, st);
    else if (D == 128) err = launch_f32<128>(kind, p, BH, st);
  }
  return (int)err;
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 (cudaSuccess) or
// the cudaError_t of the refused or failed launch; an unsupported D gives
// cudaErrorInvalidValue. The caller checks shapes, dtypes, devices,
// contiguity and 16-byte alignment before calling, and for the merged
// kernel passes a zeroed f32 dq_accum of q's shape.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int T,
                                 int H, int D, int is_bf16, int causal,
                                 void* stream) {
  return run(kDq, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T, H, D,
             is_bf16, causal, stream);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int T, int H, int D, int is_bf16, int causal,
                                  void* stream) {
  return run(kDkv, q, k, v, dout, lse, delta, nullptr, dk, dv, B, T, H, D,
             is_bf16, causal, stream);
}

extern "C" int flash_attn_bwd_dkvdq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq_accum, void* dk, void* dv, int B,
                                    int T, int H, int D, int is_bf16,
                                    int causal, void* stream) {
  return run(kDkvdq, q, k, v, dout, lse, delta, dq_accum, dk, dv, B, T, H, D,
             is_bf16, causal, stream);
}
