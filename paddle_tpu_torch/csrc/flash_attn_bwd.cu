// Flash-attention backward for Hopper (sm_90a), bf16 and f32.
//
// Replaces the three TPU backward kernels of paddle_tpu/ops/pallas_kernels.py:
//   _flash_dkvdq_kernel (launched by _flash_bwd_merged): one kv-major sweep
//       that gives dk, dv and dq        -> flash_attn_bwd_dkvdq
//   _flash_dq_kernel    (launched by _flash_bwd_pallas): the q-major dq pass
//       of the two-pass backward        -> flash_attn_bwd_dq
//   _flash_dkv_kernel   (launched by _flash_bwd_pallas): the kv-major dk/dv
//       pass of the two-pass backward   -> flash_attn_bwd_dkv
// All three recompute the probabilities from the forward's logsumexp, the
// counterpart of _bwd_p_ds:
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
// D 128, causal) the merged backward does five T x T x D products per head
// (the dq pass three, the dk/dv pass four), about T/2 multiply-adds per
// byte it must move: the tensor-core rate bounds it, not HBM. As in the
// forward, the [T, T] matrices never leave the SM. Reaching that rate
// takes wgmma with operands that TMA keeps arriving while the math runs.
//
// bf16 at D 64 and 128 runs on three wgmma kernels, each one block of
// three warpgroups: warpgroup 0 (setmaxnreg 24) holds a producer warp that
// issues TMA loads (128-byte swizzle) into rings of stages in shared
// memory, a full and an empty mbarrier per stage; warpgroups 1 and 2 are
// consumers (setmaxnreg 240). The kv-major kernels share one recompute
// (issue_st_dpt, kv_p_ds); the q-major pass has its counterpart
// (issue_s_dp, dq_p_ds). Only tiles that cross the diagonal or the ragged
// edge are masked; causal blocks skip what the mask hides (the Pallas
// _qi_clamp and _kb_clamp skips).
//
// flash_bwd_wgmma_kernel<D, MERGED>, kv-major, one block per (b*h,
// 128-key tile): dK and dV (f32) stay in the registers of the two
// consumers, 64 keys each; the producer warp loads K and V once, then
// streams 64-query tiles of Q and dO with their lse and delta. Per query
// tile each consumer computes S^T = K Q^T and dP^T = V dO^T on wgmma (both
// operands from shared memory), so P^T and dS^T come out of the
// accumulators in the register A-fragment layout of dV += P^T dO and
// dK += dS^T Q, which run on wgmma with Q and dO as transposed (MN-major)
// B operands.
//   * MERGED (flash_attn_bwd_dkvdq, the training shape's route): dS^T
//     also goes to shared memory (swizzled as TMA would), and each
//     consumer computes half of the head dim of the tile's dq partial,
//     dQ = dS K over the block's 128 keys, on wgmma with both operands
//     transposed; that product needs both halves of dS, so the consumers
//     meet at every query tile, and the staging leaves a ring of 2 stages.
//     The dq partials are added in a fixed order, so the result is the
//     same bit for bit from run to run (the Pallas kernel writes per-block
//     slabs that XLA sums: also a fixed order). The consumers stage the
//     tile's partial in shared memory in their registers' order (the f32
//     dq buffer keeps that order; the wrapper restores [B, T, H, D]) and
//     go on. Each (b*h, query tile) has an int32 counter in a zeroed
//     scratch buffer; a writer warp of warpgroup 0 waits until it names
//     the block's turn (acquire), adds the whole tile with one bulk f32
//     reduction (cp.reduce.async.bulk; the first turn stores it with a
//     bulk copy), waits for its writes and advances the counter (release).
//     Turns go in descending key-tile order and key tiles are launched
//     from the last (heads in groups of 16), so a block only waits on
//     blocks the hardware dispatched before it, whatever the grid; a block
//     walks its query tiles upward, so on the causal path its predecessor
//     (which started on a later diagonal) has usually passed the tile.
//   * !MERGED (flash_attn_bwd_dkv, the dk/dv pass of the two-pass route):
//     no dS^T staging, dq tile, counter or writer warp. The consumers meet
//     only at their turns on the tensor cores (named barriers, as in the
//     forward): each issues its S^T / dP^T products and its dV / dK
//     products in turn, so one consumer's exp and dS math runs under the
//     other's products; the freed shared memory deepens the Q/dO ring to
//     4 stages. The heaviest key tiles (on the causal path, the first) are
//     launched first. Every dk and dv element is written once.
//
// flash_bwd_dq_wgmma_kernel<D> (flash_attn_bwd_dq, the dq pass), q-major
// and laid out like the forward: one block per (b*h, 128-query tile),
// heads in groups of 16 so that a group's K and V stay in L2, the
// heaviest causal tiles first. The producer loads the block's Q and dO
// once and streams K and V tiles (64 keys at D 128, where the dQ
// accumulator takes 64 registers a thread, 128 at D 64) from the last to
// the first through a three-stage ring; each consumer (64 query rows) holds
// its rows' lse and delta in registers and per key tile computes S =
// Q K^T and dP = dO V^T on wgmma, P and dS in registers (exp2 with the
// scale folded in), dS rounded to bf16 and re-packed as the A fragment of
// dQ += dS K, K the MN-major B operand. Tile i's S and dP are issued with
// tile i-1's dQ product, so one wait covers both, and the consumers take
// the tensor cores in turns. Every dq element is written once.
//
// The two-pass route recomputes S and dP in both passes (seven T x T x D
// products against the merged kernel's five): it is for shapes where the
// merged kernel's f32 dq buffer passes the wrapper's cap (long context),
// and gives the same bits on every call.
//
// The other variants keep the first design: mma.sync.m16n8k16 for bf16
// at D 32 (4 warps; kv-major blocks of 64 keys, 32 queries a step,
// computing S^T so that P^T and dS^T stay in registers; q-major dq blocks
// of 64 queries) and scalar FMA in full f32 for f32 (256 threads, 32 x 32
// tiles). Their merged kernels add dq in the same fixed order, one
// counter per 32-query tile, each block with plain L2 loads and stores
// into a [B, T, H, D] f32 buffer. In every kernel the ragged edge (T not
// a multiple of the tile) is masked: rows past T are zero-filled, scored
// as masked (p = 0) or left out, and never stored.
// The kernels launch on the caller's stream and allocate nothing.

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, T], natural log
  const float* delta;  // [B, H, T]
  void* dq;            // dq kernel: [B, T, H, D], input dtype
  float* dq_accum;     // merged kernels: f32, see flash_attn_bwd_dkvdq
  int* counters;       // merged kernels: [B*H, n_q] int32, zeroed
  void* dk;
  void* dv;
  int T;
  int H;
  int causal;
  int n_q;             // merged kernels: query tiles (of their q tile)
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

// ---- the fixed-order dq add ---------------------------------------------
// The merged kernels' key tile j (of n_kv, BN keys) adds its partial of
// query tile `it` (BM queries, BN a multiple of BM) at turn jmax - j, where
// jmax is the last key tile that reaches the query tile: every key tile
// when not causal, else those up to the diagonal.
__device__ __forceinline__ int dq_turn(int j, int n_kv, int it, int bm,
                                       int bn, int causal) {
  const int jmax = causal ? min(n_kv - 1, (it * bm + bm - 1) / bn) : n_kv - 1;
  return jmax - j;
}

// Two neighbouring dq values added to what earlier turns left (the first
// turn stores). L2 loads and stores: another SM wrote the previous sum.
__device__ __forceinline__ void dq_add2(float* addr, float x, float y,
                                        bool first) {
  float2 val = make_float2(x, y);
  if (!first) {
    const float2 old = __ldcg(reinterpret_cast<const float2*>(addr));
    val.x = old.x + x;
    val.y = old.y + y;
  }
  __stcg(reinterpret_cast<float2*>(addr), val);
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

// ---- bf16, kv-major: dk, dv (and, MERGED, dq in a fixed order) -------------
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
  const int kt = gridDim.y - 1 - blockIdx.y;  // key tiles from the last
  const int k0 = kt * BN;
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
      float acc[DN / 2][4];
#pragma unroll
      for (int dh = 0; dh < DN / 2; ++dh) {
        const int dn = nh * (DN / 2) + dh;
        acc[dh][0] = acc[dh][1] = acc[dh][2] = acc[dh][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < BN / 16; ++kc) {
          const bf16* kr = sK + (kc * 16 + 2 * t4) * LDS + dn * 8 + g;
          mma_bf16_16816(acc[dh], a[kc], pack_raw(kr[0], kr[LDS]),
                         pack_raw(kr[8 * LDS], kr[9 * LDS]));
        }
      }
      // added into dq_accum at this block's turn for the query tile
      const int it = q0 / BM;
      const int turn = dq_turn(kt, gridDim.y, it, BM, BN, p.causal);
      int* ctr = p.counters + (long)bh * p.n_q + it;
      if (threadIdx.x == 0) wait_counter_ge(ctr, turn);
      __syncthreads();
      const int qa = q0 + mt * 16 + g, qb = qa + 8;
      float* dqa = p.dq_accum + head_off + (long)qa * rs;
#pragma unroll
      for (int dh = 0; dh < DN / 2; ++dh) {
        const int col = (nh * (DN / 2) + dh) * 8 + 2 * t4;
        if (qa < T)
          dq_add2(dqa + col, acc[dh][0] * p.scale, acc[dh][1] * p.scale,
                  turn == 0);
        if (qb < T)
          dq_add2(dqa + 8 * rs + col, acc[dh][2] * p.scale,
                  acc[dh][3] * p.scale, turn == 0);
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) release_add(ctr, 1);
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

// ---- f32, kv-major: dk, dv (and, MERGED, dq in a fixed order) --------------
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
  const int kt = gridDim.y - 1 - blockIdx.y;  // key tiles from the last
  const int k0 = kt * kTileF;
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
      const int it = q0 / kTileF;
      const int turn = dq_turn(kt, gridDim.y, it, kTileF, kTileF, p.causal);
      int* ctr = p.counters + (long)bh * p.n_q + it;
      if (threadIdx.x == 0) wait_counter_ge(ctr, turn);
      __syncthreads();
      if (q < T) {
        float* dqr = p.dq_accum + head_off + (long)q * rs;
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          float* a = dqr + dc + 8 * i;
          __stcg(a, turn == 0 ? acc[i] * p.scale
                              : __ldcg(a) + acc[i] * p.scale);
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) release_add(ctr, 1);
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

// ---- bf16, D 64 and 128: wgmma, TMA -----------------------------------------
// The kv-major kernel (the merged kernel, and without dq the dk/dv pass)
constexpr int kWgBN = 128;     // keys per block (64 per consumer warpgroup)
constexpr int kWgBM = 64;      // queries per step
constexpr int kWgThreads = 384;
constexpr int kWgKVSub = kWgBN * 128;  // one 64-column sub-tile of K or V
constexpr int kWgQSub = kWgBM * 128;   // one of a Q or dO tile

struct alignas(64) WgParams {
  CUtensorMap tq, tk, tv, tdo;  // [B, T, H, D] bf16, boxes of 64 columns
  const float* lse;
  const float* delta;
  float* dq_accum;  // the merged kernel
  int* counters;    // the merged kernel
  bf16* dq;         // the dq pass
  bf16* dk;
  bf16* dv;
  int T;
  int H;
  int BH;
  int causal;
  int n_q;
  float scale;
  float scale_log2;
};

// shared memory, in bytes from a 1024-aligned base: K and V (the block's),
// the ring's Q and dO tiles, (merged) two dS^T tiles, the ring's lse and
// delta, (merged) the staged dq partial, and the mbarriers; every bf16
// tile is D/64 sub-tiles of [rows][64]. The merged kernel's staging leaves
// room for a ring of 2 stages; the dk/dv pass takes 4.
template <int D, bool MERGED>
struct WgBwdSmem {
  static constexpr int kStages = MERGED ? 2 : 4;  // Q/dO ring depth
  static constexpr int kKV = kWgBN * D * 2;
  static constexpr int kQ = kWgBM * D * 2;
  static constexpr int kDS = kWgBN * kWgBM * 2;  // [128 keys][64 queries]
  static constexpr int kDQ = kWgBM * D * 4;      // one dq tile, f32
  static constexpr int k = 0;
  static constexpr int v = kKV;
  static constexpr int q = 2 * kKV;
  static constexpr int dout = q + kStages * kQ;
  static constexpr int ds = dout + kStages * kQ;
  static constexpr int dq = ds + (MERGED ? 2 * kDS : 0);
  // [stage][lse, delta][64] f32
  static constexpr int stats = dq + (MERGED ? kDQ : 0);
  static constexpr int bars = stats + kStages * 2 * kWgBM * 4;
  static constexpr int total = bars + 128 + 1024;  // + alignment slack
};

// S^T = K Q^T and dP^T = V dO^T for one consumer: its 64 keys x the
// tile's 64 queries, depth D, both operands K-major in shared memory
template <int D>
__device__ __forceinline__ void issue_st_dpt(float (&sc)[kWgBM / 2],
                                             float (&dp)[kWgBM / 2],
                                             uint32_t sK, uint32_t sV,
                                             uint32_t sQ, uint32_t sDO,
                                             int cw) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ka = (kk >> 2) * kWgKVSub + cw * 64 * 128 + (kk & 3) * 32;
    const uint32_t qb = (kk >> 2) * kWgQSub + (kk & 3) * 32;
    wgmma_ss<kWgBM, 0, 0>(sc, desc_k(sK + ka), desc_k(sQ + qb), kk > 0);
    wgmma_ss<kWgBM, 0, 0>(dp, desc_k(sV + ka), desc_k(sDO + qb), kk > 0);
  }
}

// P^T and dS^T from the S^T and dP^T accumulators (rows are this
// consumer's keys, columns the tile's queries; `st` holds the queries'
// lse_log2 and delta), rounded to bf16 A fragments (the Pallas rounding
// points). Only a tile that crosses the diagonal or the ragged edge is
// masked.
__device__ __forceinline__ void kv_p_ds(float (&sc)[kWgBM / 2],
                                        float (&dp)[kWgBM / 2],
                                        uint32_t (&pa)[kWgBM / 16][4],
                                        uint32_t (&da)[kWgBM / 16][4],
                                        const float* st, int q0, int kw0,
                                        int warp, int g, int t4, int T,
                                        int causal, float scale_log2) {
  const bool masked =
      (causal && q0 <= kw0) || q0 + kWgBM > T || kw0 + 64 > T;
#pragma unroll
  for (int jn = 0; jn < kWgBM / 8; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ql = 8 * jn + 2 * t4 + (e & 1);
      float pe = exp2f(sc[4 * jn + e] * scale_log2 - st[ql]);
      if (masked) {
        const int key = kw0 + 16 * warp + g + (e >= 2 ? 8 : 0);
        const int q = q0 + ql;
        if (q >= T || key >= T || (causal && key > q)) pe = 0.f;
      }
      sc[4 * jn + e] = pe;
      dp[4 * jn + e] = pe * (dp[4 * jn + e] - st[kWgBM + ql]);
    }
  }
#pragma unroll
  for (int jn = 0; jn < kWgBM / 8; ++jn) {
    const int c = (jn & 1) * 2;
    pa[jn >> 1][c] = pack_bf16(sc[4 * jn], sc[4 * jn + 1]);
    pa[jn >> 1][c + 1] = pack_bf16(sc[4 * jn + 2], sc[4 * jn + 3]);
    da[jn >> 1][c] = pack_bf16(dp[4 * jn], dp[4 * jn + 1]);
    da[jn >> 1][c + 1] = pack_bf16(dp[4 * jn + 2], dp[4 * jn + 3]);
  }
}

// dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO and Q the
// MN-major B operands
template <int D>
__device__ __forceinline__ void issue_dv_dk(
    float (&dv)[D / 2], float (&dk)[D / 2],
    const uint32_t (&pa)[kWgBM / 16][4], const uint32_t (&da)[kWgBM / 16][4],
    uint32_t sQ, uint32_t sDO) {
#pragma unroll
  for (int kk = 0; kk < kWgBM / 16; ++kk) {
    wgmma_rs<D, 1>(dv, pa[kk], desc_mn(sDO + kk * 2048, kWgQSub), 1);
    wgmma_rs<D, 1>(dk, da[kk], desc_mn(sQ + kk * 2048, kWgQSub), 1);
  }
}

template <int D, bool MERGED>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  using L = WgBwdSmem<D, MERGED>;
  constexpr int kSub = D / 64;
  constexpr int kStages = L::kStages;
  constexpr int kHalf = D / 2;  // each consumer's share of dq's columns
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = align1024(smem_wg);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;
  uint64_t* dq_full = empty + kStages;
  uint64_t* dq_empty = dq_full + 1;
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  float* dqs = reinterpret_cast<float*>(smem + L::dq);

  // the merged kernel launches key tiles from the last, so a block's
  // predecessors in the dq order were dispatched before it; the dk/dv pass
  // launches the heaviest (on the causal path, the first) first
  const int T = p.T, H = p.H;
  const int n_kv = (T + kWgBN - 1) / kWgBN;
  int bh, rank;
  group_order(blockIdx.x, p.BH, n_kv, bh, rank);
  const int b = bh / H, h = bh % H;
  const int kt = MERGED ? n_kv - 1 - rank : rank;
  const int k0 = kt * kWgBN;
  const int it0 = p.causal ? k0 / kWgBM : 0;  // from the diagonal on
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);       // the producer warp's lanes
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    if (MERGED) {
      mbar_init(dq_full, 2 * 128);
      mbar_init(dq_empty, 1);         // the dq writer
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0 loads K and V once, then Q, dO, lse and delta
    // per step; (merged) warp 1 adds the dq partials into dq_accum
    setmaxnreg_dec<24>();
    if (MERGED && threadIdx.x == 32) {
      // the fixed-order add of each step's staged dq tile: wait for this
      // block's turn, then one bulk copy (the first turn) or bulk f32 add
      // of the whole tile, completed before the counter moves on
      for (int it = it0; it < p.n_q; ++it) {
        const int i = it - it0;
        mbar_wait(dq_full, i & 1);
        const int turn = dq_turn(kt, n_kv, it, kWgBM, kWgBN, p.causal);
        int* ctr = p.counters + (long)bh * p.n_q + it;
        wait_counter_ge(ctr, turn);
        fence_proxy_async_global();
        float* dst = p.dq_accum + ((long)bh * p.n_q + it) * (kWgBM * D);
        if (turn == 0) bulk_store(dst, dqs, L::kDQ);
        else bulk_reduce_add_f32(dst, dqs, L::kDQ);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(dq_empty);  // the staging tile may be rewritten
        bulk_wait();
        fence_proxy_async_global();
        __threadfence();
        release_add(ctr, 1);
      }
    } else if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 2 * L::kKV);
        for (int c = 0; c < kSub; ++c) {
          tma_load_4d(smem + L::k + c * kWgKVSub, &p.tk, bar_kv, c * 64, h,
                      k0, b);
          tma_load_4d(smem + L::v + c * kWgKVSub, &p.tv, bar_kv, c * 64, h,
                      k0, b);
        }
      }
      const float* lse = p.lse + (long)bh * T;
      const float* delta = p.delta + (long)bh * T;
      for (int it = it0; it < p.n_q; ++it) {
        const int i = it - it0, s = i % kStages, q0 = it * kWgBM;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        float* st = stats + s * 2 * kWgBM;
        for (int r = lane; r < kWgBM; r += 32) {
          const int q = q0 + r;
          st[r] = q < T ? lse[q] * kLog2e : 0.f;
          st[kWgBM + r] = q < T ? delta[q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * L::kQ);
          for (int c = 0; c < kSub; ++c) {
            tma_load_4d(smem + L::q + s * L::kQ + c * kWgQSub, &p.tq,
                        &full[s], c * 64, h, q0, b);
            tma_load_4d(smem + L::dout + s * L::kQ + c * kWgQSub, &p.tdo,
                        &full[s], c * 64, h, q0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int kw0 = k0 + 64 * cw;
    const uint32_t sK = smem_u32(smem + L::k), sV = smem_u32(smem + L::v);
    const long rs = (long)H * D;
    const long head_off = ((long)b * T * H + h) * D;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;

    if (!MERGED && cw == 1) turn_pass(cw);  // consumer 0 takes the first turn
    mbar_wait(bar_kv, 0);
    for (int it = it0; it < p.n_q; ++it) {
      const int i = it - it0, s = i % kStages, q0 = it * kWgBM;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t sQ = smem_u32(smem + L::q + s * L::kQ);
      const uint32_t sDO = smem_u32(smem + L::dout + s * L::kQ);

      float sc[kWgBM / 2], dp[kWgBM / 2];
      if (!MERGED) turn_wait(cw);
      wgmma_fence();
      issue_st_dpt<D>(sc, dp, sK, sV, sQ, sDO, cw);
      wgmma_commit();
      if (!MERGED) turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      uint32_t pa[kWgBM / 16][4], da[kWgBM / 16][4];
      kv_p_ds(sc, dp, pa, da, stats + s * 2 * kWgBM, q0, kw0, warp, g, t4, T,
              p.causal, p.scale_log2);

      if constexpr (!MERGED) {
        // the dk/dv pass: the consumers meet only at their turns, so one's
        // exp and dS math runs under the other's products
        turn_wait(cw);
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
        issue_dv_dk<D>(dv, dk, pa, da, sQ, sDO);
        wgmma_commit();
        if (cw == 0 || it + 1 < p.n_q) turn_pass(cw);  // 1 takes the last
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        mbar_arrive(&empty[s]);  // this thread is done with stage s
      } else {
        // dS^T into shared memory for the dq product: [128 keys][64
        // queries], 128-byte rows swizzled as TMA would (chunk ^ row % 8)
        unsigned char* ds_tile = smem + L::ds + (i & 1) * L::kDS;
        const int r0 = 64 * cw + 16 * warp + g;  // and r0 + 8; r0 % 8 == g
#pragma unroll
        for (int jn = 0; jn < kWgBM / 8; ++jn) {
          const int off = ((jn ^ g) << 4) + t4 * 4;
          *reinterpret_cast<uint32_t*>(ds_tile + r0 * 128 + off) =
              da[jn >> 1][(jn & 1) * 2];
          *reinterpret_cast<uint32_t*>(ds_tile + (r0 + 8) * 128 + off) =
              da[jn >> 1][(jn & 1) * 2 + 1];
        }
        fence_proxy_async();

        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
        issue_dv_dk<D>(dv, dk, pa, da, sQ, sDO);
        wgmma_commit();

        // both consumers' dS^T are in place: this consumer's half of the
        // tile's dq partial, dS K over the block's 128 keys (both operands
        // MN-major)
        named_bar_sync(1, 2 * 128);
        float dq[kHalf / 2];
        const uint32_t sDS = smem_u32(ds_tile);
        // this consumer's columns of K
        const uint32_t sKh =
            sK + (cw * kHalf / 64) * kWgKVSub + (cw * kHalf % 64) * 2;
#pragma unroll
        for (int kk = 0; kk < kWgBN / 16; ++kk)
          wgmma_ss<kHalf, 1, 1>(dq, desc_mn(sDS + kk * 2048, L::kDS),
                                desc_mn(sKh + kk * 2048, kWgKVSub), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(dq);
        fence_regs(pa);
        fence_regs(da);
        mbar_arrive(&empty[s]);  // this thread is done with stage s

        // the scaled dq partial to the staging tile, in register order
        // ([consumer][register][thread], so the stores are conflict-free):
        // dq_accum keeps that order (flash_bwd_dkvdq restores [B, T, H, D])
        mbar_wait(dq_empty, (i & 1) ^ 1);
        float* dst = dqs + cw * (kHalf / 2) * 128 + tid;
#pragma unroll
        for (int r = 0; r < kHalf / 2; ++r) dst[r * 128] = dq[r] * p.scale;
        fence_proxy_async();
        mbar_arrive(dq_full);
      }
    }

    const int ka = kw0 + 16 * warp + g, kb = ka + 8;
    bf16* dkg = p.dk + head_off;
    bf16* dvg = p.dv + head_off;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int col = 8 * jn + 2 * t4;
      if (ka < T) {
        *reinterpret_cast<uint32_t*>(dkg + (long)ka * rs + col) =
            pack_bf16(dk[4 * jn] * p.scale, dk[4 * jn + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + (long)ka * rs + col) =
            pack_bf16(dv[4 * jn], dv[4 * jn + 1]);
      }
      if (kb < T) {
        *reinterpret_cast<uint32_t*>(dkg + (long)kb * rs + col) =
            pack_bf16(dk[4 * jn + 2] * p.scale, dk[4 * jn + 3] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + (long)kb * rs + col) =
            pack_bf16(dv[4 * jn + 2], dv[4 * jn + 3]);
      }
    }
  }
}

// ---- bf16, D 64 and 128, the dq pass: q-major, wgmma, a K/V ring ----------
constexpr int kDqBM = 128;    // queries per block (64 per consumer warpgroup)
// K/V ring depth: K of tile i-1 is held until tile i's products are done
// (dQ += dS K is issued with the next tile's S), so a two-stage ring lets
// the producer run only one tile ahead
constexpr int kDqStages = 3;

// keys per K/V tile: 64 at D 128, where the dQ accumulator takes 64
// registers a thread beside S and dP, else 128
template <int D>
constexpr int dq_bn() {
  return D == 128 ? 64 : 128;
}

// shared memory, in bytes from a 1024-aligned base: Q and dO (the
// block's), the ring's K and V tiles, the mbarriers; every tile is D/64
// sub-tiles of [rows][64] bf16
template <int D>
struct WgDqSmem {
  static constexpr int kBN = dq_bn<D>();
  static constexpr int kQ = kDqBM * D * 2;  // Q or dO
  static constexpr int kKV = kBN * D * 2;   // one K or V tile
  static constexpr int kQSub = kDqBM * 128;
  static constexpr int kKVSub = kBN * 128;
  static constexpr int q = 0;
  static constexpr int dout = kQ;
  static constexpr int k = 2 * kQ;
  static constexpr int v = k + kDqStages * kKV;
  static constexpr int bars = v + kDqStages * kKV;
  static constexpr int total = bars + 128 + 1024;  // + alignment slack
};

// S = Q K^T and dP = dO V^T for one consumer: its 64 queries x BN keys,
// depth D, both operands K-major
template <int D>
__device__ __forceinline__ void issue_s_dp(float (&sc)[dq_bn<D>() / 2],
                                           float (&dp)[dq_bn<D>() / 2],
                                           uint32_t sQ, uint32_t sDO,
                                           uint32_t sK, uint32_t sV) {
  using L = WgDqSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qa = (kk >> 2) * L::kQSub + (kk & 3) * 32;
    const uint32_t kb = (kk >> 2) * L::kKVSub + (kk & 3) * 32;
    wgmma_ss<L::kBN, 0, 0>(sc, desc_k(sQ + qa), desc_k(sK + kb), kk > 0);
    wgmma_ss<L::kBN, 0, 0>(dp, desc_k(sDO + qa), desc_k(sV + kb), kk > 0);
  }
}

// dQ += dS K: dS from registers, K [keys][D] the MN-major B operand
template <int D>
__device__ __forceinline__ void issue_dq(
    float (&dq)[D / 2], const uint32_t (&da)[dq_bn<D>() / 16][4],
    uint32_t sK) {
  using L = WgDqSmem<D>;
#pragma unroll
  for (int kk = 0; kk < L::kBN / 16; ++kk)
    wgmma_rs<D, 1>(dq, da[kk], desc_mn(sK + kk * 2048, L::kKVSub), 1);
}

// dS from the S and dP accumulators (rows are this thread's queries
// row_a and row_a + 8, whose lse_log2 and delta it holds), rounded to
// bf16 A fragments for dQ += dS K. `masked`: the tile crosses the diagonal
// or the keys' ragged edge (query rows past T are never stored).
template <int BN>
__device__ __forceinline__ void dq_p_ds(float (&sc)[BN / 2],
                                        float (&dp)[BN / 2],
                                        uint32_t (&da)[BN / 16][4],
                                        bool masked, int k0, int row_a,
                                        const float (&lse2)[2],
                                        const float (&dlt)[2], int t4, int T,
                                        int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float pe = exp2f(sc[4 * j + e] * scale_log2 - lse2[r]);
      if (masked) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        if (key >= T || (causal && key > row_a + 8 * r)) pe = 0.f;
      }
      dp[4 * j + e] = pe * (dp[4 * j + e] - dlt[r]);
    }
    da[j >> 1][(j & 1) * 2] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
    da[j >> 1][(j & 1) * 2 + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ WgParams p) {
  using L = WgDqSmem<D>;
  constexpr int kSub = D / 64, BN = L::kBN;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = align1024(smem_wg);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* k_full = bar_q + 1;
  uint64_t* k_empty = k_full + kDqStages;
  uint64_t* v_full = k_empty + kDqStages;
  uint64_t* v_empty = v_full + kDqStages;

  const int T = p.T, H = p.H;
  const int n_qt = (T + kDqBM - 1) / kDqBM;
  int bh, rank;
  group_order(blockIdx.x, p.BH, n_qt, bh, rank);
  const int b = bh / H, h = bh % H;
  const int q0 = (n_qt - 1 - rank) * kDqBM;  // the heaviest first
  const int kv_end = p.causal ? min(T, q0 + kDqBM) : T;
  const int n_kt = (kv_end + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 2 * 128);  // every consumer thread
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 2 * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO once, then K and V tiles from the last to
    // the first (the one tile that can cross the diagonal first)
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kQ);
      for (int c = 0; c < kSub; ++c) {
        tma_load_4d(smem + L::q + c * L::kQSub, &p.tq, bar_q, c * 64, h, q0,
                    b);
        tma_load_4d(smem + L::dout + c * L::kQSub, &p.tdo, bar_q, c * 64, h,
                    q0, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kDqStages, k0 = (n_kt - 1 - i) * BN;
        const uint32_t ph = ((i / kDqStages) & 1) ^ 1;
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
    // ---- consumers: 64 query rows each. Tile i's S and dP are issued
    // with tile i-1's dQ += dS K, so one wait covers both, and the two
    // consumers take the tensor cores in turns
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + 64 * cw;  // the consumer's first row
    const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
    const uint32_t sQ = smem_u32(smem + L::q) + cw * 64 * 128;
    const uint32_t sDO = smem_u32(smem + L::dout) + cw * 64 * 128;
    const uint32_t sK0 = smem_u32(smem + L::k);
    const uint32_t sV0 = smem_u32(smem + L::v);
    const float* lse = p.lse + (long)bh * T;
    const float* delta = p.delta + (long)bh * T;
    const float lse2[2] = {row_a < T ? lse[row_a] * kLog2e : 0.f,
                           row_b < T ? lse[row_b] * kLog2e : 0.f};
    const float dlt[2] = {row_a < T ? delta[row_a] : 0.f,
                          row_b < T ? delta[row_b] : 0.f};
    // a tile crosses the diagonal (for this consumer's rows) or the ragged
    // edge of the keys
    auto masked = [&](int k0) {
      return (p.causal && k0 + BN - 1 > r0) || k0 + BN > T;
    };

    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
    uint32_t da[BN / 16][4];  // dS of the previous tile, bf16

    if (cw == 1) turn_pass(cw);  // consumer 0 takes the first turn
    mbar_wait(bar_q, 0);
    {  // tile 0 (the last): S and dP alone
      const int k0 = (n_kt - 1) * BN;
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(&k_full[0], 0);
      mbar_wait(&v_full[0], 0);
      turn_wait(cw);
      wgmma_fence();
      issue_s_dp<D>(sc, dp, sQ, sDO, sK0, sV0);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&v_empty[0]);
      dq_p_ds<BN>(sc, dp, da, masked(k0), k0, row_a, lse2, dlt, t4, T,
                  p.causal, p.scale_log2);
    }
    for (int i = 1; i < n_kt; ++i) {
      const int s = i % kDqStages, sp = (i - 1) % kDqStages;
      const uint32_t ph = (i / kDqStages) & 1;
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(&k_full[s], ph);
      mbar_wait(&v_full[s], ph);
      turn_wait(cw);
      fence_regs(dq);
      wgmma_fence();
      issue_dq<D>(dq, da, sK0 + sp * L::kKV);
      issue_s_dp<D>(sc, dp, sQ, sDO, sK0 + s * L::kKV, sV0 + s * L::kKV);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      fence_regs(sc);
      fence_regs(dp);
      mbar_arrive(&k_empty[sp]);
      mbar_arrive(&v_empty[s]);
      const int k0 = (n_kt - 1 - i) * BN;
      dq_p_ds<BN>(sc, dp, da, masked(k0), k0, row_a, lse2, dlt, t4, T,
                  p.causal, p.scale_log2);
    }
    {  // the last tile's dQ += dS K
      const int sp = (n_kt - 1) % kDqStages;
      turn_wait(cw);
      fence_regs(dq);
      wgmma_fence();
      issue_dq<D>(dq, da, sK0 + sp * L::kKV);
      wgmma_commit();
      if (cw == 0) turn_pass(cw);  // consumer 1 takes the last turn
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
      mbar_arrive(&k_empty[sp]);
    }

    const long rs = (long)H * D;
    bf16* dqg = p.dq + ((long)b * T * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row_a < T)
        *reinterpret_cast<uint32_t*>(dqg + (long)row_a * rs + col) =
            pack_bf16(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
      if (row_b < T)
        *reinterpret_cast<uint32_t*>(dqg + (long)row_b * rs + col) =
            pack_bf16(dq[4 * j + 2] * p.scale, dq[4 * j + 3] * p.scale);
    }
  }
}

// ---- launchers -------------------------------------------------------------------
enum Kind { kDq = 0, kDkv = 1, kDkvdq = 2 };

template <typename K, typename P>
cudaError_t launch(K kernel, dim3 grid, int threads, int smem, const P& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the wgmma kernels: bf16 at D 64 and 128. Q and dO are loaded in boxes of
// q_rows rows, K and V in boxes of kv_rows; one block per (b*h, tile) of
// `tile` rows (queries for the dq pass, keys otherwise).
template <int D>
cudaError_t launch_wgmma(Kind kind, const Params& p, int B, int H,
                         cudaStream_t stream) {
  const int q_rows = kind == kDq ? kDqBM : kWgBM;
  const int kv_rows = kind == kDq ? dq_bn<D>() : kWgBN;
  const int tile = kind == kDq ? kDqBM : kWgBN;
  WgParams w;
  cudaError_t err = encode_bthd(&w.tq, p.q, B, p.T, H, D, q_rows);
  if (err == cudaSuccess) err = encode_bthd(&w.tk, p.k, B, p.T, H, D, kv_rows);
  if (err == cudaSuccess) err = encode_bthd(&w.tv, p.v, B, p.T, H, D, kv_rows);
  if (err == cudaSuccess)
    err = encode_bthd(&w.tdo, p.dout, B, p.T, H, D, q_rows);
  if (err != cudaSuccess) return err;
  w.lse = p.lse;
  w.delta = p.delta;
  w.dq_accum = p.dq_accum;
  w.counters = p.counters;
  w.dq = static_cast<bf16*>(p.dq);
  w.dk = static_cast<bf16*>(p.dk);
  w.dv = static_cast<bf16*>(p.dv);
  w.T = p.T;
  w.H = H;
  w.BH = B * H;
  w.causal = p.causal;
  w.n_q = (p.T + kWgBM - 1) / kWgBM;
  w.scale = p.scale;
  w.scale_log2 = p.scale_log2;
  const long blocks = (long)B * H * ((p.T + tile - 1) / tile);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (kind == kDq)
    return launch(flash_bwd_dq_wgmma_kernel<D>, grid, kWgThreads,
                  WgDqSmem<D>::total, w, stream);
  if (kind == kDkv)
    return launch(flash_bwd_wgmma_kernel<D, false>, grid, kWgThreads,
                  WgBwdSmem<D, false>::total, w, stream);
  return launch(flash_bwd_wgmma_kernel<D, true>, grid, kWgThreads,
                WgBwdSmem<D, true>::total, w, stream);
}

// bf16 at D 32: mma.sync
cudaError_t launch_mma_sync(Kind kind, const Params& p, int BH,
                            cudaStream_t stream) {
  constexpr int D = 32, LDS = D + 8;
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

// the merged kernels' query tile, one dq counter per tile: 64 for the
// wgmma kernel (bf16, D 64 and 128), else 32
int merged_q_tile(int is_bf16, int D) {
  return is_bf16 && (D == 64 || D == 128) ? kWgBM : 32;
}

int run(Kind kind, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, void* counters, int B, int T, int H, int D,
        int is_bf16, int causal, int q_tile, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (T + kTileF - 1) / kTileF > 65535)
    return (int)cudaErrorInvalidValue;
  if (kind == kDkvdq && q_tile != merged_q_tile(is_bf16, D))
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
  p.counters = static_cast<int*>(counters);
  p.dk = dk;
  p.dv = dv;
  p.T = T;
  p.H = H;
  p.causal = causal;
  p.n_q = kind == kDkvdq ? (T + q_tile - 1) / q_tile : 0;
  p.scale = 1.f / sqrtf((float)D);
  p.scale_log2 = kLog2e * p.scale;
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 32) err = launch_mma_sync(kind, p, BH, st);
    else if (D == 64) err = launch_wgmma<64>(kind, p, B, H, st);
    else if (D == 128) err = launch_wgmma<128>(kind, p, B, H, st);
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
// contiguity and 16-byte alignment before calling. For the merged kernel
// it passes a zeroed int32 counter buffer of [B * H, n_q], n_q =
// ceil(T / q_tile) with q_tile the kernel's query tile (merged_q_tile;
// another value is refused), and an f32 dq_accum whose every element is
// written: for the wgmma kernel [B * H, n_q, 64 * D] tiles in register
// order (ops/cuda_kernels.py dq_from_tiles), else [B, T, H, D].
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int T,
                                 int H, int D, int is_bf16, int causal,
                                 void* stream) {
  return run(kDq, q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, B,
             T, H, D, is_bf16, causal, 0, stream);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B,
                                  int T, int H, int D, int is_bf16, int causal,
                                  void* stream) {
  return run(kDkv, q, k, v, dout, lse, delta, nullptr, dk, dv, nullptr, B, T,
             H, D, is_bf16, causal, 0, stream);
}

extern "C" int flash_attn_bwd_dkvdq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq_accum, void* dk, void* dv,
                                    void* counters, int B, int T, int H, int D,
                                    int is_bf16, int causal, int q_tile,
                                    void* stream) {
  return run(kDkvdq, q, k, v, dout, lse, delta, dq_accum, dk, dv, counters, B,
             T, H, D, is_bf16, causal, q_tile, stream);
}
