// The fused conv's mma.sync kernels, tf32 (f32) and mma_sync (bf16),
// and their launcher, as templates; fused_conv_tf32.cu and
// fused_conv_mma_sync.cu instantiate one dtype each.
#pragma once

#include "fused_conv.cuh"

namespace {

// ---- f32 (tf32) and other bf16 (mma_sync): implicit GEMM on mma.sync ------
// Every f32 conv that is not depthwise (variant tf32), and every bf16 one
// that neither the wgmma kernel (Cin % 64 == 0) nor the stem takes
// (mma_sync). A block of 128 threads (4 warps) computes a BM x BN output
// tile. BN follows Cout (the plan's bn): 16, 32 or 64 columns in f32, 8
// to 64 in steps of 8 in bf16 (Cout 16, 20 -> 24, 32, 50 -> 56, 64 and
// above -> 64), so a narrow conv wastes no products and no B loads on
// columns past Cout. A warp holds 16 * MT rows by all BN columns, MT 2
// for BN <= 32 and 1 wider, so a block's rows rise as its tile narrows.
// (MT 4 at BN 16, 256 rows a block, left one block of 4 warps an SM: its
// ring took 117 KB; ResNet-32's 16-channel convs ran at 1.0-1.4x cuDNN's
// time on the H100, PERF.md.) The plan's splits (1, 2 or 4) is the number
// of warps that share K: the 4 warps are 4 / splits row groups by splits
// K groups, BM = 64 * MT / splits, and the K groups' partial tiles are
// added in shared memory in a fixed order. A grid short of a wave thus
// takes smaller tiles and no block waits on another: no atomics, no
// counters, the same bits on every call. The stats form keeps whole
// kStatRows-row slots (BM = 64 * MT) and instead shares K among splits
// (1 or 2) sets of 4 warps: a block of 128 * splits threads.
//
// f32 on the tensor cores at f32 accuracy (lstm_cell.cu's recipe): each
// operand is split as hi = tf32(x), lo = tf32(x - hi) as its fragment is
// read, and each m16n8k8 step adds a_lo b_hi + a_hi b_lo into one
// accumulator over a group of kMmaSteps k-steps and a_hi b_hi into a fresh
// one each k-step, which the CUDA cores add up over the group; the
// group's two sums then join the f32 result. The tensor cores truncate
// their f32 adds, so the large term is never summed there past one
// k-step, and the result takes one rounded add a group, not one a
// k-step. a_lo b_lo (~2^-22 of a product) is dropped.
//
// A and B come in one of two ways. Where Cin is a multiple of a 16-byte
// vector (4 f32, 8 bf16) a ring of kMmaStages stages, each kMmaSteps
// k-steps deep (128 bytes of every row of A and B), is filled by 16-byte
// cp.async two stages ahead of the products; each row's input corner comes
// from a table in shared memory. (A ring as deep as shared memory holds
// on grids short of two blocks an SM, its depth known at run time, made
// every ring slower on the H100, PERF.md.) Otherwise (Cin 1 and 3;
// mnist's bf16 Cin 20) the input rows under the tile are staged once in
// shared memory between zero columns for the padding, with 16-byte loads
// where the rows allow (the stem's method), beside the block's rows of w
// (all of K in one copy where it fits: mnist's K 25 and 500), and each
// element of an A fragment is read straight from the staged rows at its
// pixel's offset plus its tap's (a table over k): no im2col tile is built
// and no barrier falls inside K.
//
// The epilogue stages the f32 tile in shared memory (where the K groups'
// partials meet), runs the stage list on 16 bytes of output channels of
// a pixel at a time and stores them once; the stats form first sums each
// column over each kStatRows-row slot (BM is a multiple of it there), one
// writer a slot.
constexpr int kMmaThreads = 128;  // a block (the stats form: x splits)
constexpr int kMmaSteps = 4;   // k-steps a ring stage or staged group
constexpr int kMmaStages = 3;  // the cp.async ring's stages

// m16 tiles a warp at nt 8-column tiles
__host__ __device__ constexpr int mma_mt(int nt) { return nt <= 4 ? 2 : 1; }

template <typename T, int NT>
struct MmaGeo {
  static constexpr int kK = sizeof(T) == 4 ? 8 : 16;  // an mma's k
  static constexpr int MT = mma_mt(NT);
  static constexpr int BN = 8 * NT;
  static constexpr int BNp = 16 * ((NT + 1) / 2);  // B rows: ldmatrix pairs
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements in 16 bytes
  static constexpr int kBK = kMmaSteps * kK;       // a stage's k: 128 bytes
  static constexpr int kLd = kBK + kVec;           // its pitch: 144 bytes
  static constexpr int kLdc = BN + 4;              // the f32 tile's pitch
  static constexpr int kRows = 64 * MT;            // BM at splits 1
};

// A block's output rows: 64 * MT over the splits warps that share K, or
// in the stats form (whole kStatRows-row slots) 64 * MT, its K shared by
// splits sets of 4 warps (a block of 128 * splits threads). Outside the
// products only the first kMmaThreads threads work (the loads, the
// staging, the epilogue), so every loop there keeps a constant step.
template <typename T, int NT>
__host__ __device__ inline int mma_rows(const FusedConvArgs& a) {
  return a.stats ? MmaGeo<T, NT>::kRows : MmaGeo<T, NT>::kRows / a.splits;
}

// The ring path's shared memory: the ring (the f32 tile of each K group
// over it after the products), then the rows' table (an int4 a row).
template <typename T, int NT>
__host__ __device__ inline int ring_region_bytes(int bm, int splits) {
  using G = MmaGeo<T, NT>;
  const int ring = kMmaStages * (bm + G::BNp) * G::kLd * (int)sizeof(T);
  const int tile = splits * bm * G::kLdc * 4;
  return ring > tile ? ring : tile;
}

// The staged path's shared memory: the tap table, the block's rows of w
// (K, or a chunk of it), the input rows; the f32 tile over them after the
// products.
struct StagedLayout {
  int kc;        // K a copy of w's rows: all of it, or a multiple of kBK
  int ldb;       // the pitch of the staged rows of w
  int rows_out;  // output rows BM consecutive pixels can span
  int pl;        // left padding pixels of a staged input row
  int pitch;     // a staged input row's elements
  int vec_rows;  // input rows come in 16-byte loads
  int k_bytes, b_bytes, x_bytes;
  int bytes;     // the block's shared memory, or -1: it does not fit
};

template <typename T, int NT>
__host__ __device__ inline StagedLayout staged_layout(const FusedConvArgs& a,
                                                      int bm, int splits) {
  using G = MmaGeo<T, NT>;
  constexpr int e = (int)sizeof(T);
  StagedLayout L;
  const int K = a.KH * a.KW * a.Cin;
  L.rows_out = (bm - 1 + a.Wo - 1) / a.Wo + 1;
  L.vec_rows = (a.W * a.Cin) % G::kVec == 0;
  int q = G::kVec;  // pixels a 16-byte boundary repeats over
  while (q > 1 && (q / 2) * a.Cin % G::kVec == 0) q /= 2;
  L.pl = L.vec_rows ? (a.pw + q - 1) / q * q : a.pw;
  L.pitch = (2 * L.pl + a.W) * a.Cin;
  L.k_bytes = (K * 4 + 15) / 16 * 16;
  L.x_bytes = (L.rows_out * a.KH * L.pitch * e + 15) / 16 * 16;
  const long fixed = (long)L.k_bytes + L.x_bytes;
  // w's rows for all of K (one contiguous copy), else chunks
  L.kc = L.ldb = K;
  if (fixed + (long)G::BNp * L.ldb * e > kSmemLimit) {
    const long room = (kSmemLimit - fixed) / (G::BNp * e);
    L.kc = room > 0 ? (int)(room / G::kBK * G::kBK) : 0;
    L.ldb = L.kc;
  }
  L.b_bytes = (G::BNp * L.ldb * e + 15) / 16 * 16;
  const long total = fixed + L.b_bytes;
  const int tile = splits * bm * G::kLdc * 4;
  L.bytes = L.kc <= 0 || total > kSmemLimit ? -1
            : total > tile                  ? (int)total
                                            : tile;
  return L;
}

// One k-step's three TF32 products from f32 fragment values: av[mt] is
// A's (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of m-tile mt;
// bv[nt] B's (k t, col g), (t + 4, g) of n-tile nt. a_lo b_hi + a_hi b_lo
// go into `small`, a_hi b_hi into a fresh accumulator added to `big`.
template <int MT, int NT>
__device__ __forceinline__ void tf32_products(const float (&av)[MT][4],
                                              const float (&bv)[NT][2],
                                              float (&big)[MT][NT][4],
                                              float (&small)[MT][NT][4]) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    split_tf32(bv[nt][0], bh[nt][0], bl[nt][0]);
    split_tf32(bv[nt][1], bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(av[mt][e], ah[e], al[e]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_tf32_1688(small[mt][nt], al, bh[nt][0], bh[nt][1]);
      mma_tf32_1688(small[mt][nt], ah, bl[nt][0], bl[nt][1]);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32_1688(d, ah, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) big[mt][nt][e] += d[e];
    }
  }
}

// A group's sums join the f32 result, small terms first.
template <int MT, int NT>
__device__ __forceinline__ void add_group(float (&acc)[MT][NT][4],
                                          float (&big)[MT][NT][4],
                                          float (&small)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] += small[mt][nt][e] + big[mt][nt][e];
        small[mt][nt][e] = big[mt][nt][e] = 0.f;
      }
}

// The ring path: A and B by 16-byte cp.async (Cin % kVec == 0).
template <typename T, int NT>
__device__ __forceinline__ void ring_products(
    const FusedConvArgs& a, unsigned char* smem, int bm, int m0, int n0,
    int M, int K, int row0, int wk, int splits,
    float (&acc)[MmaGeo<T, NT>::MT][NT][4]) {
  using G = MmaGeo<T, NT>;
  constexpr int MT = G::MT, LD = G::kLd;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int stage = (bm + G::BNp) * LD;  // elements
  T* ring = reinterpret_cast<T*>(smem);
  int4* rows = reinterpret_cast<int4*>(smem +
                                       ring_region_bytes<T, NT>(bm, splits));
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // each row's input corner: {element offset of its (0, 0) tap, top row,
  // left column}; rows past M read every tap as padding
  for (int r = tid; tid < kMmaThreads && r < bm; r += kMmaThreads) {
    const int m = m0 + r;
    int4 v = make_int4(0, -(1 << 30), 0, 0);
    if (m < M) {
      const int hw = a.Ho * a.Wo, img = m / hw, rem = m - img * hw;
      const int ho = rem / a.Wo;
      v.y = ho * a.sh - a.ph;
      v.z = (rem - ho * a.Wo) * a.sw - a.pw;
      v.x = ((img * a.H + v.y) * a.W + v.z) * a.Cin;
    }
    rows[r] = v;
  }
  __syncthreads();

  // stage kt: thread tid < kMmaThreads copies 16-byte chunk tid % 8 of
  // rows tid / 8, + 16, ... of A and of B (B's rows past BN and Cout read
  // as 0); the stats form's second set of warps copies nothing
  const int lc = tid & 7, lr = tid >> 3;
  auto load = [&](int kt) {
    if (tid >= kMmaThreads) return;
    T* sA = ring + (kt % kMmaStages) * stage;
    T* sB = sA + bm * LD;
    const int k = kt * G::kBK + lc * G::kVec;
    const bool kin = k < K;
    int kh = 0, kw = 0, ci = 0;
    if (kin) split_k(a, k, kh, kw, ci);
    const long kofs = (long)(kh * a.W + kw) * a.Cin + ci;
    for (int r = lr; r < bm; r += 16) {
      const int4 ri = rows[r];
      const bool in = kin && (unsigned)(ri.y + kh) < (unsigned)a.H &&
                      (unsigned)(ri.z + kw) < (unsigned)a.W;
      cp_async16(sA + r * LD + lc * G::kVec, in ? x + ri.x + kofs : x, in);
    }
#pragma unroll
    for (int r0 = 0; r0 < G::BNp; r0 += 16) {
      const int r = r0 + lr, co = n0 + r;
      const bool in = kin && r < G::BN && co < a.Cout;
      cp_async16(sB + r * LD + lc * G::kVec, in ? w + (long)co * K + k : w,
                 in);
    }
  };

  const int nk = (K + G::kBK - 1) / G::kBK;
#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  float big[MT][NT][4] = {}, small[MT][NT][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // stage kt landed; every warp left stage kt - 1
    if (kt + kMmaStages - 1 < nk) load(kt + kMmaStages - 1);
    cp_async_commit();
    const T* sA = ring + (kt % kMmaStages) * stage;
    const T* sB = sA + bm * LD;
    for (int s = wk; s < kMmaSteps; s += splits) {
      const int kk = s * G::kK;
      if constexpr (sizeof(T) == 4) {
        float av[MT][4], bv[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const T* p = sA + (row0 + mt * 16 + g) * LD + kk + t;
          av[mt][0] = p[0];
          av[mt][1] = p[8 * LD];
          av[mt][2] = p[4];
          av[mt][3] = p[8 * LD + 4];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* p = sB + (nt * 8 + g) * LD + kk + t;
          bv[nt][0] = p[0];
          bv[nt][1] = p[4];
        }
        tf32_products<MT, NT>(av, bv, big, small);
      } else {
        // ldmatrix gives each lane its fragments: A, lanes 0-15 rows 0-15
        // at k 0-7 and lanes 16-31 the same rows at k 8-15; B (stored
        // [n][k]), lanes 0-7 / 8-15 n-tile nt at k 0-7 / 8-15, lanes 16-31
        // n-tile nt + 1 (B's rows reach BNp, so the pair exists)
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], sA + (row0 + mt * 16 + (lane & 15)) * LD + kk +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, sB + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                    LD + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][nt], af[mt], bfr[0], bfr[1]);
            if (nt + 1 < NT)
              mma_bf16_16816(acc[mt][nt + 1], af[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
    if constexpr (sizeof(T) == 4) add_group<MT, NT>(acc, big, small);
  }
  cp_async_wait<0>();
}

// bf16 A or B value pair (k, k + 1) at p (k even): one 4-byte load where
// the pair is contiguous (PAIRED: Cin even), else two, each 0 past K
template <bool PAIRED>
__device__ __forceinline__ uint32_t pair_at(const bf16* base, int o0, int o1,
                                            bool in0, bool in1) {
  if constexpr (PAIRED)
    return in0 ? *reinterpret_cast<const uint32_t*>(base + o0) : 0u;
  return pack_raw(in0 ? base[o0] : bf16(0.f), in1 ? base[o1] : bf16(0.f));
}

// The staged path: the input rows under the tile and the block's rows of w
// in shared memory (Cin % kVec != 0); A read through the tap table.
template <typename T, int NT, bool PAIRED>
__device__ __forceinline__ void staged_products(
    const FusedConvArgs& a, unsigned char* smem, int bm, int m0, int n0,
    int K, int row0, int wk, int splits,
    float (&acc)[MmaGeo<T, NT>::MT][NT][4]) {
  using G = MmaGeo<T, NT>;
  constexpr int MT = G::MT;
  const StagedLayout L = staged_layout<T, NT>(a, bm, splits);
  int* sK = reinterpret_cast<int*>(smem);
  T* sB = reinterpret_cast<T*>(smem + L.k_bytes);
  T* sX = reinterpret_cast<T*>(smem + L.k_bytes + L.b_bytes);
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int C = a.Cin;

  // tap k's element offset in a pixel's staged rows
  for (int k = tid; tid < kMmaThreads && k < K; k += kMmaThreads) {
    int kh, kw, ci;
    split_k(a, k, kh, kw, ci);
    sK[k] = kh * L.pitch + kw * C + ci;
  }
  // the input rows: staged row (r, kh) is input row ho * sh - ph + kh of
  // output row g0 + r's image (zero past the batch and in the padding)
  const int g0 = m0 / a.Wo;
  const int nrows = L.rows_out * a.KH;
  if (L.vec_rows) {
    const int vecs = L.pitch / G::kVec, data = a.W * C / G::kVec;
    const int left = L.pl * C / G::kVec;
#pragma unroll 4
    for (int i = tid; tid < kMmaThreads && i < nrows * vecs;
         i += kMmaThreads) {
      const int rr = i / vecs, v = i - rr * vecs - left;
      const int gg = g0 + rr / a.KH, img = gg / a.Ho;
      const int hi = (gg - img * a.Ho) * a.sh - a.ph + rr % a.KH;
      int4 val = make_int4(0, 0, 0, 0);
      if (img < a.N && (unsigned)hi < (unsigned)a.H &&
          (unsigned)v < (unsigned)data)
        val = *reinterpret_cast<const int4*>(
            x + ((long)img * a.H + hi) * a.W * C + (long)v * G::kVec);
      *reinterpret_cast<int4*>(sX + (long)i * G::kVec) = val;
    }
  } else {
    const int data = a.W * C, left = L.pl * C;
#pragma unroll 4
    for (int i = tid; tid < kMmaThreads && i < nrows * L.pitch;
         i += kMmaThreads) {
      const int rr = i / L.pitch, c = i - rr * L.pitch - left;
      const int gg = g0 + rr / a.KH, img = gg / a.Ho;
      const int hi = (gg - img * a.Ho) * a.sh - a.ph + rr % a.KH;
      sX[i] = img < a.N && (unsigned)hi < (unsigned)a.H &&
                      (unsigned)c < (unsigned)data
                  ? x[((long)img * a.H + hi) * data + c]
                  : T(0.f);
    }
  }
  // this thread's rows (g, g + 8 of each m-tile): their pixels' offsets
  int moff[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row0 + mt * 16 + g + 8 * h;
      const int gg = m / a.Wo, wo = m - gg * a.Wo;
      moff[mt][h] =
          (gg - g0) * a.KH * L.pitch + (wo * a.sw - a.pw + L.pl) * C;
    }

  const int rows_w = min(G::BN, a.Cout - n0);  // w's rows in this tile
  const int nsteps = (K + G::kK - 1) / G::kK;
  float big[MT][NT][4] = {}, small[MT][NT][4] = {};
  for (int kc0 = 0; kc0 < K; kc0 += L.kc) {
    const int kc = min(L.kc, K - kc0);
    if (kc0 > 0) __syncthreads();  // every warp is done with the last chunk
    if (kc == K && L.ldb == K) {
      // the block's rows of w are contiguous: 16-byte copies
      const long total = (long)rows_w * K;
      const long vecs = total / G::kVec;
      const int4* src = reinterpret_cast<const int4*>(w + (long)n0 * K);
      for (long i = tid; tid < kMmaThreads && i < vecs; i += kMmaThreads)
        reinterpret_cast<int4*>(sB)[i] = src[i];
      for (long i = vecs * G::kVec + tid;
           tid < kMmaThreads && i < (long)G::BNp * K; i += kMmaThreads)
        sB[i] = i < total ? w[(long)n0 * K + i] : T(0.f);
    } else {
      for (int i = tid; tid < kMmaThreads && i < G::BNp * kc;
           i += kMmaThreads) {
        const int n = i / kc, kk = i - n * kc;
        sB[n * L.ldb + kk] =
            n < rows_w ? w[(long)(n0 + n) * K + kc0 + kk] : T(0.f);
      }
    }
    __syncthreads();
    // this warp's k-steps of the chunk, in groups of kMmaSteps
    const int s_end = min(nsteps, (kc0 + kc + G::kK - 1) / G::kK);
    for (int s0 = kc0 / G::kK; s0 < s_end; s0 += kMmaSteps) {
      for (int s = s0 + wk; s < s0 + kMmaSteps && s < s_end; s += splits) {
        if constexpr (sizeof(T) == 4) {
          const int ka = s * 8 + t, kb = ka + 4;
          const bool ia = ka < K, ib = kb < K;
          const int oa = ia ? sK[ka] : 0, ob = ib ? sK[kb] : 0;
          float av[MT][4], bv[NT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            av[mt][0] = ia ? sX[moff[mt][0] + oa] : 0.f;
            av[mt][1] = ia ? sX[moff[mt][1] + oa] : 0.f;
            av[mt][2] = ib ? sX[moff[mt][0] + ob] : 0.f;
            av[mt][3] = ib ? sX[moff[mt][1] + ob] : 0.f;
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const T* p = sB + (nt * 8 + g) * L.ldb - kc0;
            bv[nt][0] = ia ? p[ka] : 0.f;
            bv[nt][1] = ib ? p[kb] : 0.f;
          }
          tf32_products<MT, NT>(av, bv, big, small);
        } else {
          // A: (g, k 2t..2t+1), (g + 8, ..), (g, 2t+8..2t+9), (g + 8, ..);
          // B: (k 2t..2t+1, col g), (2t+8..2t+9, g)
          int ks[4];
          bool in[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = s * 16 + 2 * t + (j & 1) + 8 * (j >> 1);
            in[j] = k < K;
            ks[j] = k;
          }
          int ko[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ko[j] = (PAIRED && (j & 1)) || !in[j] ? 0 : sK[ks[j]];
          uint32_t bq[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const bf16* p = sB + (nt * 8 + g) * L.ldb - kc0;
#pragma unroll
            for (int j = 0; j < 2; ++j)
              bq[nt][j] = pair_at<PAIRED>(p, ks[2 * j], ks[2 * j + 1],
                                          in[2 * j], in[2 * j + 1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t af[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const bf16* p = sX + moff[mt][j & 1];
              const int q = 2 * (j >> 1);  // pair q / 2: k 2t or 2t + 8
              af[j] = pair_at<PAIRED>(p, ko[q], ko[q + 1], in[q], in[q + 1]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16_16816(acc[mt][nt], af, bq[nt][0], bq[nt][1]);
          }
        }
      }
      if constexpr (sizeof(T) == 4) add_group<MT, NT>(acc, big, small);
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<int4*>(p) =
      make_int4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The block's tile out: each K group's partial into shared memory
// (element e of mma tile (mt, nt) is row g (+8 for e >= 2), column 2 t
// (+1 for odd e)), the partials added in K group order, the stats form's
// moments, then the stage list on kVec consecutive channels of a pixel and
// one 16-byte store (single values where Cout is not a multiple of it).
template <typename T, int NT>
__device__ __forceinline__ void store_mma_tile(
    const FusedConvArgs& a, float* sC,
    const float (&acc)[MmaGeo<T, NT>::MT][NT][4], int bm, int m0, int n0,
    int M, int row0, int wk, int splits) {
  using G = MmaGeo<T, NT>;
  constexpr int MT = G::MT, LDC = G::kLdc, V = G::kVec;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* mine = sC + wk * bm * LDC;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(
            mine + (row0 + mt * 16 + g + 8 * h) * LDC + nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncthreads();
  if (splits > 1) {
    for (int i = tid; tid < kMmaThreads && i < bm * G::BN; i += kMmaThreads) {
      const int r = i / G::BN, c = i - r * G::BN;
      float v = sC[r * LDC + c];
      for (int s = 1; s < splits; ++s) v += sC[(s * bm + r) * LDC + c];
      sC[r * LDC + c] = v;
    }
    __syncthreads();
  }
  if (a.stats) {
    // per column over each kStatRows-row slot: 4 lanes side by side each
    // sum a quarter of the rows in order, then the quarters are added by
    // two shuffles (a fixed order); the item count is a multiple of 32,
    // so every lane of a warp takes part
    constexpr int kQ = kStatRows / 4;
    for (int i = tid; tid < kMmaThreads && i < (bm / kStatRows) * G::BN * 4;
         i += kMmaThreads) {
      const int q = i & 3, item = i >> 2;
      const int slot = item / G::BN, c = item - slot * G::BN;
      const int r0 = slot * kStatRows;
      const int rows = min(kStatRows, M - m0 - r0);
      float s = 0.f, ss = 0.f;
      for (int r = q * kQ; r < q * kQ + kQ && r < rows; ++r) {
        const float v = sC[(r0 + r) * LDC + c];
        s += v;
        ss += v * v;
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (q == 0 && rows > 0 && n0 + c < a.Cout)
        write_stats(a, M, (m0 + r0) / kStatRows, n0 + c, s, ss);
    }
  }
  T* out = static_cast<T*>(a.out);
  const bool vec_out = a.Cout % V == 0;
  for (int i = tid; tid < kMmaThreads && i < bm * (G::BN / V);
       i += kMmaThreads) {
    const int r = i / (G::BN / V), c0 = (i - r * (G::BN / V)) * V;
    const int m = m0 + r, co0 = n0 + c0;
    if (m >= M || co0 >= a.Cout) continue;
    const float* src = sC + r * LDC + c0;
    T* dst = out + (long)m * a.Cout + co0;
    if (vec_out) {  // co0 + V <= Cout
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = src[j];
      epilogue<V>(a, v, m, co0);
      store16(dst, v);
    } else {
      for (int j = 0; j < V && co0 + j < a.Cout; ++j)
        store(dst + j, epilogue1(a, src[j], m, co0 + j));
    }
  }
}

template <typename T, int NT>
__device__ __forceinline__ void mma_conv(const FusedConvArgs& a,
                                         unsigned char* smem) {
  using G = MmaGeo<T, NT>;
  const int splits = a.splits;
  const int bm = mma_rows<T, NT>(a);
  const int M = a.N * a.Ho * a.Wo;
  const int K = a.KH * a.KW * a.Cin;
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * G::BN;
  const int warp = threadIdx.x >> 5;
  const int wk = warp % splits;                 // this warp's K group
  const int row0 = (warp / splits) * 16 * G::MT;  // its first tile row
  float acc[G::MT][NT][4] = {};
  if (a.Cin % G::kVec == 0) {
    ring_products<T, NT>(a, smem, bm, m0, n0, M, K, row0, wk, splits, acc);
  } else if constexpr (sizeof(T) == 2) {
    if (a.Cin % 2 == 0)
      staged_products<T, NT, true>(a, smem, bm, m0, n0, K, row0, wk, splits,
                                   acc);
    else
      staged_products<T, NT, false>(a, smem, bm, m0, n0, K, row0, wk,
                                    splits, acc);
  } else {
    staged_products<T, NT, false>(a, smem, bm, m0, n0, K, row0, wk, splits,
                                  acc);
  }
  __syncthreads();  // every warp is done with the operands
  store_mma_tile<T, NT>(a, reinterpret_cast<float*>(smem), acc, bm, m0, n0,
                        M, row0, wk, splits);
}

template <int NT>
__global__ void __launch_bounds__(2 * kMmaThreads)
    conv_tf32_kernel(const __grid_constant__ FusedConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  mma_conv<float, NT>(a, smem_mma);
}

template <int NT>
__global__ void __launch_bounds__(2 * kMmaThreads)
    conv_mma_sync_kernel(const __grid_constant__ FusedConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  mma_conv<bf16, NT>(a, smem_mma);
}

// the kernel's shared-memory limit, set once a device (bit dev of *set)
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<uint64_t>* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ((set->load() >> dev) & 1)))
    return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev < 64) set->fetch_or(1ull << dev);
  return err;
}

// what the mma.sync kernels take beyond the dtype: not depthwise, K shared
// by 1, 2 or 4 warps
inline bool mma_takes(const FusedConvArgs& a) {
  return !a.depthwise && (a.splits == 1 || a.splits == 2 || a.splits == 4);
}

// One launch of the instance of tile width 8 * NT.
template <typename T, int NT>
cudaError_t launch_mma_nt(const FusedConvArgs& a, cudaStream_t st) {
  using G = MmaGeo<T, NT>;
  const int bm = mma_rows<T, NT>(a);
  // the stats form: whole kStatRows-row slots, one writer each, in
  // blocks of at most 2 * kMmaThreads threads
  if (a.stats && a.splits > 2) return cudaErrorInvalidValue;
  const int threads = kMmaThreads * (a.stats ? a.splits : 1);
  int smem;
  if (a.Cin % G::kVec == 0) {
    smem = ring_region_bytes<T, NT>(bm, a.splits) + bm * (int)sizeof(int4);
  } else {
    smem = staged_layout<T, NT>(a, bm, a.splits).bytes;
    if (smem < 0) return cudaErrorInvalidValue;
  }
  const long M = (long)a.N * a.Ho * a.Wo;
  const long m_tiles = (M + bm - 1) / bm;
  const long n_tiles = (a.Cout + G::BN - 1) / G::BN;
  if (m_tiles > 0x7fffffffL || n_tiles > 65535) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> smem_set{0};
  void (*kernel)(FusedConvArgs);
  if constexpr (sizeof(T) == 4)
    kernel = conv_tf32_kernel<NT>;
  else
    kernel = conv_mma_sync_kernel<NT>;
  const cudaError_t err = allow_smem(kernel, &smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)m_tiles, (unsigned)n_tiles), threads, smem,
           st>>>(a);
  return cudaGetLastError();
}

}  // namespace
