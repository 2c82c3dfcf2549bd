// One fused LSTM step for Hopper (sm_90a), f32 and bf16.
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
// What bounds it on this card. At the sequence path's shape (B 256, H 512,
// f32) the step does 2*B*H*4H = 0.54 GFLOP against 8 MB of operands (w is
// 4 MB of them), about 67 flops a byte: above the f32 balance point of
// the card's non-tensor FMA rate (67 TFLOP/s) over HBM (3.35 TB/s), 20
// flops a byte, so the bound is the FMA rate, about 8 us. In bf16 on the
// tensor cores the same step is far below the bf16 balance point and the
// bytes bound it.
//
// Design (a first, simple version):
//   * each block owns 32 rows of B and a tile of hidden units j, and
//     computes the four gate columns j, H+j, 2H+j, 3H+j of those units,
//     so all four gates of a unit meet in one thread's registers and c
//     and h are written once;
//   * the K loop over H stages a [32 x 32] tile of r_prev and the four
//     column slices of w through shared memory;
//   * f32 (the sequence path's dtype): 256 threads, each 4 rows x 2 units
//     x 4 gates of scalar FMA in full f32 (no TF32: it would round the
//     operands, and the plain version does not). The unit tile is 32, 16
//     or 8, so that small batches still spread over the SMs; the threads
//     that the narrower tiles free split K in groups, whose partial sums
//     meet in shared memory at the end. Tiles are double-buffered, the
//     next one loaded into registers while the current one is multiplied;
//   * bf16 (r_prev and w both bf16): 4 warps, each 16 rows x 16 units x 4
//     gates on mma.sync.m16n8k16 with f32 accumulation; w is staged
//     transposed, k-pairs packed, as the B fragments want it;
//   * xg and c_prev are read as f32 (the wrapper upcasts, losslessly);
//     h and c are written in f32 or bf16, as the caller asks; the gate
//     math is f32;
//   * any B and H: rows and units past the edge are zero-filled on load
//     and not stored; xg may have a row stride (a time step of a [B, T,
//     4H] sequence).
// The kernel launches on the caller's stream and allocates nothing.

#include "common.cuh"

namespace {

constexpr int kBM = 32, kBN = 32, kBK = 32, kThreads = 128;

struct Params {
  const float* xg;
  long long ld_xg;  // row stride of xg, in elements
  const void* r;
  const float* c_prev;
  const void* w;
  void* h;
  void* c;
  int B;
  int H;
  int h_bf16;
  int c_bf16;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// The gates of unit j of row b, from its four accumulated products.
__device__ __forceinline__ void finish(const Params& p, int b, int j,
                                       float gc, float gi, float gf,
                                       float go) {
  const long H = p.H;
  const float* x = p.xg + (long)b * p.ld_xg;
  gc = x[j] + gc;
  gi = x[H + j] + gi;
  gf = x[2 * H + j] + gf;
  go = x[3 * H + j] + go;
  const long o = (long)b * H + j;
  const float c = tanhf(gc) * sigmoid_f(gi) + p.c_prev[o] * sigmoid_f(gf);
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

// f32: a block owns 32 rows and BN units and has 256 threads in KS =
// 64 / BN groups that split each K tile; in a group, thread (tx, ty) owns
// rows b0 + 4*ty + i and units n0 + 2*tx + u (i < 4, u < 2), all four
// gates. Tiles are double-buffered in shared memory and the next tile is
// loaded into registers while the current one is multiplied; at the end
// groups 1.. hand their partial sums to group 0 through shared memory,
// which finishes the gates. BN is 32, 16 or 8: narrower unit tiles give
// more blocks where B is small.
template <int BN>
__global__ void __launch_bounds__(256) lstm_cell_f32_kernel(const Params p) {
  constexpr int BM = kBM, BK = kBK, NT = 256;
  constexpr int TX = BN / 2, GT = TX * (BM / 4), KS = NT / GT;
  constexpr int KPG = BK / KS;                // k steps per group per tile
  constexpr int PR = BM + 4;                  // float4 reads stay aligned
  constexpr int R_PER = BM * BK / NT, W_PER = BK * 4 * BN / NT;
  constexpr int TILE_F = 2 * BK * PR + 2 * BK * 4 * BN;
  constexpr int RED_F = (KS - 1) * GT * 32;
  __shared__ __align__(16) float smem[TILE_F > RED_F ? TILE_F : RED_F];
  float* sR = smem;                           // [2][BK][PR]: r, [k][row]
  float* sW = smem + 2 * BK * PR;             // [2][BK][4][BN]: w
  const int tid = threadIdx.x, grp = tid / GT, t = tid % GT;
  const int tx = t % TX, ty = t / TX;
  const int b0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int B = p.B, H = p.H;
  const long H4 = 4L * H;
  const float* r = static_cast<const float*>(p.r);
  const float* w = static_cast<const float*>(p.w);
  float rreg[R_PER], wreg[W_PER];
  float acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][u][q] = 0.f;

  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < R_PER; ++s) {
      const int idx = tid + NT * s, m = idx / BK, kk = idx % BK;
      const int b = b0 + m, k = k0 + kk;
      rreg[s] = (b < B && k < H) ? r[(long)b * H + k] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < W_PER; ++s) {
      const int idx = tid + NT * s, kk = idx / (4 * BN);
      const int q = (idx % (4 * BN)) / BN, n = idx % BN;
      const int k = k0 + kk, j = n0 + n;
      wreg[s] = (k < H && j < H) ? w[(long)k * H4 + (long)q * H + j] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int s = 0; s < R_PER; ++s) {
      const int idx = tid + NT * s;
      sR[(buf * BK + idx % BK) * PR + idx / BK] = rreg[s];
    }
#pragma unroll
    for (int s = 0; s < W_PER; ++s) {
      sW[buf * BK * 4 * BN + tid + NT * s] = wreg[s];
    }
  };

  const int ntiles = (H + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int cur = tile & 1;
    if (tile + 1 < ntiles) load((tile + 1) * BK);   // in flight meanwhile
    const float* cR = sR + cur * BK * PR;
    const float* cW = sW + cur * BK * 4 * BN;
#pragma unroll
    for (int kq = 0; kq < KPG; ++kq) {
      const int kk = grp * KPG + kq;
      const float4 rv = *reinterpret_cast<const float4*>(cR + kk * PR + 4 * ty);
      const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 wv = *reinterpret_cast<const float2*>(
            cW + (kk * 4 + q) * BN + 2 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0][q] = fmaf(rr[i], wv.x, acc[i][0][q]);
          acc[i][1][q] = fmaf(rr[i], wv.y, acc[i][1][q]);
        }
      }
    }
    if (tile + 1 < ntiles) store(cur ^ 1);
    __syncthreads();
  }
  // groups 1.. hand their partial sums to group 0 (the tiles are done:
  // the last barrier above freed the buffers)
  if (KS > 1) {
    if (grp > 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        smem[((grp - 1) * 32 + e) * GT + t] = (&acc[0][0][0])[e];
      }
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int g = 1; g < KS; ++g) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        (&acc[0][0][0])[e] += smem[((g - 1) * 32 + e) * GT + t];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + 4 * ty + i;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = n0 + 2 * tx + u;
      if (b < B && j < H) {
        finish(p, b, j, acc[i][u][0], acc[i][u][1], acc[i][u][2],
               acc[i][u][3]);
      }
    }
  }
}

// bf16: warp (wm, wn) owns rows b0 + 16*wm .. +16 and units n0 + 16*wn ..
// +16; its eight n-tiles are (gate q, unit octet o), so a thread's
// accumulators of the four gates of one (row, unit) sit side by side.
__global__ void __launch_bounds__(kThreads)
    lstm_cell_bf16_kernel(const Params p) {
  constexpr int kPitchA = kBK + 8;      // bf16 elements: 20 words a row
  constexpr int kPitchB = kBK / 2 + 4;  // k-pair words: 20 a column
  __shared__ __align__(16) bf16 sA[kBM][kPitchA];           // [row][k]
  __shared__ __align__(16) uint32_t sB[4 * kBN][kPitchB];   // [n][k/2]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int B = p.B, H = p.H;
  const long H4 = 4L * H;
  const bf16* r = static_cast<const bf16*>(p.r);
  const bf16* w = static_cast<const bf16*>(p.w);
  const bf16 zero = __float2bfloat16(0.f);
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int m = idx / kBK, kk = idx % kBK;
      const int b = b0 + m, k = k0 + kk;
      sA[m][kk] = (b < B && k < H) ? r[(long)b * H + k] : zero;
    }
    for (int idx = tid; idx < (kBK / 2) * 4 * kBN; idx += kThreads) {
      const int kp = idx / (4 * kBN), n = idx % (4 * kBN);
      const int q = n / kBN, j = n0 + n % kBN, k = k0 + 2 * kp;
      const long col = (long)q * H + j;
      const bf16 lo = (k < H && j < H) ? w[(long)k * H4 + col] : zero;
      const bf16 hi = (k + 1 < H && j < H) ? w[(long)(k + 1) * H4 + col]
                                           : zero;
      sB[n][kp] = pack_raw(lo, hi);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int row = 16 * wm + g, kc = 16 * ks + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&sA[row][kc]);
      a[1] = *reinterpret_cast<const uint32_t*>(&sA[row + 8][kc]);
      a[2] = *reinterpret_cast<const uint32_t*>(&sA[row][kc + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&sA[row + 8][kc + 8]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int n = q * kBN + 16 * wn + 8 * o + g;
          mma_bf16_16816(acc[2 * q + o], a, sB[n][8 * ks + t],
                         sB[n][8 * ks + t + 4]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = 0; o < 2; ++o) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = b0 + 16 * wm + g + 8 * (e >> 1);
      const int j = n0 + 16 * wn + 8 * o + 2 * t + (e & 1);
      if (b < B && j < H) {
        finish(p, b, j, acc[o][e], acc[2 + o][e], acc[4 + o][e],
               acc[6 + o][e]);
      }
    }
  }
}

}  // namespace

// The f32 kernel's unit tile: the widest of 32 and 16 that gives at
// least 64 blocks (about half the card's 132 SMs), else 8. Measured on
// the H100 (32 / 16 / 8, us): B 256 H 512 31.6 / 42.0 / 42.3; B 64 H
// 256 18.7 / 13.7 / 11.4; B 7 H 1000 56.3 / 36.8 / 27.2; B 1 H 512
// 28.6 / 18.6 / 13.9.
static int auto_unit_tile(int B, int H) {
  const long rows = (B + kBM - 1) / kBM;
  for (int bn = 32; bn > 8; bn /= 2) {
    if (rows * ((H + bn - 1) / bn) >= 64) return bn;
  }
  return 8;
}

// xg: [B, 4H] f32 with row stride ld_xg; r_prev [B, H] and w [H, 4H]
// contiguous, both f32 or (dot_bf16) both bf16; c_prev [B, H] f32; h and
// c [B, H], bf16 where h_bf16 / c_bf16, else f32. unit_tile: the f32
// kernel's units a block (32, 16 or 8; 0 chooses). Returns the CUDA error
// of the launch (0 on success).
extern "C" int lstm_cell(const void* xg, long long ld_xg, const void* r,
                         const void* c_prev, const void* w, void* h, void* c,
                         int B, int H, int dot_bf16, int h_bf16, int c_bf16,
                         int unit_tile, void* stream) {
  Params p;
  p.xg = static_cast<const float*>(xg);
  p.ld_xg = ld_xg;
  p.r = r;
  p.c_prev = static_cast<const float*>(c_prev);
  p.w = w;
  p.h = h;
  p.c = c;
  p.B = B;
  p.H = H;
  p.h_bf16 = h_bf16;
  p.c_bf16 = c_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows = (B + kBM - 1) / kBM;
  if (dot_bf16) {
    lstm_cell_bf16_kernel<<<dim3((H + kBN - 1) / kBN, rows), kThreads, 0,
                            s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const int bn = unit_tile ? unit_tile : auto_unit_tile(B, H);
  const dim3 grid((H + bn - 1) / bn, rows);
  switch (bn) {
    case 32:
      lstm_cell_f32_kernel<32><<<grid, 256, 0, s>>>(p);
      break;
    case 16:
      lstm_cell_f32_kernel<16><<<grid, 256, 0, s>>>(p);
      break;
    case 8:
      lstm_cell_f32_kernel<8><<<grid, 256, 0, s>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
