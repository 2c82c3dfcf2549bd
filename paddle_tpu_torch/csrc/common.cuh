// Device helpers shared by the kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, fused_conv.cu, lstm_cell.cu). Each source still
// builds into a library of its own; ops/_build.py passes -I csrc and
// hashes this header with every source.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// d += a * b on the tensor cores: a 16x16 bf16 A fragment, a 16x8 bf16 B
// fragment (two registers), f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on the tensor cores in TF32: a 16x8 A fragment, an 8x8 B
// fragment (two registers), f32 accumulate. A: a0..a3 = (row g, k t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B: b0, b1 = (k t, col g),
// (t + 4, g); d as mma_bf16_16816's (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, each a TF32 value: f32 accuracy from TF32 products as
// a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo, ~2^-22 of the product,
// dropped)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Two f32 values rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 values packed as they are, lo in the low half.
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Copy rows [row0, row0 + ROWS) of a [T, row_stride] bf16 matrix into
// shared memory (row pitch LDS elements), 16 bytes per thread per step;
// rows at or past T are zero-filled.
template <int ROWS, int D, int LDS, int NTHREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int row0, int T,
                                               long row_stride) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks, c = i % kChunks;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < T) {
      val = *reinterpret_cast<const int4*>(src + (long)(row0 + r) * row_stride +
                                           c * 8);
    }
    *reinterpret_cast<int4*>(dst + r * LDS + c * 8) = val;
  }
}

}  // namespace
