// Device helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu). Each source still builds into a library of its own;
// ops/_build.py passes -I csrc and hashes this header with every source.
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
