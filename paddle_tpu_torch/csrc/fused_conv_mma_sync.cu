// The mma_sync variant of the fused conv (bf16 convs that neither the
// wgmma kernel nor the stem takes): conv_mma_sync_kernel
// (fused_conv_mma.cuh) at the plan's tile width, 8 to 64 columns in steps
// of 8. A source of its own so that it compiles beside fused_conv.cu and
// fused_conv_tf32.cu.
#include "fused_conv_mma.cuh"

extern "C" int fused_conv_mma_sync_launch(const void* args, void* stream) {
  const FusedConvArgs& a = *static_cast<const FusedConvArgs*>(args);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!a.is_bf16 || !mma_takes(a)) return (int)cudaErrorInvalidValue;
  switch (a.bn) {
    case 8: return (int)launch_mma_nt<bf16, 1>(a, st);
    case 16: return (int)launch_mma_nt<bf16, 2>(a, st);
    case 24: return (int)launch_mma_nt<bf16, 3>(a, st);
    case 32: return (int)launch_mma_nt<bf16, 4>(a, st);
    case 40: return (int)launch_mma_nt<bf16, 5>(a, st);
    case 48: return (int)launch_mma_nt<bf16, 6>(a, st);
    case 56: return (int)launch_mma_nt<bf16, 7>(a, st);
    case 64: return (int)launch_mma_nt<bf16, 8>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
