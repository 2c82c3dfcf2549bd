// The tf32 variant of the fused conv (every f32 conv that is not
// depthwise): conv_tf32_kernel (fused_conv_mma.cuh) at the plan's tile
// width, 16, 32 or 64 columns. A source of its own so that it compiles
// beside fused_conv.cu and fused_conv_mma_sync.cu.
#include "fused_conv_mma.cuh"

extern "C" int fused_conv_tf32_launch(const void* args, void* stream) {
  const FusedConvArgs& a = *static_cast<const FusedConvArgs*>(args);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.is_bf16 || !mma_takes(a)) return (int)cudaErrorInvalidValue;
  switch (a.bn) {
    case 16: return (int)launch_mma_nt<float, 2>(a, st);
    case 32: return (int)launch_mma_nt<float, 4>(a, st);
    case 64: return (int)launch_mma_nt<float, 8>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
