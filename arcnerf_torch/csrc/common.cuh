// Shared helpers for the arcnerf_torch kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Round an f32 to the nearest bf16 (ties to even) and back: the value a
// bf16 operand or a bf16 intermediate carries, computed in f32.
__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Status returned by every launcher: 0, a cudaError_t, or one of these for
// an argument the kernel does not take (checked before any launch).
#define ARCNERF_BAD_ARGUMENT 100000
