// Per-game row gather out[b] = x[b, idx[b]] for x int32[B, N, W], idx
// int32[B] (Hopper, sm_90a). Replaces the Pallas TPU kernel
// minizero_tpu/ops/gather_rows.py::_gather_kernel (wrapper gather_rows).
// Its contract is minizero_tpu_torch/ops/gather_rows.py::
// gather_rows_reference: a game whose idx lies outside [0, N) is skipped and
// its output row is left as it was (the plain version returns zeros there).
//
// Design. One block per game; its threads copy the row with coalesced loads
// and stores, 16 bytes a thread (int4) where W is a multiple of 4 words and
// both base pointers are 16-byte aligned, else 4 bytes a thread. The TPU
// kernel's 8-row window and (8, 128) tiling were Mosaic's DMA alignment
// rules; the card reads any row directly, so neither is kept and any B, N
// and W are taken.
//
// What bounds it. Bytes: each kept row is read once and written once
// (2 * B * W * 4 bytes; 5.7 MB at B = 1024 and the Go 9x9 state row of 697
// words, ~1.7 us at 3.35 TB/s). There is no arithmetic. At that size the
// fixed cost of a launch and of one dependent index load per block is
// comparable to the copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int N, int W, int vec4) {
  const int b = blockIdx.x;
  const int row = idx[b];
  if (row < 0 || row >= N) return;  // skipped game: nothing written
  const int32_t* src = x + ((size_t)b * N + row) * W;
  int32_t* dst = out + (size_t)b * W;
  if (vec4) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < W / 4; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < W; i += kThreads) dst[i] = src[i];
  }
}

}  // namespace

extern "C" int gather_rows_launch(int B, int N, int W, const void* x, const void* idx,
                                  void* out, void* stream) {
  if (B == 0 || W == 0) return 0;
  const int vec4 = (W % 4 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  gather_rows_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)idx, (int32_t*)out, N, W, vec4);
  return (int)cudaGetLastError();
}

// Registers per thread, static and dynamic shared memory per block of the
// kernel (a launch asks for no dynamic shared memory).
extern "C" int gather_rows_attributes(int* regs, int* static_smem, int* dynamic_smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, gather_rows_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem = 0;
  return 0;
}
