// Per-game row gather out[b] = x[b, idx[b]] for x int32[B, N, W], idx
// int32[B] (Hopper, sm_90a). Replaces the Pallas TPU kernel
// minizero_tpu/ops/gather_rows.py::_gather_kernel (wrapper gather_rows).
// Its contract is minizero_tpu_torch/ops/gather_rows.py::
// gather_rows_reference: a game whose idx lies outside [0, N) is skipped and
// its output row is left as it was (the plain version returns zeros there).
//
// Design. A block copies the rows of kGamesPerBlock (G) consecutive games,
// one warp per game. Lanes 0..G-1 of every warp read the block's G indices
// in one coalesced load, and each warp takes its own with a shuffle: no
// block barrier, and the warps of skipped games and of the ragged last
// block exit at once. Each lane then issues every load of its share of the
// row before its first store, so a row costs one memory round trip, not one
// per pass. Two paths, picked by the launcher:
//
// - aligned: W a multiple of 4 words and both bases 16-byte aligned. Rows
//   move as 16-byte elements, up to kVecPerLane a lane (6 cover the Go 9x9
//   row of 700 words). The large-N engine pads its state rows to a
//   multiple of 4 words (697 -> 700 for Go 9x9) so that its gathers take
//   this path;
// - generic: any W, 4-byte aligned bases. The same block, in 4-byte words,
//   up to kWordsPerLane a lane.
//
// A row longer than one pass (32 lanes x the per-lane count) is copied in
// passes of the same shape. The TPU kernel's 8-row window and (8, 128)
// tiling were Mosaic's DMA alignment rules and are not kept.
//
// What bounds it. Bytes: each kept row is read once and written once
// (2 * B * W * 4 bytes: 5.7 MB at B = 1024 and the 697-word Go 9x9 state,
// ~1.7 us at 3.35 TB/s). There is no arithmetic. At that size a launch and
// the chain idx load -> row load -> store cost about as much as the bytes;
// the design keeps that chain to one dependent step after the index.
//
// G = 2 and the register-staged copy were chosen on the card at the main
// path's shapes against G = 4, 8, 16 and against a copy by Hopper's bulk
// asynchronous copies through shared memory (one lane a game, cp.async.bulk
// global -> shared on an mbarrier, then a bulk store). G = 2, 4 and 8 came
// within ~1% of each other warm and cold, G = 16 ~10% slower warm; the bulk
// copies were slower at every G, warm and cold: a 2,800-byte row is too
// short for the bulk engine to pay for its trip through shared memory
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGamesPerBlock = 2;
constexpr int kVecPerLane = 6;     // int4 elements a lane issues per pass
constexpr int kWordsPerLane = 24;  // int32 words a lane issues per pass

// One warp per game; T is int4 (aligned path) or int32_t (generic), W is
// the row length in elements of T.
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kGamesPerBlock * 32)
gather_rows_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int B, int N, int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kGamesPerBlock;
  int mine = -1;
  if (lane < kGamesPerBlock && b0 + lane < B) mine = idx[b0 + lane];
  const int row = __shfl_sync(0xffffffffu, mine, warp);
  if (row < 0 || row >= N) return;  // skipped game, or past the batch's end
  const int b = b0 + warp;
  const T* src = x + ((size_t)b * N + row) * W;
  T* dst = out + (size_t)b * W;
  for (int base = 0; base < W; base += 32 * kPerLane) {
    T v[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int i = base + k * 32 + lane;
      if (i < W) v[k] = src[i];
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int i = base + k * 32 + lane;
      if (i < W) dst[i] = v[k];
    }
  }
}

}  // namespace

// Launches the aligned path where W % 4 == 0 and x, out are 16-byte
// aligned, else the generic path, and writes which into *aligned (1 or 0).
extern "C" int gather_rows_launch(int B, int N, int W, const void* x, const void* idx,
                                  void* out, void* stream, int* aligned) {
  *aligned = W % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (B == 0 || W == 0) return 0;
  const int blocks = (B + kGamesPerBlock - 1) / kGamesPerBlock;
  const cudaStream_t s = (cudaStream_t)stream;
  if (*aligned) {
    gather_rows_kernel<int4, kVecPerLane><<<blocks, kGamesPerBlock * 32, 0, s>>>(
        (const int4*)x, (const int32_t*)idx, (int4*)out, B, N, W / 4);
  } else {
    gather_rows_kernel<int32_t, kWordsPerLane><<<blocks, kGamesPerBlock * 32, 0, s>>>(
        (const int32_t*)x, (const int32_t*)idx, (int32_t*)out, B, N, W);
  }
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_games_per_block() { return kGamesPerBlock; }

// Registers per thread, static and dynamic shared memory per block of the
// aligned (aligned != 0) or generic path's kernel; a launch asks for no
// dynamic shared memory.
extern "C" int gather_rows_attributes(int aligned, int* regs, int* static_smem,
                                      int* dynamic_smem) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      aligned ? cudaFuncGetAttributes(&attr, gather_rows_kernel<int4, kVecPerLane>)
              : cudaFuncGetAttributes(&attr, gather_rows_kernel<int32_t, kWordsPerLane>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *static_smem = (int)attr.sharedSizeBytes;
  *dynamic_smem = 0;
  return 0;
}
