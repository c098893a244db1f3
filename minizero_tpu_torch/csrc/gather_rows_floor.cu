// The floor of the row gather B3 (gather_rows.cu): a kernel of B3's grid,
// G games a block and one warp a game, that reads the block's indices as B3
// does and writes nothing. Its time is what B3 costs before it moves a row:
// the launch, the block's scheduling and the index load. The port never
// launches it; chip_smoke.py times it beside B3 at the main path's shapes,
// with G from gather_rows_games_per_block().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_floor_kernel(const int32_t* __restrict__ idx,
                                         int32_t* __restrict__ out, int B, int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * G;
  int mine = -1;
  if (lane < G && b0 + lane < B) mine = idx[b0 + lane];
  const int row = __shfl_sync(0xffffffffu, mine, warp);
  if (row == INT32_MIN) out[0] = row;  // never taken: keeps the load
}

}  // namespace

extern "C" int gather_rows_floor_launch(int B, int G, const void* idx, void* out, void* stream) {
  if (B == 0) return 0;
  gather_rows_floor_kernel<<<(B + G - 1) / G, G * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (int32_t*)out, B, G);
  return (int)cudaGetLastError();
}
